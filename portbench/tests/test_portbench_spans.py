"""The readers of the port's spans (program_span metrics) on synthetic span
records, `idle_spans` on a synthetic trace, and the port's recorder taking
spans from every thread while torch.profiler runs, and none otherwise."""
import threading
from types import SimpleNamespace

import pytest

from portbench.harness import spans as sp
from portbench.harness import trace as tr
from portbench.harness.context import Context
from portbench.harness.spec import Spec

T0 = 100.0  # the stretch opens here and lasts 10 s
_ids = iter(range(1, 10_000))


def _span(name, start, end, parent=None, tid=1, **attrs):
    return SimpleNamespace(name=name, start=T0 + start, end=T0 + end, id=next(_ids),
                           parent=None if parent is None else parent.id, tid=tid,
                           call=None, attrs=attrs)


def _ctx(ops=(("k", 0.0, 10.0),)):
    trace = tr.Trace([tr.DeviceOp(n, T0 + a, T0 + b, None) for n, a, b in ops], T0, T0 + 10.0)
    return Context({}, {}, SimpleNamespace(trace=trace), [], 10.0, 0.0)


def _read(name, spans, monkeypatch, ctx=None):
    monkeypatch.setattr(sp, "recorded", lambda: spans)
    return Spec().reader(name)(ctx or _ctx())


def _chunk(start, bucket, take, steps):
    """A chunk at `start` and its children: (name, seconds) one after another."""
    c = _span("service.chunk", start, start + 1.0, bucket=bucket, take=take)
    out, t = [c], start
    for name, dur in steps:
        out.append(_span(name, t, t + dur, parent=c))
        t += dur
    return out


STEPS = [("service.cond_copy", 0.100), ("sampler.draw", 0.001), ("sampler.draw", 0.001),
         ("sampler.cond_rows", 0.002), ("sampler.launch", 0.004), ("service.decode", 0.003),
         ("service.to_host", 0.001)]


def test_copy_wait_and_issue_are_means_per_chunk_of_the_stretch(monkeypatch):
    spans = (_chunk(1.0, 64, 50, STEPS) + _chunk(3.0, 64, 50, [("service.cond_copy", 0.300),
                                                               ("sampler.launch", 0.010)])
             + _chunk(-2.0, 64, 50, [("service.cond_copy", 9.0)])  # before the stretch
             + _chunk(9.5, 64, 50, [("service.cond_copy", 0.9)])  # open at its stop
             + [_span("service.to_host", 5.0, 5.5)])  # no chunk's: not counted
    assert _read("copy_wait_ms.grid", spans, monkeypatch) == pytest.approx(200.0)
    assert _read("issue_ms.grid", spans, monkeypatch) == pytest.approx((0.012 + 0.010) / 2 * 1e3)
    assert _read("copy_wait_ms.online", [], monkeypatch) is None  # no chunk


def test_queue_wait_counts_requests_taken_in_the_stretch(monkeypatch):
    spans = [_span("batcher.queue", 1.0 + i, 1.0 + i + 0.01 * (i + 1)) for i in range(5)]
    spans.append(_span("batcher.queue", 9.9, 10.5))  # taken after the stretch
    spans.append(_span("batcher.queue", -1.0, 0.2))  # queued before, taken inside
    got = _read("queue_wait_p95_ms.online", spans, monkeypatch)
    want = sorted([10.0, 20.0, 30.0, 40.0, 50.0, 1200.0])
    import numpy as np

    assert got == pytest.approx(float(np.percentile(want, 95)))


def test_slot_wait_share_is_the_stretch_share_waited(monkeypatch):
    window = _span("batcher.window", 2.0, 2.5)
    waits = [_span("batcher.slot_wait", -1.0, 1.0), _span("batcher.slot_wait", 4.0, 4.5),
             _span("batcher.slot_wait", 9.5, 11.0)]
    assert _read("slot_wait_share.online", [window] + waits, monkeypatch) == \
        pytest.approx(100.0 * 2.0 / 10.0)
    assert _read("slot_wait_share.online", [window], monkeypatch) == 0.0
    assert _read("slot_wait_share.online", waits, monkeypatch) is None  # no batcher ran


def test_split_and_padding_shares(monkeypatch):
    spans = [_span("service.sample_async", 1.0, 1.2, chunks=2),
             _span("service.sample_async", 2.0, 2.2, chunks=1),
             _span("service.sample_async", 3.0, 3.2, chunks=1),
             _span("service.sample_async", 4.0, 4.2, chunks=1),
             _span("service.sample_async", 12.0, 12.2, chunks=3),  # after the stretch
             _span("service.chunk", 1.0, 1.1, bucket=256, take=256),
             _span("service.chunk", 1.1, 1.2, bucket=32, take=20),
             _span("service.chunk", 2.0, 2.2, bucket=256, take=190)]
    spans.append(_span("service.sample_async", 9.9, 10.5, chunks=2))  # open at the stop
    assert _read("split_share.online", spans, monkeypatch) == pytest.approx(25.0)
    assert _read("padding_share.online", spans, monkeypatch) == \
        pytest.approx(100.0 * (0 + 12 + 66) / (256 + 32 + 256))


NEW = ["copy_wait_ms.grid", "copy_wait_ms.online", "issue_ms.grid",
       "queue_wait_p95_ms.online", "slot_wait_share.online", "split_share.online",
       "padding_share.online"]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_recorder_or_a_run_without_a_trace_reads_nothing(
        name, monkeypatch):
    assert _read(name, None, monkeypatch) is None
    chunk = _chunk(1.0, 64, 50, STEPS)
    no_trace = Context({}, {}, SimpleNamespace(trace=None), [], 10.0, 0.0)
    assert _read(name, chunk, monkeypatch, no_trace) is None


def test_idle_spans_names_what_the_dispatching_thread_was_doing():
    call = _span("service.sample_async", 1.0, 3.0, tid=1)
    chunk = _span("service.chunk", 1.0, 3.0, parent=call, tid=1)
    copy = _span("service.cond_copy", 1.0, 2.9, parent=chunk, tid=1)
    other = _span("batcher.finish", 0.0, 10.0, tid=2)  # another thread's: not looked up
    # busy 0-1.5, 2-2.5, 4-10: gaps 1.5-2 (in the copy), 2.5-4 (midpoint 3.25: none)
    trace = _ctx([("k", 0.0, 1.5), ("k", 2.0, 2.5), ("k", 4.0, 10.0)]).trace
    got = sp.idle_spans(trace, [call, chunk, copy, other])
    assert [n for n, _ in got] == ["none", "service.cond_copy"]
    assert [v for _, v in got] == pytest.approx([1.5, 0.5])


def test_the_port_records_every_threads_spans_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    from flowerdiff_torch.utils import profiling

    def work(name):
        with profiling.annotate(name, n=1):
            pass

    work("before_the_profiler")
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=work, args=("inside_the_profiler",), name="worker")
        t.start()
        t.join(timeout=30)
    work("after_the_profiler")
    names = [s.name for s in sp.recorded()]
    assert "inside_the_profiler" in names
    assert "before_the_profiler" not in names and "after_the_profiler" not in names
    (s,) = [s for s in sp.recorded() if s.name == "inside_the_profiler"]
    assert s.thread == "worker" and s.attrs == {"n": 1}

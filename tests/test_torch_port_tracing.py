"""The port's spans (flowerdiff_torch/utils/profiling.py) on the CPU.

  - a tiny SamplingService on the kernel path (the kernels' plain twins
    here) records a request past the top bucket as `service.sample_async`
    with one `service.chunk` a chunk, each chunk's steps below it, all with
    the call's id; set-up records `service.build`, `sampler.prepare` and
    `service.warmup`; a plan's bind and a library's load are spans;
  - results are bit-equal with recording on and off, and off, `annotate`
    is one shared object that records nothing and touches neither the card
    nor torch's profiler;
  - the coalescing batcher's spans carry the request ids from `submit` to
    the fan-out, and a full pipeline shows as `batcher.slot_wait`;
  - `trace()` writes the spans of every thread into the chrome trace, on
    the profiler's clock.
"""
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.serving import SamplingService
from flowerdiff_torch.serving_http import CoalescingBatcher
from flowerdiff_torch.utils import profiling
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    vae_from_params,
)

DEN = dict(latent_dim=16, hidden_dims=(16, 32, 16), time_emb_dim=16, num_classes=6)
VAE = dict(latent_dim=16, channels=(8, 16, 24, 32), head_width=32)
CHUNK_STEPS = ["service.cond_copy", "sampler.draw", "sampler.draw", "sampler.cond_rows",
               "sampler.launch", "service.decode", "service.to_host"]


def _service(buckets=(4, 8)):
    rng = np.random.default_rng(3)
    stats = (rng.normal(0, 0.5, 16).astype(np.float32),
             rng.uniform(0.8, 1.5, 16).astype(np.float32))
    return SamplingService(
        denoiser_from_params(init_numpy_params("denoiser", seed=0, **DEN), device="cpu", **DEN),
        vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cpu", **VAE),
        sched=linear_schedule(4), buckets=buckets, latent_stats=stats, clip_x0=3.0,
        guidance_scale=3.0, quantize_uint8=True, use_fused=True, device="cpu")


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_a_request_past_the_top_bucket_records_its_chunks():
    svc = _service()
    classes = np.arange(11) % 6
    assert svc.request_plan(11) == [8, 4]
    with profiling.record() as rec:
        svc.sample(classes, seed=5)
    spans = rec.spans
    assert rec.dropped == 0
    (call,) = _named(spans, "service.sample_async")
    assert call.attrs["images"] == 11 and call.attrs["chunks"] == 2
    assert call.call == call.attrs["call"] and call.parent is None
    chunks = sorted(_named(spans, "service.chunk"), key=lambda s: s.attrs["chunk"])
    assert [(c.attrs["bucket"], c.attrs["take"]) for c in chunks] == [(8, 8), (4, 3)]
    for c in chunks:
        assert c.parent == call.id and c.call == call.call
        assert call.start <= c.start <= c.end <= call.end
        steps = sorted((s for s in spans if s.parent == c.id), key=lambda s: s.start)
        assert [s.name for s in steps] == CHUNK_STEPS
        for s in steps:
            assert s.call == call.call and s.thread == threading.current_thread().name
            assert c.start <= s.start <= s.end <= c.end
        (rows,) = _named(steps, "sampler.cond_rows")
        (launch,) = _named(steps, "sampler.launch")
        assert rows.attrs["rows"] == launch.attrs["rows"] == 2 * c.attrs["bucket"]  # guided
        (out,) = _named(steps, "service.to_host")
        assert out.attrs["bytes"] == c.attrs["bucket"] * 64 * 64 * 3  # uint8 images
    fetches = sorted(_named(spans, "service.fetch"), key=lambda s: s.attrs["chunk"])
    assert [(f.call, f.attrs["chunk"]) for f in fetches] == [(call.call, 0), (call.call, 1)]
    assert all(f.start >= call.end for f in fetches)


def test_set_up_records_build_prepare_warmup_and_binds():
    with profiling.record() as rec:
        svc = _service()
        svc.warmup(buckets=[4, 8])
    (build,) = _named(rec.spans, "service.build")
    (prep,) = _named(rec.spans, "sampler.prepare")
    assert prep.parent == build.id
    (warm,) = _named(rec.spans, "service.warmup")
    assert warm.attrs["buckets"] == (4, 8)
    calls = [s for s in _named(rec.spans, "service.sample_async") if s.parent == warm.id]
    assert sorted(s.attrs["images"] for s in calls) == [4, 8]
    process = svc.sampler._inner.process
    with profiling.record() as rec:
        process.plan_for(8, True)
        process.plan_for(8, True)  # bound: no second span
    (bind,) = rec.spans
    assert bind.name == "sampler.bind"
    assert bind.attrs == {"bucket": 8, "guided": True, "encoded": False}  # no maps on the CPU


def test_a_library_load_is_a_span(monkeypatch, tmp_path):
    from flowerdiff_torch.kernels import _build

    lib = tmp_path / "libfake.so"
    built = []
    monkeypatch.setattr(_build, "_lib_path", lambda name: lib)
    monkeypatch.setattr(_build, "build_all", lambda names: built.append(names) or lib.touch())
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    monkeypatch.setattr(_build, "_LIBS", {})
    with profiling.record() as rec:
        _build.load("fake")
        _build.load("fake")  # loaded: no second span
    (span,) = rec.spans
    assert span.name == "kernels.load" and built == [["fake"]]
    assert span.attrs == {"library": "fake", "built": True}


def test_recording_on_or_off_gives_bit_equal_results_and_off_records_nothing(monkeypatch):
    svc = _service()
    classes = np.arange(11) % 6
    with profiling.record() as rec:
        on = svc.sample(classes, seed=7)
    assert rec.spans

    def refuse(*args, **kwargs):
        raise AssertionError("a span with recording off reached torch")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = len(profiling.recorded().spans)
    assert not profiling.recording()
    assert profiling.annotate("a", x=1) is profiling.annotate("b") is profiling.NOOP
    off = svc.sample(classes, seed=7)
    np.testing.assert_array_equal(on, off)
    assert len(profiling.recorded().spans) == before


def test_the_buffer_counts_spans_past_its_cap_as_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    with profiling.record() as rec:
        for i in range(5):
            with profiling.annotate("s", i=i):
                pass
    assert [s.attrs["i"] for s in rec.spans] == [0, 1, 2] and rec.dropped == 2


class _StubService:
    """sample_async -> fetch of per-row class ids; each fetch sleeps."""
    buckets = (4, 8)

    def __init__(self, fetch_s=0.0):
        self.fetch_s = fetch_s

    def sample_async(self, classes, seed, colors=None, decode=True):
        call = profiling.new_id()
        with profiling.annotate("service.sample_async", call=call, images=len(classes)):
            out = np.asarray(classes, np.float32)

        def fetch():
            with profiling.annotate("service.fetch", call=call, chunk=0):
                time.sleep(self.fetch_s)
            return out

        return fetch


def _submit(batcher, sizes, gap_s=0.0):
    out = {}

    def client(i, n):
        out[i] = batcher.submit(np.full((n,), i % 6))

    threads = []
    for i, n in enumerate(sizes):
        threads.append(threading.Thread(target=client, args=(i, n), name=f"client-{i}"))
        threads[-1].start()
        time.sleep(gap_s)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def test_batcher_spans_carry_the_request_ids():
    batcher = CoalescingBatcher(_StubService(), 1, max_wait_ms=20.0, pipeline_depth=2)
    try:
        with profiling.record() as rec:
            out = _submit(batcher, [1, 2, 3])
    finally:
        batcher.stop()
    assert {i: len(v) for i, v in out.items()} == {0: 1, 1: 2, 2: 3}
    spans = rec.spans
    requests = {s.attrs["request"]: s for s in _named(spans, "batcher.request")}
    assert len(requests) == 3 and all(s.thread.startswith("client-") for s in requests.values())
    for q in _named(spans, "batcher.queue"):
        r = requests[q.attrs["request"]]
        assert q.parent == r.id and q.call == r.call == q.attrs["request"]
        assert r.start <= q.start <= q.end <= r.end
    assert len(_named(spans, "batcher.queue")) == 3
    windows = _named(spans, "batcher.window")
    assert sum(w.attrs["requests"] for w in windows) == 3
    assert sum(w.attrs["images"] for w in windows) == 6
    dispatches = _named(spans, "batcher.dispatch")
    assert sorted(i for d in dispatches for i in d.attrs["requests"]) == sorted(requests)
    finishes = {f.attrs["dispatch"]: f for f in _named(spans, "batcher.finish")}
    assert sorted(finishes) == sorted(d.attrs["dispatch"] for d in dispatches)
    for d in dispatches:
        (call,) = [s for s in _named(spans, "service.sample_async") if s.parent == d.id]
        (fetch,) = [s for s in _named(spans, "service.fetch") if s.call == call.call]
        assert fetch.parent == finishes[d.attrs["dispatch"]].id
        assert d.thread == "flowerdiff-batcher"
        assert finishes[d.attrs["dispatch"]].thread == "flowerdiff-batcher-fetch"
    assert batcher.stats == {"requests": 3, "images": 6, "dispatches": len(dispatches),
                             "max_coalesced": batcher.stats["max_coalesced"], "errors": 0}


def test_a_full_pipeline_shows_as_a_slot_wait():
    batcher = CoalescingBatcher(_StubService(fetch_s=0.3), 1, max_wait_ms=1.0,
                                pipeline_depth=1)
    try:
        with profiling.record() as rec:
            _submit(batcher, [1, 1, 1], gap_s=0.1)
    finally:
        batcher.stop()
    waits = _named(rec.spans, "batcher.slot_wait")
    assert waits and all(w.end > w.start for w in waits)
    windows = {w.id: w for w in _named(rec.spans, "batcher.window")}
    assert any(windows[w.parent].attrs["held"] for w in waits if w.parent in windows)


def test_trace_writes_spans_of_every_thread_on_the_profilers_clock(tmp_path):
    logdir = str(tmp_path / "prof")

    def other():
        with profiling.annotate("other_thread_span", n=3):
            time.sleep(0.01)

    with profiling.trace(logdir):
        with profiling.annotate("main_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        t = threading.Thread(target=other, name="span-thread")
        t.start()
        t.join(timeout=30)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "other_thread_span"]
    assert span["ph"] == "X" and span["args"]["n"] == 3 and span["dur"] >= 1e4 * 0.9
    assert {"ph": "M", "name": "thread_name", "pid": span["pid"], "tid": span["tid"],
            "args": {"name": "span-thread"}} in events
    (main,) = [e for e in events if e.get("name") == "main_span" and e.get("ph") == "X"]
    mm = [e for e in events if e.get("name") in ("aten::matmul", "aten::mm")]
    assert mm
    for e in mm:  # the profiler's own op falls inside the span around it
        assert main["ts"] <= e["ts"] and e["ts"] + e["dur"] <= main["ts"] + main["dur"]

"""The traced stretch is a host interval: idle time at its edges counts, and
operations that run past an edge count only inside it."""
import pytest

from portbench.harness import trace as tr
from portbench.harness.context import Context

MARK = 100.0  # the host clock at the marker


def _events(ops):
    """A chrome trace's events: the marker at 0 us, and each (name, start,
    end) in seconds after it as a device operation with its launch."""
    out = [{"name": tr.CLOCK_SPAN, "ph": "X", "ts": 0.0, "dur": 1.0}]
    for i, (name, a, b) in enumerate(ops):
        out.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X",
                    "ts": (a - 0.01) * 1e6, "dur": 5.0, "args": {"correlation": i}})
        out.append({"name": name, "cat": "kernel", "ph": "X", "ts": a * 1e6,
                    "dur": (b - a) * 1e6, "args": {"correlation": i}})
    return out


def _idle_share(trace):
    ctx = Context({}, {}, type("R", (), {"trace": trace})(), [], 1.0, 0.0)
    from portbench.harness.spec import Spec

    return Spec().reader("idle_share.grid")(ctx)


def test_edges_count_as_idle():
    t = tr.parse(_events([("k", 1.0, 2.0), ("k", 3.0, 4.0)]), MARK, MARK + 0.5, MARK + 5.0)
    assert t.window_s() == pytest.approx(4.5)
    assert t.busy_s() == pytest.approx(2.0)
    gaps = [(round(a - MARK, 6), round(b - MARK, 6)) for a, b in t.idle_gaps()]
    assert gaps == [(0.5, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert _idle_share(t) == pytest.approx(100.0 * 2.5 / 4.5)
    assert t.ops[0].launched == pytest.approx(MARK + 0.99)


def test_operations_past_an_edge_are_cut_to_it():
    t = tr.parse(_events([("k", 0.0, 2.0), ("k", 2.0, 3.0), ("d", 2.5, 6.0)]), MARK,
                 MARK + 1.0, MARK + 5.0)
    assert t.busy_s() == pytest.approx(4.0)
    assert t.busy_s(clip=False) == pytest.approx(6.0)
    assert t.idle_gaps() == []
    assert _idle_share(t) == pytest.approx(0.0)


def test_a_stretch_with_nothing_run_in_it_reads_nothing():
    assert tr.parse(_events([("k", 0.0, 1.0)]), MARK, MARK + 2.0, MARK + 3.0) is None
    assert tr.parse([], MARK, MARK, MARK + 1.0) is None

"""A profiled stretch of the window, read back from torch.profiler's trace.

`Profiled` runs torch.profiler (CPU and CUDA activity, CUPTI on the card)
over a stretch and marks the host clock in it; `read` exports the trace to
a file under TMPDIR, reads it and deletes it. Device operations (kernels,
copies, sets) and the runtime calls that launched them are recorded for
every thread, host spans only for the thread that started the profiler; so
launches are tied to the benchmark's records by the host clock: each
launch's runtime call carries the correlation id of what it launched, and
the marker maps the trace's clock onto `time.perf_counter`.

The stretch is a host interval. An operation launched before the profiler
started is not in its trace, so the stretch opens only once the card has
finished all it was given before then (the profiling thread waits for the
card), and from there every operation that runs is recorded; it closes at
the host time the profiler was asked to stop, after the card has finished
what was launched by then. Idle time at either edge counts.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

CLOCK_SPAN = "portbench.clock"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    start: float  # seconds on the host's perf_counter clock
    end: float
    launched: Optional[float]  # host time of the runtime call that launched it


class Trace(NamedTuple):
    ops: List[DeviceOp]
    start: float  # the stretch on the host's perf_counter clock
    stop: float

    def busy_intervals(self, clip: bool = True):
        """The union of the device operations' intervals, sorted; with
        `clip`, cut to the stretch."""
        out: List[List[float]] = []
        for o in sorted(self.ops, key=lambda o: o.start):
            a, b = (max(o.start, self.start), min(o.end, self.stop)) if clip else (o.start, o.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, clip: bool = True) -> float:
        return sum(b - a for a, b in self.busy_intervals(clip))

    def window_s(self) -> float:
        return self.stop - self.start

    def idle_gaps(self):
        """The stretch's (start, end) intervals with no operation running,
        those at its edges included."""
        edges = [self.start] + [t for ab in self.busy_intervals() for t in ab] + [self.stop]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def parse(events: List[dict], mark_host: float, start: float, stop: float) -> Optional[Trace]:
    """The device operations of a chrome trace's events on the host clock,
    given the perf_counter reading taken at the start of the CLOCK_SPAN
    span, as a stretch from `start` to `stop` (host clock); None when the
    trace holds no device operation in it."""
    mark = next((e for e in events if e.get("name") == CLOCK_SPAN), None)
    if mark is None:
        return None

    def host(ts_us: float) -> float:
        return mark_host + (float(ts_us) - float(mark["ts"])) * 1e-6

    launches: Dict[int, float] = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = host(e["ts"])
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            t = host(e["ts"])
            corr = e.get("args", {}).get("correlation")
            ops.append(DeviceOp(e["name"], t, t + float(e.get("dur", 0.0)) * 1e-6,
                                launches.get(corr)))
    trace = Trace(ops, start, stop)
    if stop <= start or trace.busy_s() <= 0:
        return None
    return trace


class Profiled:
    """torch.profiler over a stretch, started and stopped by one thread."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark = self._start = self._stop = None

    @staticmethod
    def _drain() -> None:
        """Wait, in this thread alone, until the card has finished the work
        launched so far (the GIL is released while it waits)."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import record_function

        self._prof.start()
        with record_function(CLOCK_SPAN):
            self._mark = time.perf_counter()
        self._drain()
        self._start = time.perf_counter()

    def stop(self) -> None:
        self._stop = time.perf_counter()
        self._drain()
        self._prof.stop()

    def read(self) -> Optional[Trace]:
        """The stretch's device operations, or None where it recorded none.
        The trace goes through a file under TMPDIR, deleted at once."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return parse(events, self._mark, self._start, self._stop)

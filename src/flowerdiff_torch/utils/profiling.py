"""Spans, tracing and a NaN/Inf check (port of flowerdiff/utils/profiling.py).

  - `annotate(name, **attrs)`: the port's span, `with annotate('x'): ...`.
    While recording is on it records the span's name, its attributes (host
    ints, strings and tuples of ints, never a device tensor), its id, its
    parent (the span open around it on the same thread), the call or
    request it belongs to (its `call` attribute, else its `request`
    attribute, else its parent's), the thread's name and id, and its start
    and end on `time.perf_counter`. A span taken without `with` runs until
    its `close()`, which any thread may call: it has a parent but is no
    parent. While recording is off `annotate` returns `NOOP`, one shared
    object that records nothing. No span waits for the card, reads a
    device value or allocates on the card.
  - Recording is on while a `record()` block is open, and while
    torch.profiler profiles this process, so a profiled stretch holds the
    spans of every thread whoever started the profiler; `recorded()` hands
    back what the buffer holds. The buffer keeps at most `SPAN_CAP` spans;
    past it spans are counted as dropped.
  - `trace(logdir)`: torch.profiler over the block (CPU and, where there is
    a card, CUDA activity) with recording on, written as a chrome trace
    `trace.json` into `logdir`, the block's spans of every thread added as
    "X" events, mapped onto the profiler's clock by markers (`CLOCK_MARK`);
  - `debug_mode()`: PyTorch's anomaly detection for the block, plus
    `check_finite`, which raises on a NaN or Inf in the tensors it is given
    (the counterpart of jax_debug_nans / jax_debug_infs; each check
    synchronises with the device, so it is for tests and debugging runs).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import statistics
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

CLOCK = time.perf_counter
CLOCK_MARK = "flowerdiff.clock"
CLOCK_MARKS = 8
SPAN_CAP = 1 << 18

_ids = itertools.count(1)
_local = threading.local()


def new_id() -> int:
    """A fresh id, unique in the process among span, call and request ids."""
    return next(_ids)


class _Buffer:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[Span] = []
        self.dropped = 0
        self.depth = 0  # open record() blocks


_BUFFER = _Buffer()


def recording() -> bool:
    """Whether spans are recorded now: inside `record()`, or while
    torch.profiler runs (it sets this private flag of torch's; a torch
    without it leaves recording to `record()`)."""
    return _BUFFER.depth > 0 or getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded span; `start` and `end` are `time.perf_counter` seconds."""
    __slots__ = ("name", "attrs", "id", "parent", "call", "thread", "tid", "start", "end")

    def __init__(self, name: str, attrs: dict):
        stack = _stack()
        up = stack[-1] if stack else None
        self.name, self.attrs, self.id = name, attrs, next(_ids)
        self.parent = up.id if up is not None else None
        self.call = attrs.get("call", attrs.get("request", up.call if up is not None else None))
        thread = threading.current_thread()
        self.thread, self.tid = thread.name, thread.native_id
        self.end = None
        self.start = CLOCK()

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def close(self) -> None:
        """End the span and keep it (a span begun while recording was on
        is kept, whenever it ends)."""
        self.end = CLOCK()
        buf = _BUFFER
        with buf.lock:
            if len(buf.spans) < SPAN_CAP:
                buf.spans.append(self)
            else:
                buf.dropped += 1

    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        self.close()


class _NoSpan:
    """What `annotate` returns while recording is off."""
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP = _NoSpan()


def annotate(name: str, **attrs):
    """A named span from now: over a `with` block (`with annotate('vae_fwd'):
    ...`), or until its `close()`."""
    return Span(name, attrs) if recording() else NOOP


def spanned(name: str):
    """A decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class Recording:
    """What a recording holds: its spans (finished, in the order they
    ended) and how many were dropped past `SPAN_CAP`."""

    def __init__(self, spans: Optional[List[Span]] = None, dropped: int = 0):
        self.spans = spans if spans is not None else []
        self.dropped = dropped


def recorded() -> Recording:
    """What the buffer holds now, recording on or off."""
    buf = _BUFFER
    with buf.lock:
        return Recording(list(buf.spans), buf.dropped)


@contextlib.contextmanager
def record():
    """Recording on for the block (the outermost block empties the buffer
    first); yields a `Recording` filled with the buffer when it ends."""
    buf = _BUFFER
    with buf.lock:
        if buf.depth == 0:
            buf.spans, buf.dropped = [], 0
        buf.depth += 1
    out = Recording()
    try:
        yield out
    finally:
        with buf.lock:
            buf.depth -= 1
            out.spans, out.dropped = list(buf.spans), buf.dropped


def clock_marks(n: int = CLOCK_MARKS) -> List[float]:
    """Under a running torch.profiler, `n` marker events (`CLOCK_MARK`),
    each with the perf_counter midpoint of its block, for
    `clock_offset_us`."""
    from torch.profiler import record_function

    marks = []
    for _ in range(n):
        before = CLOCK()
        with record_function(CLOCK_MARK):
            pass
        marks.append(0.5 * (before + CLOCK()))
    return marks


def clock_offset_us(events: List[dict], marks: List[float]) -> Optional[float]:
    """The profiler's clock minus perf_counter, in us, from the marker
    events of a chrome trace and their `clock_marks` readings: the median
    over the markers but the first (the first record_function of a profile
    pays a lazy set-up inside its event, up to a millisecond), each read at
    its event's middle. None where the trace lacks the markers."""
    found = sorted((e for e in events if e.get("name") == CLOCK_MARK), key=lambda e: e["ts"])
    if len(found) != len(marks) or len(marks) < 2:
        return None
    return statistics.median(float(e["ts"]) + 0.5 * float(e.get("dur", 0.0)) - m * 1e6
                             for e, m in zip(found[1:], marks[1:]))


def chrome_events(spans: List[Span], offset_us: float) -> List[dict]:
    """Spans as chrome trace "X" events on a trace's clock, which reads
    `offset_us` ahead of perf_counter (`clock_offset_us`)."""
    pid = os.getpid()
    out, threads = [], {}
    for s in spans:
        threads[s.tid] = s.thread
        args = dict(s.attrs, span=s.id, parent=s.parent, call=s.call)
        out.append({"ph": "X", "cat": "flowerdiff", "name": s.name, "pid": pid, "tid": s.tid,
                    "ts": s.start * 1e6 + offset_us, "dur": (s.end - s.start) * 1e6,
                    "args": args})
    out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}
            for tid, name in threads.items()]
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with recording on; yields the profiler. The chrome
    trace lands in `logdir/trace.json` when the block ends, with the
    block's spans as "X" events (cat "flowerdiff") where the profiler kept
    the clock markers."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with record() as rec, profile(activities=activities) as prof:
        marks = clock_marks()
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.setdefault("traceEvents", [])
    offset = clock_offset_us(events, marks)
    if offset is not None:
        events += chrome_events([s for s in rec.spans if s.start >= marks[0]], offset)
        with open(path, "w") as fh:
            json.dump(doc, fh)


def check_finite(*tensors: torch.Tensor, nans: bool = True, infs: bool = True,
                 what: str = "tensor") -> None:
    """Raise FloatingPointError if a floating tensor of `tensors` holds a
    NaN (with `nans`) or an Inf (with `infs`)."""
    for i, t in enumerate(tensors):
        if not t.is_floating_point():
            continue
        if nans and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"{what} {i}: NaN in a tensor of shape {tuple(t.shape)}")
        if infs and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"{what} {i}: Inf in a tensor of shape {tuple(t.shape)}")


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Anomaly detection for the block (a backward that makes a NaN
    raises); yields `check_finite` with these `nans` / `infs`, for the
    outputs the caller wants checked."""
    with torch.autograd.detect_anomaly(check_nan=nans):
        yield functools.partial(check_finite, nans=nans, infs=infs)

"""The two loops that offer a traffic mix to the service, and the window.

Times are `time.perf_counter` seconds. The window opens `lead_s` after the
first request and lasts `seconds`. A closed-loop request is timed from its
`sample_async` call to the return of its fetch; an open-loop request from
when it was due to the return of `submit`. Neither loop stops a request
that is under way when the window closes: it is waited for (up to
`DRAIN_S`), and timed as it ends. What a request returns is copied and the
service's array dropped at once, as a caller that consumes its images
would: the service hands out views of its pinned host memory.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np

from portbench.harness import traffic as tr
from portbench.reference.seeds import derived_seed

DRAIN_S = 60.0


class Request:
    __slots__ = ("index", "classes", "colors", "due", "t_send", "t_done", "result", "error")

    def __init__(self, index: int, classes: np.ndarray, due: Optional[float] = None,
                 colors: Optional[np.ndarray] = None):
        self.index, self.classes, self.colors, self.due = index, classes, colors, due
        self.t_send = self.t_done = None
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None

    @property
    def start(self) -> float:
        """When the request counts as sent: due (open loop) or sent."""
        return self.due if self.due is not None else self.t_send


class Run:
    """What one pass of traffic leaves: the requests, the window, the
    profiled stretch, the batcher's counters at the window's edges."""

    def __init__(self):
        self.requests: List[Request] = []
        self.w0 = self.w1 = None
        self.profiled = None  # the profiled stretch, when one was taken
        self.trace = None  # and its trace, once read
        self.stats0 = self.stats1 = None

    def in_window(self) -> List[Request]:
        return [r for r in self.requests if self.w0 <= r.start < self.w1]

    def read_trace(self):
        if self.profiled is not None:
            self.trace = self.profiled.read()
            self.profiled = None
        return self.trace


class _Tracer:
    """The profiled stretch: the window's last `length` seconds, started and
    stopped by a thread of its own at those times; its trace is read after
    the window (`Run.read_trace`), where reading it holds up no request."""

    def __init__(self, run: Run, w1: float, seconds: float, enabled: bool):
        self.run = run
        self.length = min(4.0, 0.3 * seconds)
        self._thread = None
        if enabled:
            self._thread = threading.Thread(target=self._profile, args=(w1,), daemon=True,
                                            name="portbench-tracer")
            self._thread.start()

    def _profile(self, w1: float):
        from portbench.harness.trace import Profiled

        time.sleep(max(0.0, w1 - self.length - time.perf_counter()))
        prof = Profiled()
        prof.start()
        time.sleep(max(0.0, w1 - time.perf_counter()))
        prof.stop()
        self.run.profiled = prof

    def close(self) -> None:
        if self._thread is not None:
            self._thread.join()


def closed_loop(service, traffic: dict, conditions: dict, seed: int, seconds: float,
                trace: bool) -> Run:
    """One client keeping `in_flight` requests of the grid issued: request
    i + 1 is dispatched before request i is fetched. `conditions`: the
    family's (`traffic.grid_request`)."""
    classes, colors = tr.grid_request(traffic, conditions, seed)
    depth = int(traffic["in_flight"])
    run = Run()
    pending: deque = deque()

    def fetch_oldest():
        r, fetch = pending.popleft()
        try:
            r.result = np.array(fetch())  # a copy: the service's array is dropped at once
        except Exception as exc:  # an answer that never comes is counted, not raised
            r.error = f"{type(exc).__name__}: {exc}"
        r.t_done = time.perf_counter()

    t0 = time.perf_counter()
    run.w0 = t0 + float(traffic["lead_s"])
    run.w1 = run.w0 + seconds
    tracer = _Tracer(run, run.w1, seconds, trace)
    k = 0
    while True:
        if time.perf_counter() >= run.w1:
            break
        r = Request(k, classes, colors=colors)
        run.requests.append(r)
        r.t_send = time.perf_counter()
        try:
            pending.append((r, service.sample_async(classes, derived_seed(seed, 1, k), colors)))
        except Exception as exc:
            r.error, r.t_done = f"{type(exc).__name__}: {exc}", time.perf_counter()
        k += 1
        if len(pending) >= depth:
            fetch_oldest()
    tracer.close()
    while pending:
        fetch_oldest()
    return run


def open_loop(batcher, traffic: dict, conditions: dict, seed: int, seconds: float,
              trace: bool) -> Run:
    """Arrivals on the mix's schedule, each with the conditions the family
    declares, handed at its due time to a free client thread that blocks in
    `batcher.submit`."""
    lead = float(traffic["lead_s"])
    plan = tr.open_schedule(traffic, conditions, lead + seconds, seed)
    run = Run()
    todo: queue.SimpleQueue = queue.SimpleQueue()
    done = threading.Semaphore(0)

    def client():
        while True:
            r = todo.get()
            if r is None:
                return
            r.t_send = time.perf_counter()
            try:
                r.result = np.array(batcher.submit(r.classes, r.colors))  # a copy, original dropped
            except Exception as exc:  # counted as failed
                r.error = f"{type(exc).__name__}: {exc}"
            r.t_done = time.perf_counter()
            done.release()

    threads = [threading.Thread(target=client, daemon=True, name=f"portbench-client-{i}")
               for i in range(tr.client_threads(traffic))]
    for t in threads:
        t.start()
    try:
        t0 = time.perf_counter()
        run.w0, run.w1 = t0 + lead, t0 + lead + seconds
        tracer = _Tracer(run, run.w1, seconds, trace)
        for i, p in enumerate(plan):
            due = t0 + p.due
            while True:
                now = time.perf_counter()
                if run.stats0 is None and now >= run.w0:
                    run.stats0 = dict(batcher.stats)
                if now >= due:
                    break
                wake = due if run.stats0 is not None else min(due, run.w0)
                time.sleep(max(0.0, min(wake - now, 0.05)))
            r = Request(i, p.classes, due, p.colors)
            run.requests.append(r)
            todo.put(r)
        while True:
            now = time.perf_counter()
            if run.stats0 is None and now >= run.w0:
                run.stats0 = dict(batcher.stats)
            if now >= run.w1:
                break
            time.sleep(min(0.01, run.w1 - now))
        run.stats1 = dict(batcher.stats)
        tracer.close()
        deadline = time.perf_counter() + DRAIN_S
        for _ in run.requests:
            if not done.acquire(timeout=max(0.0, deadline - time.perf_counter())):
                break
    finally:
        for _ in threads:
            todo.put(None)
        for t in threads:
            t.join(timeout=DRAIN_S)
    return run

"""The port's own spans in the traced stretch (program_span metrics).

The port (flowerdiff_torch/utils/profiling.py) records its spans, from
every thread, while torch.profiler profiles the process: a `--trace 1`
run's stretch holds them, whoever started the profiler, and a `--trace 0`
run records none. Each span has a name, attributes, an id, its parent's id,
its call or request id, its thread, and a start and end on the host's
`time.perf_counter`, the clock `harness/trace.py` maps the device trace
onto. On a program without the recorder every reader finds nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

TOP = 10


def recorded() -> Optional[list]:
    """The spans the port has recorded, or None where it has no recorder."""
    try:
        from flowerdiff_torch.utils import profiling
    except ImportError:
        return None
    take = getattr(profiling, "recorded", None)
    return None if take is None else take().spans


def in_stretch(ctx, names: Iterable[str], ended: bool = False) -> Optional[list]:
    """The spans of these names that ran wholly inside the traced stretch
    (with `ended`, those that ended inside it); None without a stretch or a
    recorder. A span open across the stretch's stop holds the profiler's
    own stop, hundreds of ms, and is left out."""
    trace, spans = ctx.trace, recorded()
    if trace is None or spans is None:
        return None
    names = set(names)
    return [s for s in spans if s.name in names and s.end is not None
            and trace.start <= (s.end if ended else s.start) and s.end <= trace.stop]


def per_chunk_ms(spans: list, steps: Iterable[str]) -> Optional[float]:
    """The mean host ms a `service.chunk` of `spans` spent in its direct
    children named `steps`; None without a chunk."""
    chunks = {s.id for s in spans if s.name == "service.chunk"}
    if not chunks:
        return None
    steps = set(steps)
    total = sum(s.end - s.start for s in spans if s.name in steps and s.parent in chunks)
    return 1e3 * total / len(chunks)


def overlap_s(spans: list, start: float, stop: float) -> float:
    """Seconds of [start, stop] the spans cover, each counted whole (spans
    of one name on one thread do not overlap)."""
    return sum(max(0.0, min(s.end, stop) - max(s.start, start)) for s in spans)


def innermost(spans: list, t: float):
    """The span open at host time t that started last (of two that started
    together, the one that ends first), or None."""
    open_ = [s for s in spans if s.start <= t <= s.end]
    return max(open_, key=lambda s: (s.start, -s.end)) if open_ else None


def idle_spans(trace, spans: list, top: int = TOP) -> List[list]:
    """Each idle gap of the stretch under the innermost span open at its
    midpoint on the threads that recorded `service.sample_async` (`none`
    where no span is open there): [name, idle seconds], the `top` largest."""
    threads = {s.tid for s in spans if s.name == "service.sample_async"}
    mine = [s for s in spans if s.tid in threads and s.end is not None]
    sums: Dict[str, float] = {}
    for a, b in trace.idle_gaps():
        s = innermost(mine, 0.5 * (a + b))
        name = s.name if s is not None else "none"
        sums[name] = sums.get(name, 0.0) + (b - a)
    return [[n, v] for n, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

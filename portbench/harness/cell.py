"""One run of one cell: set-up, the window, the metrics, the output check.

Set-up builds the service from the seed's weights (both the configuration's
family's: `families/<family>.py`), warms only the buckets the cell's traffic
reaches, then offers the traffic; the window opens after the mix's lead-in.
After the window the peak memory is read, the program is freed, and the
family's reference recomputes the sampled requests.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from portbench.harness import check, drive, port, spans, traffic as tr
from portbench.harness.context import Context
from portbench.reference.seeds import derived_seed

TOP = 10  # entries of each breakdown list


def _breakdown(ctx: Context) -> Optional[Dict]:
    """The device operations that took most time in the traced stretch, its
    longest idle gaps by what the host was doing (inside a `sample_async`
    call or not), and its idle time summed by the port's innermost span open
    on the serving threads (`spans.idle_spans`; empty without spans)."""
    trace = ctx.trace
    if trace is None:
        return None
    by_name: Dict[str, float] = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((b - a, 0.5 * (a + b)) for a, b in trace.idle_gaps()), reverse=True)[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [["host in sample_async" if ctx.dispatch_at(mid) is not None
                           else "host outside sample_async", length] for length, mid in gaps],
            "idle_spans": spans.idle_spans(trace, spans.recorded() or [], TOP)}


class Prepared:
    """A cell's service, built from the seed's weights and warmed on the
    buckets its traffic reaches."""

    def __init__(self, spec, cell_name: str, seed: int, device):
        cell = spec.cell(cell_name)
        self.cfg = spec.config(cell["config"])
        self.family = spec.family(self.cfg)
        self.mix = spec.traffic(cell["traffic"])
        self.seed, self.device = seed, device
        marks = [("start", time.perf_counter())]
        params, stats = self.family.make(self.cfg, seed, device)
        marks.append(("weights", time.perf_counter()))
        self.service = self.family.build_service(self.cfg, params, stats, device)
        del params, stats
        marks.append(("service", time.perf_counter()))
        if self.mix["loop"] == "open":
            sizes = range(1, int(self.mix["batcher"]["max_batch"]) + 1)
        else:
            sizes = tr.request_sizes(self.mix)
        self.buckets = port.reachable_buckets(self.service, sizes)
        self.service.warmup(derived_seed(seed, 3), buckets=self.buckets)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append(("warm-up", time.perf_counter()))
        # seconds of each step of set-up
        self.timings = {b[0]: b[1] - a[1] for a, b in zip(marks[:-1], marks[1:])}
        self.t_begin = marks[0][1]

    def drive(self, seconds: float, trace: bool, mix: Optional[dict] = None):
        """One pass of the mix (or of `mix` in its place) through a fresh
        recorder: (run, recorder)."""
        mix = mix or self.mix
        rec = port.RecordingService(self.service)
        conditions = self.family.conditions(self.cfg)
        if mix["loop"] == "closed":
            return drive.closed_loop(rec, mix, conditions, self.seed, seconds, trace), rec
        if mix["loop"] == "open":
            from flowerdiff_torch.serving_http import CoalescingBatcher

            b = mix["batcher"]
            batcher = CoalescingBatcher(rec, derived_seed(self.seed, 2),
                                        max_wait_ms=b["max_wait_ms"], max_batch=b["max_batch"],
                                        pipeline_depth=b["pipeline_depth"])
            try:
                run_ = drive.open_loop(batcher, mix, conditions, self.seed, seconds, trace)
            finally:
                batcher.stop()
            return run_, rec
        raise ValueError(f"loop {mix['loop']!r} is neither 'closed' nor 'open'")


def run(spec, cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, metric_names: Optional[List[str]] = None,
        control: bool = False) -> Dict:
    """The result of one run: the keys of the benchmark's result line and
    `verdict`, the output check's (with `control`, the control's readings
    too). `metric_names`: the metrics to read in place of the cell's."""
    prep = Prepared(spec, cell_name, seed, device)
    prep_begin, prep_timings, prep_end = prep.t_begin, prep.timings, time.perf_counter()
    cfg, mix, family = prep.cfg, prep.mix, prep.family
    run_, rec = prep.drive(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    setup_s = run_.w0 - t_start
    run_.read_trace()
    ctx = Context(cfg, mix, run_, rec.dispatches, seconds, setup_s, family)
    names = metric_names if metric_names is not None else \
        [m["name"] for m in spec.metrics(cell_name, trace)]
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec.data["end_to_end"] + spec.data["per_layer"]}
    for name in names:
        value = spec.reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units.get(name, "")}
    breakdown = _breakdown(ctx) if trace else None
    trace_dev = None
    if trace and run_.trace is not None:
        trace_dev = {"busy_s": run_.trace.busy_s(), "window_s": run_.trace.window_s()}
    del prep, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    window = run_.in_window()
    verdict = check.check(family, cfg, mix, run_, ctx.dispatches, seed, device, control)
    out = {"correct": verdict["correct"], "attempted": len(window),
           "failed": sum(1 for r in window if r.result is None), "metrics": metrics,
           "device": {"memory_peak_bytes": int(peak)}}
    if trace_dev is not None:
        out["device"].update(trace_dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["verdict"] = verdict
    out["setup"] = {"before": prep_begin - t_start, **prep_timings,
                    "lead-in": run_.w0 - prep_end}
    return out

"""Where a cell's host time and idle gaps go, by the port's own spans.

    python3 portbench/span_report.py --workload <cell> [--seed 1] [--seconds 50] \\
        [--out report.json]
    python3 portbench/span_report.py --workload flagship.grid50 --cost 2 [--seconds 20]

The first form builds the cell with recording on (set-up by span), then
makes one traced pass as `run.py --trace 1` does (the window's last 4 s
profiled), its device trace mapped onto the host clock by the port's
calibration markers (`profiling.clock_offset_us`) as well as by the
harness's own marker. It prints, as JSON lines: the cell's per-layer
metrics; the stretch's host time by span name (calls, total, self, mean);
(spans wholly inside it); its idle time by the innermost span open on
the dispatching thread
(`harness/spans.idle_spans`); how many launches of the reverse-process
kernel have their runtime call inside a `sampler.launch` span under either
mapping; and the mean `service.sample_async` span beside `dispatch_ms`.

The second form measures what recording costs: 4 x `--cost` passes of the
cell with tracing off, recording off and on in turns (off, on, on, off,
...), each pass's `images_per_s` and `dispatch_ms`. It needs a CUDA card,
as `run.py` does, and reads nothing into the benchmark's result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "process_kernel"


def _calibrated(trace, profiling):
    """harness/trace.Profiled with the port's calibration markers before its
    own; its trace is read on the calibrated clock, and `shift_s` keeps the
    harness's mapping less the calibrated one."""

    class Calibrated(trace.Profiled):
        last = None

        def start(self):
            from torch.profiler import record_function

            self._prof.start()
            self._marks = profiling.clock_marks()
            with record_function(trace.CLOCK_SPAN):
                self._mark = time.perf_counter()
            self._drain()
            self._start = time.perf_counter()
            Calibrated.last = self

        def read(self):
            fd, path = tempfile.mkstemp(suffix=".json", prefix="span_report_")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
            finally:
                os.unlink(path)
            offset = profiling.clock_offset_us(events, self._marks)
            mark = next(e for e in events if e.get("name") == trace.CLOCK_SPAN)
            host = (float(mark["ts"]) - offset) * 1e-6
            self.shift_s = self._mark - host
            return trace.parse(events, host, self._start, self._stop)

    return Calibrated


def _by_name(spans):
    """{name: calls, total ms, self ms (less its children), mean ms}."""
    children = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + (s.end - s.start)
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["calls"] += 1
        row["total_ms"] += 1e3 * (s.end - s.start)
        row["self_ms"] += 1e3 * (s.end - s.start - children.get(s.id, 0.0))
    for row in out.values():
        row["mean_ms"] = row["total_ms"] / row["calls"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))


def _inside(t, launches):
    return any(s.start <= t <= s.end for s in launches)


def report(args, spec, device, profiling):
    from portbench.harness import spans as sp
    from portbench.harness import trace
    from portbench.harness.cell import Prepared
    from portbench.harness.context import Context

    trace.Profiled = _calibrated(trace, profiling)
    with profiling.record() as setup:
        prep = Prepared(spec, args.workload, args.seed, device)
    lines = [{"setup_by_span": _by_name(setup.spans), "setup_dropped": setup.dropped}]
    run, rec = prep.drive(args.seconds, True)
    run.read_trace()
    ctx = Context(prep.cfg, prep.mix, run, rec.dispatches, args.seconds, 0.0, prep.family)
    names = [m["name"] for m in spec.metrics(args.workload, True)]
    lines.append({"metrics": {n: spec.reader(n)(ctx) for n in names}})
    tr, got = ctx.trace, profiling.recorded()
    stretch = [s for s in got.spans if tr.start <= s.start and s.end <= tr.stop]
    lines.append({"stretch_s": tr.window_s(), "busy_s": tr.busy_s(), "dropped": got.dropped,
                  "host_by_span": _by_name(stretch)})
    gaps = tr.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    by_span = sp.idle_spans(tr, got.spans, top=100)
    named = sum(v for n, v in by_span if n != "none")
    lines.append({"idle_s": idle, "gaps": len(gaps), "idle_named_share": named / idle if idle
                  else None, "idle_spans": by_span,
                  "longest_gaps": sorted(((b - a, (a - tr.start)) for a, b in gaps),
                                         reverse=True)[:10]})
    launches = [s for s in got.spans if s.name == "sampler.launch"]
    ops = [o for o in tr.ops if KERNEL in o.name and o.launched is not None]
    shift = trace.Profiled.last.shift_s
    lines.append({
        "kernel_launches": len(ops),
        "inside_launch_span": sum(_inside(o.launched, launches) for o in ops),
        "inside_launch_span_harness_clock": sum(_inside(o.launched + shift, launches)
                                                for o in ops),
        "harness_clock_shift_us": 1e6 * shift})
    pairs = []  # (span ms, dispatch ms) of each call in the stretch
    for s in stretch:
        if s.name != "service.sample_async":
            continue
        d = next((d for d in rec.dispatches if d.t_issued is not None
                  and d.t_call <= s.start <= s.end <= d.t_issued), None)
        if d is not None:
            pairs.append((1e3 * (s.end - s.start), 1e3 * (d.t_issued - d.t_call)))
    lines.append({"calls": len(pairs),
                  "sample_async_span_ms": sum(a for a, _ in pairs) / len(pairs),
                  "dispatch_ms_same_calls": sum(b for _, b in pairs) / len(pairs)})
    return lines


def cost(args, spec, device, profiling):
    from portbench.harness.cell import Prepared
    from portbench.harness.context import Context

    prep = Prepared(spec, args.workload, args.seed, device)
    lines = []
    for on in [False, True, True, False] * args.cost:
        with profiling.record() if on else contextlib.nullcontext() as kept:
            run, rec = prep.drive(args.seconds, False)
        ctx = Context(prep.cfg, prep.mix, run, rec.dispatches, args.seconds, 0.0, prep.family)
        line = {"recording": on, "spans": len(kept.spans) if on else 0}
        for name in ("images_per_s", "dispatch_ms.grid", "latency_p95_ms.online"):
            if name in [m["name"] for m in spec.metrics(args.workload, False)
                        + spec.metrics(args.workload, True)]:
                line[name] = spec.reader(name)(ctx)
        lines.append(line)
        print("span_report cost " + json.dumps(line), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--cost", type=int, default=0, help="rounds of off, on, on, off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import env

    env.set_caches()
    import torch

    from portbench.harness.spec import Spec
    from flowerdiff_torch.utils import profiling

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = Spec()
    lines = (cost if args.cost else report)(args, spec, device, profiling)
    head = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
            "card": env.card()}
    for line in [head] + lines:
        print("span_report " + json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump([head] + lines, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

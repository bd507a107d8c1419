"""The highest rate an open-loop cell sustains, found by a sweep.

    python3 portbench/sweep.py --workload v2.online --rates 100,150,200 \\
        [--seconds 10] [--seed 1] [--out sweep.json]

Builds the cell once, then offers its mix at each rate in turn for
`--seconds` (after its lead-in) and prints, a rate a line: the images and
requests offered and delivered a second, the latency median and 95th
percentile, and the backlog's growth: the median latency of the window's
last third over its first third (near 1 where the rate is sustained). The
rate a cell runs at is written into its traffic file by hand; this only
finds it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="requests a second, comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import env

    env.set_caches()
    import numpy as np
    import torch

    from portbench.harness.cell import Prepared
    from portbench.harness.context import Context, percentile
    from portbench.harness.spec import Spec

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    prep = Prepared(Spec(), args.workload, args.seed, device)
    print(f"sweep {args.workload}: set-up {time.perf_counter() - T_START:.1f} s on "
          f"{env.card()}", flush=True)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(prep.mix, rate_per_s=rate)
        run, rec = prep.drive(args.seconds, False, mix)
        ctx = Context(prep.cfg, mix, run, rec.dispatches, args.seconds, 0.0, prep.family)
        window = sorted(ctx.window_requests(), key=lambda r: r.due)
        lat = [(r.t_done - r.due) * 1e3 for r in window if r.result is not None]
        third = max(1, len(lat) // 3)
        row = {"rate_per_s": rate, "offered_images_per_s": sum(len(r.classes) for r in window)
               / args.seconds, "images_per_s": ctx.delivered_images() / args.seconds,
               "requests": len(window), "failed": sum(r.result is None for r in window),
               "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
               "growth": float(np.median(lat[-third:]) / np.median(lat[:third])) if lat else None,
               "images_per_dispatch": (sum(len(d.classes) for d in ctx.window_dispatches())
                                       / max(1, len(ctx.window_dispatches())))}
        rows.append(row)
        print("sweep " + " ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in row.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": env.card(), "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The output check's readings: the program's and the control's, over seeds.

    python3 portbench/control.py --workload <cell> --seeds 101,102,... \\
        [--seconds 5] [--out control.json]

For each seed one process-internal run of the cell at its own size and load,
with a short window: the program's largest per-image gap from the reference
over the sampled requests (the lower reading comes from these), and, on the
same rows, the reference computed at the control's precision in the
program's place (the upper reading). Prints one line a seed and writes every
image's gaps to `--out`. It needs a CUDA card, as `run.py` does.
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
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import env

    env.set_caches()
    import numpy as np
    import torch

    from portbench.harness import cell
    from portbench.harness.spec import Spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = Spec()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = cell.run(spec, args.workload, seed, args.seconds, False, device, t0,
                       metric_names=[], control=True)
        v = res["verdict"]
        prog, ctl = v["gaps"], v["control"]["gaps"]
        row = {"seed": seed, "images": int(prog.size), "program_max": float(prog.max()),
               "program_median": float(np.median(prog)), "control_max": float(ctl.max()),
               "control_min": float(ctl.min()), "control_median": float(np.median(ctl)),
               "unplaced": v["numbers"]["unplaced"], "missing": v["numbers"]["missing"],
               "seconds": time.perf_counter() - t0,
               "program_gaps": prog.tolist(), "control_gaps": ctl.tolist()}
        rows.append(row)
        print(f"control {args.workload} seed {seed}: images {row['images']} program max "
              f"{row['program_max']:.4f} median {row['program_median']:.4f} | control max "
              f"{row['control_max']:.4f} median {row['control_median']:.4f} min "
              f"{row['control_min']:.4f} | unplaced {row['unplaced']} missing {row['missing']}"
              f" | {row['seconds']:.1f} s", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(device),
                       "rows": rows}, f)
    lo = max(r["program_max"] for r in rows)
    hi = min(r["control_max"] for r in rows)
    print(f"control {args.workload}: lower reading (largest program max) {lo:.4f}, upper "
          f"reading (smallest control max) {hi:.4f}, ratio {hi / lo if lo else float('inf'):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

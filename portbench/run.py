"""The benchmark of flowerdiff_torch, the PyTorch and CUDA port, on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One run builds the cell's service from seeded
weights, offers the cell's traffic for `--seconds` after a lead-in, checks a
sample of what it served against the plain reference, and prints, as the
last line of its standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the end-to-end metrics with `--trace 0`, the per-layer
ones with `--trace 1`), `device`, with `--trace 1` `breakdown`, the card's
power limit under `card`, and last `check`, each compared number beside its
limit, which also close its standard error. It exits non-zero, printing no
result, where torch sees no CUDA card, fewer cards than the cell asks for,
or, once the window has closed, a module of JAX or of the JAX package loaded
in this process.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import env

    env.set_caches()
    import torch

    from portbench.harness import cell
    from portbench.harness.spec import Spec

    spec = Spec()
    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = cell.run(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                      T_START)
    found = env.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    verdict = result.pop("verdict")
    setup = result.pop("setup")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": chips, **result["device"]}
    result["card"] = env.card()
    result["check"] = {k: {"value": v, "limit": verdict["limits"][k]}
                       for k, v in verdict["numbers"].items()}
    sys.stdout.flush()
    print("portbench: set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()),
          file=sys.stderr)
    print(f"portbench: checked {verdict['requests']} requests, {verdict['images']} images "
          f"of {result['attempted']} attempted; card {result['card']}", file=sys.stderr)
    for k, v in verdict["numbers"].items():
        print(f"check {k} {v} limit {verdict['limits'][k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one phase of chip_smoke.py from several source trees on one CUDA
card, in turns, so that two versions of a path that the phase drives are
compared on the same card in one run.

    python3 src/flowerdiff_torch/tools/phase_ab.py [--phase phase_runner] \\
        TREE [TREE ...]

Each TREE is a directory inside this checkout that holds chip_smoke.py and
src/flowerdiff_torch: "." for the working tree, or an earlier commit
unpacked into the git-ignored build/ (`mkdir -p build/parent && git
archive HEAD~1 | tar -x -C build/parent`). The first round runs the trees
in order, the second in reverse order (A B B A for two trees), each in a
fresh process in the tree's root that builds the tree's kernel
libraries (`phase_build`), sets the TF32 flags as chip_smoke.main does and
then runs the phase, which must take no argument (`phase_runner`,
`phase_http`). Its failure fails the run.

Prints the phase's own lines, each prefixed with its tree and round, then
the phase's wall time a run and a tree.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[3]
ROUNDS = 2
TIMEOUT_S = 900  # a run; phase_runner takes ~80-115 s on an H100

CHILD = """
import sys, time
import torch
sys.argv = ["chip_smoke.py"]
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
t0 = time.perf_counter()
getattr(cs, {phase!r})()
print(f"[phase_ab] seconds {{time.perf_counter() - t0:.3f}}", flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--phase", default="phase_runner")
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees]
    for tree in trees:
        if tree != _ROOT and _ROOT not in tree.parents:
            raise SystemExit(f"{tree} is not inside the checkout {_ROOT}")
        if not (tree / "chip_smoke.py").is_file():
            raise SystemExit(f"{tree} holds no chip_smoke.py")
    seconds = {tree: [] for tree in trees}
    for rnd in range(ROUNDS):
        for tree in trees if rnd % 2 == 0 else list(reversed(trees)):
            (tree / "build").mkdir(exist_ok=True)  # the phases' temporary directories
            out = subprocess.run([sys.executable, "-c", CHILD.format(phase=args.phase)],
                                 cwd=tree, capture_output=True, text=True,
                                 timeout=TIMEOUT_S)
            tag = f"[{tree.relative_to(_ROOT) if tree != _ROOT else '.'} r{rnd}]"
            for line in out.stdout.splitlines():
                if line.startswith("[phase_ab] seconds "):
                    seconds[tree].append(float(line.split()[-1]))
                print(f"{tag} {line}", flush=True)
            if out.returncode:
                print(out.stderr[-8000:], file=sys.stderr)
                raise SystemExit(f"tree {tree} failed (exit {out.returncode})")
    for tree, runs in seconds.items():
        print(f"[phase_ab] {args.phase} tree {tree}: wall seconds {runs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

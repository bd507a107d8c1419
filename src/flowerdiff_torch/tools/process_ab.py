#!/usr/bin/env python3
"""Time the flagship's 1000-step guided reverse-process call of several
source trees on one CUDA card, in turns, so that two versions are compared
on the same card in one run.

    python3 src/flowerdiff_torch/tools/process_ab.py [--rounds 2] TREE [TREE ...]

Each TREE is a directory inside this checkout that holds src/flowerdiff_torch:
"." for the working tree, or an earlier commit unpacked into the git-ignored
build/ (`mkdir -p build/parent && git archive HEAD~1 src | tar -x -C
build/parent`). Round r runs the trees in order, the next round in reverse
order (A B B A for two trees and two rounds), each in a fresh process that
builds its own reverse-process library. A process binds the flagship
denoiser (latent 256, hidden (256, 512, 1024, 512, 256), 102 classes,
weights from seed 0, the same in every tree) to a 1000-step schedule, draws
one guided request at each of the 8 and 64 buckets (CFG 7.0, x0 clip 3.0,
step noise), and times five launches of `ReverseProcess` between CUDA
events after one warm-up. Prints one JSON line a (tree, round): the times,
the sum of x_0 at each bucket (equal sums: the same bits, as far as a sum
shows), and ptxas's spill lines of the tree's reverse-process instances;
then the mean a tree a bucket over the rounds, without the first timed
launch of each process, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]
FLAGSHIP = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                num_classes=102, shared_cond_proj=True, global_skip=False)


def child(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch

    from flowerdiff_torch.diffusion import linear_schedule
    from flowerdiff_torch.kernels import _build
    from flowerdiff_torch.kernels.full_sampler import (
        ReverseProcess,
        draw_request,
        prepare_fused_sampler,
    )
    from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

    report = _build.build_all(["reverse_process"])["reverse_process"]
    model = denoiser_from_params(init_numpy_params("denoiser", seed=0, **FLAGSHIP),
                                 device="cuda", **FLAGSHIP)
    prep = prepare_fused_sampler(model, linear_schedule(1000).to("cuda"))
    process = ReverseProcess(prep)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": str(tree), "spills": [l.strip() for l in report.splitlines() if "spill" in l]}
    kw = dict(stochastic=True, clip_x0=3.0, guidance_scale=7.0)
    for batch in (8, 64):
        inputs = draw_request(prep, batch, torch.arange(batch, device="cuda") % 102, None, gen,
                              None, True)
        x = process(inputs, **kw)
        ms = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            process(inputs, **kw)
            end.record()
            torch.cuda.synchronize()
            ms.append(round(start.elapsed_time(end), 3))
        out[f"ms_{batch}"] = ms
        out[f"sum_{batch}"] = float(x.double().sum())
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees]
    for tree in trees:
        if tree != _ROOT and _ROOT not in tree.parents:
            raise SystemExit(f"{tree} is not inside the checkout {_ROOT}")
    if args.child:
        child(trees[0])
        return 0
    times = {}
    for rnd in range(args.rounds):
        for tree in (trees if rnd % 2 == 0 else list(reversed(trees))):
            out = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise SystemExit(f"tree {tree} failed (exit {out.returncode})")
            line = out.stdout.strip().splitlines()[-1]
            print(f"[process_ab] round {rnd} {line}", flush=True)
            rec = json.loads(line)
            for batch in (8, 64):
                times.setdefault((str(tree), batch), []).extend(rec[f"ms_{batch}"][1:])
    for (tree, batch), ms in times.items():
        print(f"[process_ab] tree {tree} bucket {batch}: mean {sum(ms) / len(ms):.3f} ms "
              f"over {len(ms)} launches, min {min(ms):.3f}, max {max(ms):.3f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[process_ab] card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

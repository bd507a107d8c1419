#!/usr/bin/env python3
"""Time the stage kernel of several source trees on one CUDA card, in turns,
so that two versions are compared on the same card in one run.

    python3 src/flowerdiff_torch/tools/stage_ab.py [--rounds 2] TREE [TREE ...]

Each TREE is a directory inside this checkout that holds src/flowerdiff_torch:
"." for the working tree, or an earlier commit unpacked into the git-ignored
build/ (`mkdir -p build/parent && git archive HEAD~1 | tar -x -C
build/parent`). A variant of the launch plan is a tree unpacked the same way
with its kernels/latent_stage.py edited. Round r runs the trees in order,
the next round in reverse order (A B B A for two trees and two rounds), each
in a fresh process that builds its own kernel library. A process binds the
flagship's four stages, hidden (256, 512, 1024, 512, 256), to weights drawn
from a fixed seed (the same in every tree), holds each against the tree's
plain twin at 16 and 128 rows (the 8- and 64-image buckets with
classifier-free guidance) and times one launch with `cuda_ms`, the timer of
chip_smoke.py (utils/timing.py of this checkout).

With --sweep, the first round also times every plan `stage_plans` offers
for each (stage, rows) (a tree that has it), beside the cost model's us.
Prints one line a (tree, round, stage, rows), with the tensor-map encodes
the binding made (none where the tree's stage has no tensor maps), then the
mean a tree a stage and the sum of the four stages at each row count; then,
unless --no-phases, each tree's per-phase breakdown at both row counts
(tools/stage_phases.py of this checkout, its diagnostic build of each tree).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HIDDEN = (256, 512, 1024, 512, 256)
ROWS = (16, 128)
_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]


def _local(name: str, path: Path):
    """A module of this checkout, loaded by path: the tree timed may predate it."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cuda_ms():
    return _local("_fd_timing", _PORT / "utils" / "timing.py").cuda_ms


def child(tree: Path, sweep: bool = False, rows_list=ROWS) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from flowerdiff_torch.kernels import latent_stage as ls

    cuda_ms = _cuda_ms()
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    for i in range(len(HIDDEN) - 1):
        d, dout = HIDDEN[i], HIDDEN[i + 1]
        w = {"wb": r(d, d, scale=d ** -0.5), "wv": r(d, d, scale=d ** -0.5),
             "wo": r(d, d, scale=d ** -0.5), "wd": r(dout, d, scale=d ** -0.5)}
        w = {k: v.to(torch.bfloat16).cuda() for k, v in w.items()}
        for name in ("bb", "b1", "b2", "bv", "bo"):
            w[name] = r(d, scale=0.5).cuda()
        w["g1"], w["g2"] = 1 + r(d, scale=0.2).cuda(), 1 + r(d, scale=0.2).cuda()
        w["bd"] = r(dout, scale=0.5).cuda()
        counted = hasattr(ls, "stage_map_encodes")
        e0 = ls.stage_map_encodes() if counted else 0
        run = ls.bind_stage(**w)
        encodes = ls.stage_map_encodes() - e0 if counted else None
        for rows in rows_list:
            plan = run.plan_for(rows) if hasattr(run, "plan_for") else None
            h, tc, row = r(rows, d).cuda(), r(rows, d, scale=0.5).cuda(), r(d).cuda()
            ref = ls.fused_stage_plain(h, tc, **w, row_add=row)
            err = float((run(h, tc, row) - ref).abs().max()) / float(ref.abs().max())
            ms = cuda_ms(lambda: run(h, tc, row))
            if counted:
                assert ls.stage_map_encodes() - e0 == encodes, "a launch encoded a tensor map"
            print(json.dumps({"stage": f"{d}->{dout}", "rows": rows, "ms": ms,
                              "rel_err": err, "plan": plan._asdict() if plan else None,
                              "encodes_at_bind": encodes}), flush=True)
            if sweep and hasattr(ls, "stage_plans"):
                for other in ls.stage_plans(d, dout, rows):
                    got = run(h, tc, row, plan=other)
                    err = float((got - ref).abs().max()) / float(ref.abs().max())
                    ms = cuda_ms(lambda: run(h, tc, row, plan=other))
                    print(f"[stage_ab] sweep {d}->{dout} B={rows}: ms {ms:.4f} model "
                          f"{ls.stage_cost_us(d, dout, other):.2f} us rel_err {err:.2e} "
                          f"{'(the plan) ' if other == plan else ''}{other}", flush=True)
                if counted:  # a swept plan of new column slices encodes its maps
                    e0 = ls.stage_map_encodes() - encodes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-phases", action="store_true", help="skip the per-phase breakdown")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="row counts, comma-separated (default: the 8 and 64 buckets with CFG)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every plan `stage_plans` offers, in the first round")
    ap.add_argument("--launches", type=int, default=200,
                    help="launches a (stage, rows) in the per-phase breakdown")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees]
    for tree in trees:
        if tree != _ROOT and _ROOT not in tree.parents:
            raise SystemExit(f"{tree} is not inside the checkout {_ROOT}")
    if args.child:
        child(trees[0], args.sweep, [int(r) for r in args.rows.split(",")])
        return 0
    results = {}
    for rnd in range(args.rounds):
        order = args.trees if rnd % 2 == 0 else list(reversed(args.trees))
        for tree in order:
            sweep = ["--sweep"] if args.sweep and rnd == 0 else []
            out = subprocess.run([sys.executable, __file__, "--child", tree, "--rows", args.rows]
                                 + sweep,
                                 capture_output=True, text=True, timeout=600)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise SystemExit(f"tree {tree} failed (exit {out.returncode})")
            for line in out.stdout.splitlines():
                if line.startswith("[stage_ab] sweep"):
                    print(line.replace("[stage_ab] sweep", f"[stage_ab] sweep tree {tree}"))
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                print(f"[stage_ab] tree {tree} round {rnd} stage {rec['stage']} "
                      f"B={rec['rows']}: ms {rec['ms']:.4f} rel_err {rec['rel_err']:.2e} "
                      f"plan {rec['plan']} tensor-map encodes at bind "
                      f"{rec.get('encodes_at_bind')}")
                results.setdefault(tree, {}).setdefault(
                    (rec["stage"], rec["rows"]), []).append(rec["ms"])
    for tree, by_shape in results.items():
        for rows in [int(r) for r in args.rows.split(",")]:
            means = {s: sum(v) / len(v) for (s, b), v in by_shape.items() if b == rows}
            runs = {s: v for (s, b), v in by_shape.items() if b == rows}
            print(f"[stage_ab] tree {tree} B={rows}: sum of means {sum(means.values()):.4f} "
                  f"ms; " + "; ".join(f"{s} {m:.4f} {['%.4f' % x for x in runs[s]]}"
                                      for s, m in means.items()))
    if not args.no_phases:
        phases = _local("_fd_stage_phases", _PORT / "tools" / "stage_phases.py")
        for tree in trees:
            for _, text in phases.run_tree(tree, args.launches):
                print(text.replace("[phases]", "[stage_ab] phases"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

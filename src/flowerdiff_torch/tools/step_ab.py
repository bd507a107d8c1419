#!/usr/bin/env python3
"""Time the sampler step's projection and head kernels of several source
trees on one CUDA card, in turns, so that two versions are compared on the
same card in one run.

    python3 src/flowerdiff_torch/tools/step_ab.py [--rounds 2] TREE [TREE ...]

Each TREE is a directory inside this checkout that holds src/flowerdiff_torch:
"." for the working tree, or an earlier commit unpacked into the git-ignored
build/ (`mkdir -p build/parent && git archive HEAD~1 src/flowerdiff_torch |
tar -x -C build/parent`). Round r runs the trees in order, the next round in
reverse order (A B B A for two trees and two rounds), each in a fresh process
that builds its own kernel libraries.

A process binds the flagship denoiser's weights (latent 256, hidden (256,
..., 256), seed 0) and, at the step's 16 and 128 stage rows (the 8- and
64-image buckets under classifier-free guidance), holds each kernel against
the tree's plain twin and checks that a repeat gives the same bits, then
times with `cuda_ms`, the timer of chip_smoke.py (utils/timing.py of this
checkout):
  - the projection (`bind_latent_proj`), guided (two copies of h), with and
    without the v2 skip (Wf and bf of the model's `final`, rw = 0.3);
  - the head in the sampler's form (`bind_head`, no base products; a time
    row and condition rows as adds);
  - the library yardsticks in the same process, never on the port's path:
    one bf16 `torch.addmm` of h (one copy, no skip) for the projection, and
    `F.layer_norm` then a bf16 `torch.addmm` (two calls; no single call
    computes the head) on bf16 copies of the head's summed rows;
  - where the tree's libraries export one, an empty kernel on each kernel's
    grid: the launch floor in the same timer.

Prints one line a (tree, round, measurement), then the card's name and power
limit and per tree the mean of each measurement over the rounds.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

FLAGSHIP = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                num_classes=102, shared_cond_proj=True, global_skip=False)
ROWS = (16, 128)
_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]


def _cuda_ms():
    """cuda_ms of this checkout, loaded by path: the tree timed may predate it."""
    spec = importlib.util.spec_from_file_location("_fd_timing", _PORT / "utils" / "timing.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.cuda_ms


def _emit(**rec):
    print(json.dumps(rec), flush=True)


def _empty_launcher(lib, symbol: str, *args):
    """A call of the library's empty launch on the current stream, or None
    where the tree's library has none."""
    fn = getattr(lib, symbol, None)
    if fn is None:
        return None
    import torch

    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{symbol} failed: cudaError {code}")
    return launch


def child(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    from flowerdiff_torch.kernels import _build
    from flowerdiff_torch.kernels import full_sampler as fs
    from flowerdiff_torch.kernels import latent_stage as ls
    from flowerdiff_torch.kernels.denoiser_apply import head_weights
    from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_ms = _cuda_ms()
    model = denoiser_from_params(init_numpy_params("denoiser", seed=0, **FLAGSHIP),
                                 device="cuda", **FLAGSHIP)
    lat, hid = FLAGSHIP["latent_dim"], FLAGSHIP["hidden_dims"][0]
    dl = FLAGSHIP["hidden_dims"][-1]
    hw = head_weights(model)
    wl = model.latent_proj.weight.detach().to(torch.bfloat16).contiguous()
    bl = model.latent_proj.bias.detach().float().contiguous()
    skip_w = dict(wf=hw["wf"], bf=hw["bf"], rw=torch.tensor(0.3, device="cuda"))
    table_w = {**hw, "wt": None, "bt": None, "wc": None, "bc": None}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def rel(got, ref):
        return float((got - ref).abs().max()) / float(ref.abs().max())

    proj_lib = _build.load("latent_proj")
    head_lib = _build.load("latent_head") if "latent_head" in _build.SOURCES else None
    for rows in ROWS:
        b = rows // 2
        x = r(b, lat)
        for with_skip in (False, True):
            kw = skip_w if with_skip else {}
            run = fs.bind_latent_proj(wl, bl, **kw)
            h, skip = run(x, 2)
            ref_h, ref_skip = fs.latent_proj_plain(x, wl, bl, copies=2, **kw)
            err = rel(h, ref_h) if skip is None else max(rel(h, ref_h), rel(skip, ref_skip))
            again = run(x, 2)
            same = torch.equal(again[0], h) and (skip is None or torch.equal(again[1], skip))
            assert torch.equal(h[:b], h[b:]), "the two CFG copies differ"
            _emit(what=f"latent_proj guided skip={with_skip}", rows=rows,
                  ms=cuda_ms(lambda: run(x, 2)), rel_err=err, repeat_bit_equal=same)
        xb, blb = x.to(torch.bfloat16), bl.to(torch.bfloat16)
        _emit(what="latent_proj yardstick: bf16 torch.addmm, one copy, no skip", rows=rows,
              ms=cuda_ms(lambda: torch.addmm(blb, xb, wl.t())))
        empty = _empty_launcher(proj_lib, "fd_latent_proj_empty_launch", b, lat, hid, 0)
        if empty is not None:
            _emit(what="latent_proj grid, empty kernel", rows=rows, ms=cuda_ms(empty))

        h, row_add, rows_add = r(rows, dl), r(dl), r(rows, dl, scale=0.5)
        run = ls.bind_head(**table_w)
        got = run(h, None, None, row_add, rows_add)
        ref = ls.fused_head_plain(h, None, None, **table_w, row_add=row_add, rows_add=rows_add)
        same = torch.equal(run(h, None, None, row_add, rows_add), got)
        _emit(what="fused_head table form", rows=rows,
              ms=cuda_ms(lambda: run(h, None, None, row_add, rows_add)),
              rel_err=rel(got, ref), repeat_bit_equal=same)
        hb = (h + row_add + rows_add).to(torch.bfloat16)
        gb, bb = hw["g"].to(torch.bfloat16), hw["b"].to(torch.bfloat16)
        bfb, wf = hw["bf"].to(torch.bfloat16), hw["wf"]
        _emit(what="fused_head yardstick: F.layer_norm + bf16 torch.addmm (two calls)",
              rows=rows, ms=cuda_ms(lambda: torch.addmm(
                  bfb, F.layer_norm(hb, (dl,), gb, bb, ls.LN_EPS), wf.t())))
        if head_lib is not None:
            empty = _empty_launcher(head_lib, "fd_head_cols_empty_launch", rows, lat)
            if empty is not None:
                _emit(what="fused_head grid, empty kernel", rows=rows, ms=cuda_ms(empty))


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
    results = {}
    for rnd in range(args.rounds):
        order = args.trees if rnd % 2 == 0 else list(reversed(args.trees))
        for tree in order:
            out = subprocess.run([sys.executable, __file__, "--child", tree],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise SystemExit(f"tree {tree} failed (exit {out.returncode})")
            for line in out.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                extra = (f" rel_err {rec['rel_err']:.2e} repeat bit-equal "
                         f"{rec['repeat_bit_equal']}" if "rel_err" in rec else "")
                print(f"[step_ab] tree {tree} round {rnd} {rec['what']} rows={rec['rows']}: "
                      f"ms {rec['ms']:.5f}{extra}")
                results.setdefault(tree, {}).setdefault(
                    (rec["what"], rec["rows"]), []).append(rec["ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[step_ab] card: {smi}")
    for tree, by_key in results.items():
        for (what, rows), runs in by_key.items():
            print(f"[step_ab] tree {tree} {what} rows={rows}: mean ms "
                  f"{sum(runs) / len(runs):.5f} {[round(v, 5) for v in runs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

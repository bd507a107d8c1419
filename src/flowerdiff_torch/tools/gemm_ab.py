#!/usr/bin/env python3
"""Time the train step's product of several source trees on one CUDA card, in
turns, so that two versions are compared on the same card in one run.

    python3 src/flowerdiff_torch/tools/gemm_ab.py [--rounds 2] TREE [TREE ...]

Each TREE is a directory inside this checkout that holds src/flowerdiff_torch:
"." for the working tree, or an earlier commit unpacked into the git-ignored
build/ (`mkdir -p build/parent && git archive HEAD~1 src/flowerdiff_torch |
tar -x -C build/parent`). Round r runs the trees in order, the next round in
reverse order (A B B A for two trees and two rounds), each in a fresh process
that builds its own kernel library.

A process times the bf16 lane's product (`linear_forward`, `linear_dx` and
`linear_dw` of kernels/train_step.py, through `fd_gemm_launch`) at every
(form, M, N, K) of the flagship train step, hidden (256, 512, 1024, 512, 256),
time embedding 256, latent 256, B = 64, with `cuda_ms`, the timer of
chip_smoke.py (utils/timing.py of this checkout). Beside each shape it times
`torch.matmul` on bf16 copies of the same operands in the same timer, the
library yardstick (never on the port's path). Then the whole bf16 train step
(`bind_train_step`, 119 launches) in the same timer, and an epoch of the
epoch kernel (`make_mega_epoch_fn`, S = 15, bf16 lane and moments) between
CUDA events around five epochs.

Where the tree exports its product plan (`product_plan`), each shape also
gets the kernel the plan names and an empty kernel on the plan's grid,
block, shared memory and cluster (the launch floor, `product_empty_launcher`),
and each Y and dX shape the split-K and the wgmma kernel forced in turn
(`route=`), each beside an empty kernel on its own grid.

Where the tree has the mma_dw kernel (the bf16 dW form that tensor maps
cannot read), each dW shape also gets it forced (`route="mma_dw"`), and the
dW products of the step at latent and time embedding 254 (rows that are
not whole 16-byte units) are timed on the plan's kernel beside the wgmma
kernel at the nearest shape that tensor maps read (each width rounded up to
a multiple of 4) and `torch.matmul` on bf16 copies.

Host side, per tree: the calls of cuTensorMapEncodeTiled (a step after the
first through `bind_train_step`; an epoch after the first; a round of a
step, an epoch and another binding's step with all three bindings alive),
read from the tree's `tensor_map_encodes()` or, for a tree that predates
it, from a counting wrapper force-included into its build (`ENCODE_SHIM`,
which wraps the `cuTensorMapEncodeTiled` the tree looks up); the host us
of one bound step's call (`run(data, masks)`: its checks and the ctypes
call, the stream idle before it and not synchronised in it); the epoch's
wall ms (host clock around five epochs and a synchronise), one profiled
epoch's busy ms, and the host's own ms in one epoch call (it returns
before the card finishes: well under the wall, the card's gaps between
launches and not the host set the wall); the trainer's window
(`make_fused_cached_epochs` with the train kernel, what `run_epochs_fused`
runs) ms a step by host clock over an epoch of 15 steps on a random latent
pool.

Prints one line a (tree, round, shape), then the card's name and power limit
and per tree the mean a shape, the sums over a step's products of each form
and of all 79 (each shape times its count) of every measurement, the step,
the epoch and the host measurements.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HIDDEN = (256, 512, 1024, 512, 256)
TE = LATENT = 256
BATCH = 64
EPOCH_STEPS = 15
RAGGED = 254  # latent and time embedding of the ragged step
_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]

# Force-included into the kernel build of a tree without its own encode
# counter: the cuTensorMapEncodeTiled the tree looks up through the CUDA
# runtime comes back wrapped in a counting function; `fd_shim_encodes`
# reads the count.
ENCODE_SHIM = r"""
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <string.h>
#include <atomic>
namespace fd_shim {
static std::atomic<long long> encodes{0};
static void* real_encode = nullptr;
static CUresult encode(CUtensorMap* m, CUtensorMapDataType t, cuuint32_t r, void* g,
                       const cuuint64_t* d, const cuuint64_t* s, const cuuint32_t* b,
                       const cuuint32_t* e, CUtensorMapInterleave i, CUtensorMapSwizzle w,
                       CUtensorMapL2promotion l, CUtensorMapFloatOOBfill f) {
  encodes.fetch_add(1);
  return ((decltype(&encode))real_encode)(m, t, r, g, d, s, b, e, i, w, l, f);
}
static void wrap(const char* symbol, void** p) {
  if (*p && strcmp(symbol, "cuTensorMapEncodeTiled") == 0) {
    real_encode = *p;
    *p = (void*)&encode;
  }
}
#if CUDART_VERSION >= 12050
static cudaError_t entry_v(const char* symbol, void** p, int version, unsigned long long flags,
                           cudaDriverEntryPointQueryResult* q) {
  const cudaError_t err = cudaGetDriverEntryPointByVersion(symbol, p, version, flags, q);
  wrap(symbol, p);
  return err;
}
#endif
static cudaError_t entry(const char* symbol, void** p, unsigned long long flags,
                         cudaDriverEntryPointQueryResult* q) {
  const cudaError_t err = cudaGetDriverEntryPoint(symbol, p, flags, q);
  wrap(symbol, p);
  return err;
}
}  // namespace fd_shim
extern "C" long long fd_shim_encodes() { return fd_shim::encodes.load(); }
#undef cudaGetDriverEntryPoint
#define cudaGetDriverEntryPoint fd_shim::entry
#if CUDART_VERSION >= 12050
#undef cudaGetDriverEntryPointByVersion
#define cudaGetDriverEntryPointByVersion fd_shim::entry_v
#endif
"""


def step_products(hidden=HIDDEN, te=TE, latent=LATENT, batch=BATCH):
    """{(form, M, N, K): count} of the bf16 products of one train step, in
    the order csrc/train_step.cuh enqueues them: a Linear (in -> out) gives
    fwd (B, out, in), dW (out, in, B) and, where its input needs a gradient,
    dX (B, in, out). The `final` product and the v2 skip are f32."""
    layers = [(te, 2 * te, False), (2 * te, te, True), (te, te, True), (te, te, True),
              (latent, hidden[0], False)]
    for i in range(len(hidden) - 1):
        d, dn = hidden[i], hidden[i + 1]
        layers += [(te, d, True), (d, d, True), (d, d, True), (d, d, True), (d, dn, True)]
    layers += [(te, hidden[-1], True)] * 2
    counts = {}
    for k_in, n_out, needs_dx in layers:
        shapes = [("fwd", batch, n_out, k_in), ("dw", n_out, k_in, batch)]
        if needs_dx:
            shapes.append(("dx", batch, k_in, n_out))
        for s in shapes:
            counts[s] = counts.get(s, 0) + 1
    return counts


def _cuda_ms():
    """cuda_ms of this checkout, loaded by path: the tree timed may predate it."""
    spec = importlib.util.spec_from_file_location("_fd_timing", _PORT / "utils" / "timing.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.cuda_ms


def _emit(**rec):
    print(json.dumps(rec), flush=True)


def _encode_counter(ts, _build):
    """A function that reads the calls of cuTensorMapEncodeTiled so far: the
    tree's own counter, or the shim's in every library it built with it."""
    if hasattr(ts, "tensor_map_encodes"):
        return ts.tensor_map_encodes
    shim = _ROOT / "build" / "gemm_ab" / "encode_shim.h"
    shim.parent.mkdir(parents=True, exist_ok=True)
    shim.write_text(ENCODE_SHIM)
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ["-include", str(shim)]

    def read():
        total = 0
        for lib in _build._LIBS.values():
            try:
                fn = lib.fd_shim_encodes
            except AttributeError:
                continue
            fn.restype = __import__("ctypes").c_longlong
            total += fn()
        return total
    return read


def child(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from flowerdiff_torch.kernels import _build
    from flowerdiff_torch.kernels import train_epoch as te
    from flowerdiff_torch.kernels import train_step as ts
    from flowerdiff_torch.train.latent_ddpm import (LatentDiffusionConfig,
                                                    create_latent_diffusion_state)

    encodes = _encode_counter(ts, _build)
    has_mma_dw = "mma_dw" in getattr(ts, "PRODUCT_KERNELS", ())

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_ms = _cuda_ms()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def bf(t):
        return t.to(torch.bfloat16).float()

    for (form, m, n, k), count in step_products().items():
        if form == "fwd":  # Y (B, out) = X (B, in) W^T + b: M = B, N = out, K = in
            x, w, b = r(m, k), r(n, k, scale=k ** -0.5), r(n)
            fn = lambda: ts.linear_forward(x, w, b, exact=False)  # noqa: E731
            ref = bf(x) @ bf(w).t() + b
            x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
            lib = lambda: torch.matmul(x16, w16.t())  # noqa: E731
            got = fn()
        elif form == "dx":  # dX (B, in) = dY (B, out) W: M = B, N = in, K = out
            dy, w = r(m, k), r(k, n, scale=n ** -0.5)
            fn = lambda: ts.linear_dx(dy, w, exact=False)  # noqa: E731
            ref = bf(bf(dy) @ bf(w))
            dy16, w16 = dy.to(torch.bfloat16), w.to(torch.bfloat16)
            lib = lambda: torch.matmul(dy16, w16)  # noqa: E731
            got = fn()
        else:  # dW (out, in) = dY^T X: M = out, N = in, K = B
            dy, x = r(k, m), r(k, n)
            fn = lambda: ts.linear_dw(dy, x, exact=False)  # noqa: E731
            ref = bf(bf(dy).t() @ bf(x))
            dy16, x16 = dy.to(torch.bfloat16), x.to(torch.bfloat16)
            lib = lambda: torch.matmul(dy16.t(), x16)  # noqa: E731
            got = fn()[0]
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        same = bool(torch.equal(got, fn() if form != "dw" else fn()[0]))
        rec = dict(kind="product", form=form, m=m, n=n, k=k, count=count, ms=cuda_ms(fn),
                   library_ms=cuda_ms(lib), rel_err=err, repeat_bit_equal=same)
        if hasattr(ts, "product_plan"):  # trees that export their plan and an empty launch
            rec["kernel"] = ts.product_plan(form, m, n, k)["kernel"]
            rec["empty_ms"] = cuda_ms(ts.product_empty_launcher(form, m, n, k))
            if form == "dw" and has_mma_dw:  # the kernel of dW that tensor maps cannot read
                rec["mma_dw_ms"] = cuda_ms(
                    lambda: ts.linear_dw(dy, x, exact=False, route="mma_dw"))
            if form != "dw":  # the two kernels the plan chooses between, each forced
                for route in ("splitk", "wgmma"):
                    call = ((lambda: ts.linear_forward(x, w, b, exact=False, route=route))
                            if form == "fwd" else
                            (lambda: ts.linear_dx(dy, w, exact=False, route=route)))
                    rec[f"{route}_ms"] = cuda_ms(call)
                    rec[f"{route}_empty_ms"] = cuda_ms(
                        ts.product_empty_launcher(form, m, n, k, route=route))
        _emit(**rec)

    if has_mma_dw:  # the ragged step's dW shapes on mma_dw, beside wgmma a width of 4 up
        for (form, m, n, k), count in step_products(te=RAGGED, latent=RAGGED).items():
            if form != "dw" or not any(4 * s % 16 for s in ts.contiguous_strides(form, m, n, k)):
                continue
            up = (-(-m // 4) * 4, -(-n // 4) * 4)
            dy, x = r(k, m), r(k, n)
            dy_up, x_up = r(k, up[0]), r(k, up[1])
            dy16, x16 = dy.to(torch.bfloat16), x.to(torch.bfloat16)
            _emit(kind="ragged_dw", m=m, n=n, k=k, count=count,
                  kernel=ts.product_plan("dw", m, n, k)["kernel"],
                  ms=cuda_ms(lambda: ts.linear_dw(dy, x, exact=False)),
                  aligned=up, wgmma_aligned_ms=cuda_ms(lambda: ts.linear_dw(dy_up, x_up,
                                                                            exact=False)),
                  library_ms=cuda_ms(lambda: torch.matmul(dy16.t(), x16)))

    flagship = dict(latent_dim=LATENT, hidden_dims=HIDDEN, time_emb_dim=TE, num_classes=102,
                    shared_cond_proj=True, global_skip=False)
    cfg = LatentDiffusionConfig(**flagship, dropout_rate=0.3, cond_dropout=0.1,
                                steps_per_epoch=EPOCH_STEPS, ema_decay=0.999)
    state, model, sched = create_latent_diffusion_state(4, cfg, "cuda")
    named = dict(ts.weights_spec(model))
    run = ts.bind_train_step(named, BATCH, dtype=torch.bfloat16)
    z = r(BATCH, LATENT)
    labels = torch.randint(0, 102, (BATCH,), generator=gen, device="cuda")
    t, eps, keep, masks = ts.draw_step_inputs(model, 1000, 0.1, z, gen)
    data = ts.step_data(sched, z, labels, t, eps, keep, ts.sinusoid_freqs(TE, "cuda"))
    _emit(kind="step", ms=cuda_ms(lambda: run(data, masks), iters=20))

    # the host's share of a bound step: one call, the stream idle before it
    enqueue_us = []
    for _ in range(200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(data, masks)
        enqueue_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    enqueue_us.sort()
    _emit(kind="enqueue", ms=enqueue_us[len(enqueue_us) // 2] / 1e3,
          p10_us=enqueue_us[20], p90_us=enqueue_us[180])

    epoch_fn = te.make_mega_epoch_fn(model, cfg, EPOCH_STEPS, BATCH)
    z_rows = r(EPOCH_STEPS, BATCH, LATENT)
    rows_labels = torch.randint(0, 102, (EPOCH_STEPS, BATCH), generator=gen, device="cuda")
    epoch_fn(state, sched, z_rows, rows_labels, 1)
    runs, walls = [], []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for e in range(5):
            epoch_fn(state, sched, z_rows, rows_labels, 2 + e)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 5)
        runs.append(start.elapsed_time(end) / 5)
    _emit(kind="epoch", ms=min(runs), runs=runs)
    _emit(kind="epoch_wall", ms=min(walls), runs=walls)
    calls = []  # the host's own time in the epoch's call, the stream idle before it
    for e in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch_fn(state, sched, z_rows, rows_labels, 10 + e)
        calls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    _emit(kind="epoch_call", ms=sorted(calls)[2], runs=calls)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch_fn(state, sched, z_rows, rows_labels, 9)
        torch.cuda.synchronize()
    _emit(kind="epoch_busy", ms=sum(e.self_device_time_total for e in prof.key_averages()
                                    if e.device_type == DeviceType.CUDA) / 1e3)

    # encodes: a step and an epoch after their first, then a round of three
    # bindings alive (a step, the epoch, another model's step)
    n0 = encodes()
    run(data, masks)
    torch.cuda.synchronize()
    n1 = encodes()
    epoch_fn(state, sched, z_rows, rows_labels, 20)
    torch.cuda.synchronize()
    n2 = encodes()
    state_b, model_b, _ = create_latent_diffusion_state(5, cfg, "cuda")
    run_b = ts.bind_train_step(dict(ts.weights_spec(model_b)), BATCH, dtype=torch.bfloat16)
    run_b(data, masks)
    rounds = []
    for i in range(3):
        torch.cuda.synchronize()
        n = encodes()
        run(data, masks)
        epoch_fn(state, sched, z_rows, rows_labels, 30 + i)
        run_b(data, masks)
        torch.cuda.synchronize()
        rounds.append(encodes() - n)
    _emit(kind="encodes", ms=0.0, step=n1 - n0, epoch=n2 - n1, three_bindings=rounds)

    # the trainer's window: the per-step kernel body over an epoch of 15 steps
    import dataclasses

    from flowerdiff_torch.train.fused import make_fused_cached_epochs

    wcfg = dataclasses.replace(cfg, train_kernel=True, latent_cache=8)
    wstate, wmodel, wsched = create_latent_diffusion_state(6, wcfg, "cuda")
    window = make_fused_cached_epochs(wmodel, wcfg, steps_per_epoch=EPOCH_STEPS)
    pool = r(8, 1020, LATENT)
    pool_labels = torch.randint(0, 102, (1020,), generator=gen, device="cuda")
    idx = torch.randint(0, 1020, (EPOCH_STEPS, BATCH), generator=gen, device="cuda")
    wgen = torch.Generator(device="cuda").manual_seed(3)
    window(wstate, wsched, pool, pool_labels, None, idx, wgen)
    wins = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window(wstate, wsched, pool, pool_labels, None, idx, wgen)
        torch.cuda.synchronize()
        wins.append((time.perf_counter() - t0) * 1e3 / EPOCH_STEPS)
    _emit(kind="window_step", ms=min(wins), runs=wins)


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
                                 capture_output=True, text=True, timeout=900)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise SystemExit(f"tree {tree} failed (exit {out.returncode})")
            for line in out.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if rec["kind"] == "ragged_dw":
                    key = ("ragged_dw", rec["m"], rec["n"], rec["k"])
                    print(f"[gemm_ab] tree {tree} round {rnd} dW M={rec['m']} N={rec['n']} "
                          f"K={rec['k']} x{rec['count']} on {rec['kernel']}: ms {rec['ms']:.5f}; "
                          f"wgmma at {rec['aligned']} {rec['wgmma_aligned_ms']:.5f}; "
                          f"torch.matmul bf16 {rec['library_ms']:.5f}")
                elif rec["kind"] == "encodes":
                    key = ("encodes",)
                    print(f"[gemm_ab] tree {tree} round {rnd} tensor-map encodes: a step after "
                          f"the first {rec['step']}, an epoch after the first {rec['epoch']}, "
                          f"a round of three bindings {rec['three_bindings']}")
                elif rec["kind"] == "product":
                    key = (rec["form"], rec["m"], rec["n"], rec["k"])
                    extra = "".join(f" {name} {rec[name]:.5f}" for name in (
                        "empty_ms", "splitk_ms", "splitk_empty_ms", "wgmma_ms",
                        "wgmma_empty_ms", "mma_dw_ms") if name in rec)
                    print(f"[gemm_ab] tree {tree} round {rnd} {rec['form']} M={rec['m']} "
                          f"N={rec['n']} K={rec['k']} x{rec['count']}"
                          f"{' on ' + rec['kernel'] if 'kernel' in rec else ''}: ms "
                          f"{rec['ms']:.5f} torch.matmul bf16 {rec['library_ms']:.5f}{extra} "
                          f"rel_err {rec['rel_err']:.2e} repeat bit-equal "
                          f"{rec['repeat_bit_equal']}")
                else:
                    key = (rec["kind"],)
                    print(f"[gemm_ab] tree {tree} round {rnd} {rec['kind']}: ms {rec['ms']:.4f}"
                          + (f" runs {[round(v, 4) for v in rec['runs']]}" if "runs" in rec
                             else ""))
                results.setdefault(tree, {}).setdefault(key, []).append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[gemm_ab] card: {smi}")
    for tree, by_key in results.items():
        sums = {}  # (form, measurement) -> ms summed over a step's products
        for key, recs in by_key.items():
            ms = sum(x["ms"] for x in recs) / len(recs)
            if key[0] == "encodes":
                print(f"[gemm_ab] tree {tree} encodes: a step {[x['step'] for x in recs]}, an "
                      f"epoch {[x['epoch'] for x in recs]}, three bindings "
                      f"{[x['three_bindings'] for x in recs]}")
                continue
            if key[0] == "ragged_dw":
                print(f"[gemm_ab] tree {tree} ragged dW M={key[1]} N={key[2]} K={key[3]} "
                      f"x{recs[0]['count']} on {recs[0]['kernel']}: mean ms {ms:.5f}, wgmma at "
                      f"{recs[0]['aligned']} "
                      f"{sum(x['wgmma_aligned_ms'] for x in recs) / len(recs):.5f}, "
                      f"torch.matmul {sum(x['library_ms'] for x in recs) / len(recs):.5f}")
                continue
            if len(key) == 1:
                print(f"[gemm_ab] tree {tree} {key[0]}: mean ms {ms:.4f} "
                      f"{[round(x['ms'], 4) for x in recs]}")
                continue
            count = recs[0]["count"]
            means = {name: sum(x[name] for x in recs) / len(recs) for name in (
                "ms", "library_ms", "empty_ms", "splitk_ms", "wgmma_ms", "mma_dw_ms")
                if name in recs[0]}
            for form in (key[0], "all"):
                for name, v in means.items():
                    sums[(form, name)] = sums.get((form, name), 0.0) + count * v
                sums[(form, "count")] = sums.get((form, "count"), 0) + count
            print(f"[gemm_ab] tree {tree} {key[0]} M={key[1]} N={key[2]} K={key[3]} "
                  f"x{count}{' on ' + recs[0]['kernel'] if 'kernel' in recs[0] else ''}: "
                  f"mean ms {ms:.5f} {[round(x['ms'], 5) for x in recs]} "
                  + " ".join(f"{name} {v:.5f}" for name, v in means.items() if name != "ms"))
        for form in ("fwd", "dx", "dw", "all"):
            if (form, "count") not in sums:
                continue
            print(f"[gemm_ab] tree {tree}: sum over a step's {sums[(form, 'count')]} bf16 "
                  f"{'products' if form == 'all' else form + ' products'}: "
                  + ", ".join(f"{name} {sums[(form, name)]:.4f}" for name in (
                      "ms", "library_ms", "empty_ms", "splitk_ms", "wgmma_ms", "mma_dw_ms")
                      if (form, name) in sums))
    return 0


if __name__ == "__main__":
    sys.exit(main())

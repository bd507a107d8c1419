#!/usr/bin/env python3
"""Where a stage launch spends its time, phase by phase, on one CUDA card.

    python3 src/flowerdiff_torch/tools/stage_phases.py [--launches 200] TREE [TREE ...]

A diagnostic build, never the library's: the tree's csrc/ is copied under
the git-ignored build/stage_phases/, its latent_stage.cu compiled with the
stamp macros defined ahead of it into a library of its own, and that library put in
place of the tree's `latent_stage` before the flagship's four stages are
bound. Thread 0 of the first block of the first cluster reads
%globaltimer (ns) and clock64 (cycles) at each phase boundary and adds the
time since the launch began into device arrays; waits on the weight ring
are added up per product on their own. The library itself has no such
switch: its stamps (FD_STAMP, in this tree's csrc/latent_stage.cu) compile
to nothing unless the macros are defined ahead of the source, as here; the
stage kernels of the tree before it (`stage_kernel`, the earlier weight ring, and
`stage_rows_kernel`, the earlier whole-row kernel) get the same stamps by
text insertion at fixed lines.

Each TREE is a directory inside this checkout that holds
src/flowerdiff_torch ("." or an unpacked parent under build/). Every
(tree, stage, rows) runs in a process of its own: `launches` eager
launches after a warm-up, the means printed per phase as
`[phases] tree stage rows kernel: phase ns (cycles) ...`, one JSON line
after each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HIDDEN = (256, 512, 1024, 512, 256)
ROWS = (16, 128)
MAX_STAMPS = 32
_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]

# Stamps and their readout, for a source that has none: a device array of
# sums a stamp and one of ring waits a product, read by an extra export.
_PRELUDE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long fd_phase_ns[32], fd_phase_clk[32], fd_wait_ns[8];
__device__ unsigned long long fd_phase_launches;
__device__ __forceinline__ unsigned long long fd_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ bool fd_stamping() {
  return blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
}
#define FD_STAMP_BEGIN unsigned long long fd_t0 = 0; long long fd_c0 = 0
#define FD_RING_WAIT(p, wait)                                           \
  do {                                                                  \
    const unsigned long long fd_w = fd_globaltimer();                   \
    wait;                                                               \
    if (fd_stamping()) fd_wait_ns[p] += fd_globaltimer() - fd_w;        \
  } while (0)
#define FD_STAMP(i)                                                     \
  do {                                                                  \
    if (fd_stamping()) {                                                \
      const unsigned long long fd_t = fd_globaltimer();                 \
      const long long fd_c = clock64();                                 \
      if ((i) == 0) { fd_t0 = fd_t; fd_c0 = fd_c; ++fd_phase_launches; } \
      fd_phase_ns[i] += fd_t - fd_t0;                                   \
      fd_phase_clk[i] += (unsigned long long)(fd_c - fd_c0);            \
    }                                                                   \
  } while (0)
"""

_READOUT = r"""
extern "C" int fd_stage_phases_read(unsigned long long* ns, unsigned long long* clk,
                                    unsigned long long* waits, unsigned long long* launches) {
  cudaError_t e = cudaMemcpyFromSymbol(ns, fd_phase_ns, sizeof(fd_phase_ns));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clk, fd_phase_clk, sizeof(fd_phase_clk));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(waits, fd_wait_ns, sizeof(fd_wait_ns));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(launches, fd_phase_launches, sizeof(fd_phase_launches));
  return (int)e;
}
extern "C" int fd_stage_phases_reset() {
  static unsigned long long zero[32] = {0};
  cudaError_t e = cudaMemcpyToSymbol(fd_phase_ns, zero, sizeof(fd_phase_ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_phase_clk, zero, sizeof(fd_phase_clk));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_wait_ns, zero, sizeof(fd_wait_ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_phase_launches, zero, sizeof(unsigned long long));
  return (int)e;
}
"""

# (the exact text of the earlier ring kernel as it stood before the stage
# kernel's Hopper redesign, the same text with a stamp after it)
_RING_STAMPS = [
    ("  const int tid = threadIdx.x;\n\n  Ring ring;\n",
     "  const int tid = threadIdx.x;\n  FD_STAMP_BEGIN;\n  FD_STAMP(0);\n\n  Ring ring;\n"),
    ("  __syncthreads();\n  cluster_wait();\n  if (!producer) push_operand(cluster, Xs, sd, Q0,",
     "  __syncthreads();\n  FD_STAMP(1);\n  cluster_wait();\n"
     "  if (!producer) push_operand(cluster, Xs, sd, Q0,"),
    ("  cluster_sync_all();\n\n  // h += swish(LN1(h @ Wb + bb))\n"
     "  ring_product(ring, 0, Q0, lda, bb + c0, U, sd, kRows, red);\n",
     "  cluster_sync_all();\n  FD_STAMP(2);\n\n  // h += swish(LN1(h @ Wb + bb))\n"
     "  ring_product(ring, 0, Q0, lda, bb + c0, U, sd, kRows, red);\n  FD_STAMP(3);\n"),
    ("  if (!producer) push_row_stats(cluster, U, sd, st1, n_cl, rank);\n  cluster_sync_all();\n",
     "  if (!producer) push_row_stats(cluster, U, sd, st1, n_cl, rank);\n"
     "  cluster_sync_all();\n  FD_STAMP(4);\n"),
    ("    push_row_stats(cluster, Xs, sd, st2, n_cl, rank);\n  }\n  cluster_sync_all();\n",
     "    push_row_stats(cluster, Xs, sd, st2, n_cl, rank);\n  }\n  cluster_sync_all();\n"
     "  FD_STAMP(5);\n"),
    ("  if (!producer) push_operand(cluster, U, sd, Q1, lda, c0, n_cl, rank);\n"
     "  cluster_sync_all();\n",
     "  if (!producer) push_operand(cluster, U, sd, Q1, lda, c0, n_cl, rank);\n"
     "  cluster_sync_all();\n  FD_STAMP(6);\n"),
    ("  ring_product(ring, 1, Q1, lda, bv + c0, U, sd, kRows, red);\n"
     "  if (!producer) push_operand(cluster, U, sd, Q0, lda, c0, n_cl, rank);  // Wo's operand\n"
     "  cluster_sync_all();\n"
     "  ring_product(ring, 2, Q0, lda, bo + c0, U, sd, kRows, red);\n",
     "  ring_product(ring, 1, Q1, lda, bv + c0, U, sd, kRows, red);\n  FD_STAMP(7);\n"
     "  if (!producer) push_operand(cluster, U, sd, Q0, lda, c0, n_cl, rank);  // Wo's operand\n"
     "  cluster_sync_all();\n  FD_STAMP(8);\n"
     "  ring_product(ring, 2, Q0, lda, bo + c0, U, sd, kRows, red);\n  FD_STAMP(9);\n"),
    ("  if (!producer) push_operand(cluster, Xs, sd, Q1, lda, c0, n_cl, rank);  // Wd's operand\n"
     "  cluster_sync_all();\n",
     "  if (!producer) push_operand(cluster, Xs, sd, Q1, lda, c0, n_cl, rank);  // Wd's operand\n"
     "  cluster_sync_all();\n  FD_STAMP(10);\n"),
    ("  ring_product(ring, 3, Q1, lda, bd + o0, out + (size_t)row0 * dout + o0, dout, valid, red);\n}\n",
     "  ring_product(ring, 3, Q1, lda, bd + o0, out + (size_t)row0 * dout + o0, dout, valid, red);\n"
     "  FD_STAMP(11);\n}\n"),
    ("    bar_wait(ring.full(q), ring.parity(q));\n    if (active) {\n",
     "    FD_RING_WAIT(p, bar_wait(ring.full(q), ring.parity(q)));\n    if (active) {\n"),
]
RING_PHASES = ["rows loaded", "exchange: h operand (+ start barrier)", "product Wb",
               "exchange: LN1 stats", "LN1 + swish, exchange: LN2 stats",
               "LN2, exchange: Wv operand", "product Wv", "exchange: Wo operand",
               "product Wo", "h += o, exchange: Wd operand", "product Wd + store"]

# The stamps of this tree's stage kernel (csrc/latent_stage.cu), in the
# order they are taken: (stamp, the phase that ends there)
WG_PHASES = [(12, "loads issued, barriers initialised"), (13, "first chunks issued"),
             (1, "start barrier, rows loaded"), (2, "exchange: h operand"), (3, "product Wb"),
             (4, "exchange: LN1 stats"), (14, "LN1 + swish"), (5, "exchange: LN2 stats"),
             (6, "LN2, exchange: Wv operand"), (7, "product Wv"),
             (8, "exchange: Wo operand (one buffer: after every block's Wv)"),
             (9, "product Wo"),
             (10, "h += o, exchange: Wd operand (one buffer: after every block's Wo)"),
             (11, "product Wd"), (15, "store")]

# The earlier whole-row kernel (the parent's 1024 -> 512 stage above one
# wave of clusters of 16): its own stamps, in the same arrays.
_ROWS_STAMPS = [
    ("  const int c0 = rank * sd;\n\n  fd::load_rows(X, h, row_add, rows_add, row0, B, d);\n",
     "  const int c0 = rank * sd;\n  FD_STAMP_BEGIN;\n  FD_STAMP(0);\n\n  fd::load_rows(X, h, row_add, rows_add, row0, B, d);\n"),
    ("  fd::to_operand(X, Q, d);\n  fd::gemm_tc(Q, d, wb, d, c0, sd, S0, red);\n"
     "  fd::add_bias(S0, sd, bb + c0);\n",
     "  fd::to_operand(X, Q, d);\n  FD_STAMP(12);\n  fd::gemm_tc(Q, d, wb, d, c0, sd, S0, red);\n"
     "  fd::add_bias(S0, sd, bb + c0);\n  FD_STAMP(13);\n"),
    ("  cluster_gather(cluster, S0, sd, F, nullptr, false);\n  fd::rows_layernorm(F, F, d, g1, b1, eps, true);\n",
     "  cluster_gather(cluster, S0, sd, F, nullptr, false);\n  FD_STAMP(14);\n"
     "  fd::rows_layernorm(F, F, d, g1, b1, eps, true);\n"),
    ("  fd::to_operand(F, Q, d);\n  fd::gemm_tc(Q, d, wv, d, c0, sd, S1, red);\n"
     "  fd::add_bias(S1, sd, bv + c0);\n",
     "  fd::to_operand(F, Q, d);\n  FD_STAMP(15);\n  fd::gemm_tc(Q, d, wv, d, c0, sd, S1, red);\n"
     "  fd::add_bias(S1, sd, bv + c0);\n  FD_STAMP(16);\n"),
    ("  cluster_gather(cluster, S1, sd, nullptr, Q, false);  // rounded to bf16: Wo's operand\n"
     "  fd::gemm_tc(Q, d, wo, d, c0, sd, S0, red);\n  fd::add_bias(S0, sd, bo + c0);\n",
     "  cluster_gather(cluster, S1, sd, nullptr, Q, false);  // rounded to bf16: Wo's operand\n"
     "  FD_STAMP(17);\n  fd::gemm_tc(Q, d, wo, d, c0, sd, S0, red);\n"
     "  fd::add_bias(S0, sd, bo + c0);\n  FD_STAMP(18);\n"),
    ("  cluster_gather(cluster, S0, sd, F, nullptr, true);\n  fd::add_rows(X, F, d);\n",
     "  cluster_gather(cluster, S0, sd, F, nullptr, true);\n  FD_STAMP(19);\n"
     "  fd::add_rows(X, F, d);\n"),
    ("  fd::gemm_tc(Q, d, wd, d, o0, so, S1, red);\n",
     "  FD_STAMP(20);\n  fd::gemm_tc(Q, d, wd, d, o0, so, S1, red);\n  FD_STAMP(21);\n"),
    ("  cluster_wait();  // every block done reading this block's S0\n}\n",
     "  FD_STAMP(22);\n  cluster_wait();  // every block done reading this block's S0\n}\n"),
]
ROWS_PHASES = {12: "rows loaded, operand", 13: "product Wb", 14: "gather Wb's columns",
               15: "LN1 + swish, LN2, operand", 16: "product Wv", 17: "gather Wv's columns",
               18: "product Wo", 19: "gather Wo's columns", 20: "h += o, operand",
               21: "product Wd", 22: "store"}


def stamped_source(text: str) -> str:
    """latent_stage.cu with stamps: the stamp macros defined ahead of a
    source that places them itself, else the parent's stamps inserted."""
    if "FD_STAMP" not in text:
        for old, new in _RING_STAMPS + _ROWS_STAMPS:
            if text.count(old) != 1:
                raise SystemExit(f"stage_phases: anchor not found once in latent_stage.cu:\n{old}")
            text = text.replace(old, new)
    return _PRELUDE + text + _READOUT


def build(tree: Path) -> Path:
    """The tree's latent_stage.cu with stamps, compiled into a library of
    its own (once: a later process of the same tree reuses it)."""
    csrc = tree / "src" / "flowerdiff_torch" / "kernels" / "csrc"
    work = _ROOT / "build" / "stage_phases" / (tree.name if tree != _ROOT else "working")
    out = work / "liblatent_stage_phases.so"
    text = stamped_source((csrc / "latent_stage.cu").read_text())
    headers = {h.name: h.read_text() for h in csrc.glob("*.cuh")}
    src = work / "latent_stage.cu"
    if (out.exists() and src.read_text() == text
            and all((work / n).exists() and (work / n).read_text() == t for n, t in headers.items())):
        return out
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    src.write_text(text)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(work), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"stage_phases: nvcc failed:\n{proc.stdout}{proc.stderr}")
    return out


def child(tree: Path, stage: int, rows: int, launches: int) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from flowerdiff_torch.kernels import _build
    from flowerdiff_torch.kernels import latent_stage as ls

    lib = ctypes.CDLL(str(build(tree)))
    _build._LIBS["latent_stage"] = lib  # the stamped build in place of the library
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    d, dout = HIDDEN[stage], HIDDEN[stage + 1]
    w = {"wb": r(d, d, scale=d ** -0.5), "wv": r(d, d, scale=d ** -0.5),
         "wo": r(d, d, scale=d ** -0.5), "wd": r(dout, d, scale=d ** -0.5)}
    w = {k: v.to(torch.bfloat16).cuda() for k, v in w.items()}
    for name in ("bb", "b1", "b2", "bv", "bo"):
        w[name] = r(d, scale=0.5).cuda()
    w["g1"], w["g2"] = 1 + r(d, scale=0.2).cuda(), 1 + r(d, scale=0.2).cuda()
    w["bd"] = r(dout, scale=0.5).cuda()
    run = ls.bind_stage(**w)
    plan = run.plan_for(rows)
    h, tc, row = r(rows, d).cuda(), r(rows, d, scale=0.5).cuda(), r(d).cuda()
    for _ in range(20):
        run(h, tc, row)
    torch.cuda.synchronize()
    lib.fd_stage_phases_reset()
    for _ in range(launches):
        run(h, tc, row)
    torch.cuda.synchronize()
    ns = (ctypes.c_ulonglong * MAX_STAMPS)()
    clk = (ctypes.c_ulonglong * MAX_STAMPS)()
    waits = (ctypes.c_ulonglong * 8)()
    count = ctypes.c_ulonglong(0)
    _build.check(lib.fd_stage_phases_read(ns, clk, waits, ctypes.byref(count)), "phase readout")
    n = max(count.value, 1)
    fields = plan._asdict()
    native = "FD_STAMP" in (tree / "src" / "flowerdiff_torch" / "kernels" / "csrc" /
                            "latent_stage.cu").read_text()
    print(json.dumps({"stage": f"{d}->{dout}", "rows": rows, "plan": fields, "launches": n,
                      "native": native,
                      "ns": [v / n for v in ns], "cycles": [v / n for v in clk],
                      "wait_ns": [v / n for v in waits]}), flush=True)


def phase_names(rec: dict):
    """(stamp, name) of each phase this record's kernel stamped."""
    if rec["native"]:
        return WG_PHASES
    if rec["plan"].get("slots", 1) == 0:
        return list(ROWS_PHASES.items())
    return list(enumerate(RING_PHASES, start=1))


def report(tree: Path, rec: dict) -> str:
    ns, cyc = rec["ns"], rec["cycles"]
    lines, prev = [], 0
    for i, name in phase_names(rec):
        if not ns[i]:
            continue
        lines.append(f"{name} {ns[i] - ns[prev]:.0f} ns ({cyc[i] - cyc[prev]:.0f} cyc)")
        prev = i
    waits = [f"{x:.0f}" for x in rec["wait_ns"][:4]]
    return (f"[phases] tree {tree} stage {rec['stage']} B={rec['rows']}: total {ns[prev]:.0f} ns "
            f"({cyc[prev]:.0f} cyc) over {rec['launches']} launches; "
            + "; ".join(lines) + f"; ring waits of the 4 products (ns): {', '.join(waits)}")


def run_tree(tree: Path, launches: int):
    """One process a (stage, rows) of the tree; yields each record and its report."""
    for stage in range(len(HIDDEN) - 1):
        for rows in ROWS:
            out = subprocess.run([sys.executable, __file__, "--child", str(tree), "--stage",
                                  str(stage), "--rows", str(rows), "--launches", str(launches)],
                                 capture_output=True, text=True, timeout=600,
                                 env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise SystemExit(f"stage_phases: tree {tree} failed (exit {out.returncode})")
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    yield rec, report(tree, rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--stage", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rows", type=int, default=16, help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees]
    for tree in trees:
        if tree != _ROOT and _ROOT not in tree.parents:
            raise SystemExit(f"{tree} is not inside the checkout {_ROOT}")
    if args.child:
        child(trees[0], args.stage, args.rows, args.launches)
        return 0
    for tree in trees:
        for rec, text in run_tree(tree, args.launches):
            print(text, flush=True)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

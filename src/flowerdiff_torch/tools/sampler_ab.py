#!/usr/bin/env python3
"""Time the flagship sampling service with its bucket calls as one launch
of the reverse-process kernel against the same calls as a host loop of
launches, in turns, in one process on one CUDA card.

    python3 src/flowerdiff_torch/tools/sampler_ab.py [--rounds 2] [--sweep] [--sweep-nets]

The host loop (`kernels/full_sampler.fused_sample`, 7 launches a step) is
the kernel's oracle and stays in the tree, so both run in one process:
round r runs them in the order (loop, process), the next round (process,
loop), i.e. A B B A for two rounds. A tree before the reverse-process
kernel ran its CUDA-graph replay where this one runs the kernel; to set two
trees side by side, run each tree's own copy of this script in turns.

One `SamplingService` at flagship width (denoiser latent 256, hidden (256,
512, 1024, 512, 256), 102 classes; decoder channels (64, 128, 256, 512);
weights from seeds 0 and 1, the committed z-score stats; CFG 7.0, x0 clip
3.0, 1000 steps, buckets 8 and 64, uint8 images), warmed with `warmup()`.
The loop's turns swap the sampler's `sample` for `fused_sample` on the same
bound kernels. Each turn times, by the host clock around work that ends in
a synchronise:
  - the 50-image request `sample_classes(range(10), 5)` (one 64 bucket:
    128 rows under CFG), three times;
  - one bucket call (`sample` of the sampler: draws, condition rows, the
    1000 steps) at each bucket, three times, with CUDA events around it.
Then, once a path, one profiled bucket call at each bucket (torch.profiler):
wall, device busy and idle share a step; and the kernel path's 64-bucket
chunk split into its parts, each synchronised: the draws and condition rows,
the launch, the decode with quantisation, the copy to the host. With
--sweep, every plan the kernel takes at each bucket (`process_plans`, each
with one operand buffer too) timed between CUDA events, beside the plan's
cost model. With --sweep-nets, the same at the 8 bucket for denoisers past
the flagship's shape (SWEEP_NETS: 63 stages of 256 and 23 of 512, streamed
residual streams, and the flagship's shape with a 3456-wide middle), each
plan's 1000-step call twice. Prints one line a measurement, the card's name
and power limit, and the mean of each measurement over the rounds per path.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_PORT = Path(__file__).resolve().parents[1]
_ROOT = _PORT.parents[1]
sys.path.insert(0, str(_PORT.parent))

from flowerdiff_torch.diffusion import linear_schedule  # noqa: E402
from flowerdiff_torch.kernels.full_sampler import (  # noqa: E402
    ReverseProcess,
    draw_request,
    fused_sample,
    prepare_fused_sampler,
    process_plans,
    process_smem,
    process_step_us,
    process_widths,
)
from flowerdiff_torch.serving import SamplingService  # noqa: E402
from flowerdiff_torch.utils.weights import (  # noqa: E402
    denoiser_from_params,
    init_numpy_params,
    residual_stream,
    vae_from_params,
)

FLAGSHIP = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                num_classes=102, shared_cond_proj=True, global_skip=False)
VAE = dict(latent_dim=256, channels=(64, 128, 256, 512), head_width=512, base_size=8)
STATS = _ROOT / "artifacts" / "flagship_r5b" / "run" / "latent_stats.npz"
GUIDANCE, CLIP, BUCKETS = 7.0, 3.0, (8, 64)
# (latent, hidden) of --sweep-nets
SWEEP_NETS = [(256, (256,) * 64), (512, (512,) * 24), (256, (256, 512, 3456, 512, 256))]


def sweep_net(latent, hidden) -> None:
    """Every plan of the 8 bucket, guided, for one denoiser (a residual
    stream past 8 stages), each plan's 1000-step call timed twice between
    CUDA events after a warm-up, beside its cost model."""
    kw = dict(latent_dim=latent, hidden_dims=hidden, time_emb_dim=64, num_classes=102,
              shared_cond_proj=True, global_skip=False)
    tree = init_numpy_params("denoiser", seed=3, bias_std=0.3, **kw)
    if len(hidden) > 9:
        residual_stream(tree)
    prep = prepare_fused_sampler(denoiser_from_params(tree, device="cuda", **kw),
                                 linear_schedule(1000).to("cuda"))
    process = ReverseProcess(prep)
    gen = torch.Generator(device="cuda").manual_seed(4)
    inputs = draw_request(prep, 8, torch.arange(8, device="cuda") % 102, None, gen, None, True)
    chosen = process.plan_for(8, True)
    plans = process_plans(latent, hidden, False, 8, True)
    for p in list(plans):
        if p.qbufs == 2:
            lat_p, hid_p = process_widths(latent, hidden, p.cols)
            plans.append(p._replace(qbufs=1, smem=process_smem(
                lat_p, hid_p, False, p.cols, p.rows, 1, p.slots, p.streamed)))
    for p in plans:
        run = lambda: process(inputs, clip_x0=CLIP, guidance_scale=GUIDANCE, plan=p)  # noqa: E731
        run()
        ms = [event_ms(run) for _ in range(2)]
        model = p.waves * process_step_us(latent, hidden, False, p)
        print(f"[sampler_ab] sweep-nets: latent {latent}, {len(hidden) - 1} stages, widest "
              f"{max(hidden)}: bucket 8 {p}{' (bound)' if p == chosen else ''}: "
              f"{np.mean(ms):.3f} ms {[round(v, 3) for v in ms]}, cost model {model:.1f} ms",
              flush=True)


def host_loop(inner):
    """`inner.sample` with its bucket calls issued from the host."""
    def sample(batch, *cond, generator=None, x_init=None, stochastic=True):
        return fused_sample(inner._prep, batch, cond[0], cond[1] if len(cond) > 1 else None,
                            generator, x_init, stochastic, inner.clip_x0, inner.guidance_scale)
    return sample


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def event_ms(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profiled(fn):
    """(wall ms, device busy ms) of one call under torch.profiler; only
    DeviceType.CUDA rows count (an aten op's row repeats its kernels')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(fn)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return wall, busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-nets", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sampler_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    stats = np.load(STATS)
    svc = SamplingService(
        denoiser_from_params(init_numpy_params("denoiser", seed=0, **FLAGSHIP), device="cuda",
                             **FLAGSHIP),
        vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cuda", **VAE),
        sched=linear_schedule(1000), buckets=BUCKETS, latent_stats=(stats["mean"], stats["std"]),
        clip_x0=CLIP, guidance_scale=GUIDANCE, quantize_uint8=True, device="cuda")
    inner = svc.sampler._inner
    steps = svc.sched.n_steps
    svc.warmup()
    for b in BUCKETS:  # the loop's first calls outside the timed turns too
        host_loop(inner)(b, torch.zeros(b, dtype=torch.int64, device="cuda"))

    def use(path):
        if path == "loop":
            inner.sample = host_loop(inner)
        else:
            inner.__dict__.pop("sample", None)

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}

    def record(path, what, value):
        results.setdefault((path, what), []).append(value)
        print(f"[sampler_ab] {path}: {what} {value:.3f}", flush=True)

    for rnd in range(args.rounds):
        for path in (("loop", "process") if rnd % 2 == 0 else ("process", "loop")):
            use(path)
            for _ in range(3):
                ms = wall_ms(lambda: svc.sample_classes(range(10), 5, seed=rnd))
                record(path, "50-image request ms", ms)
                record(path, "50-image request images/s", 50e3 / ms)
            for b in BUCKETS:
                cls = torch.arange(b, device="cuda") % FLAGSHIP["num_classes"]
                for _ in range(3):
                    record(path, f"bucket {b} call wall ms",
                           wall_ms(lambda: svc.sampler.sample(b, cls, generator=gen)))
                    record(path, f"bucket {b} call event ms",
                           event_ms(lambda: svc.sampler.sample(b, cls, generator=gen)))
    for path in ("loop", "process"):
        use(path)
        for b in BUCKETS:
            cls = torch.arange(b, device="cuda") % FLAGSHIP["num_classes"]
            wall, busy = profiled(lambda: svc.sampler.sample(b, cls, generator=gen))
            print(f"[sampler_ab] {path}: bucket {b}, one profiled call of {steps} steps: wall "
                  f"{wall:.3f} ms ({wall * 1e3 / steps:.2f} us a step), device busy {busy:.3f} "
                  f"ms ({busy * 1e3 / steps:.2f} us a step), idle share {1 - busy / wall:.4f}",
                  flush=True)

    # the kernel path's 64-bucket chunk, part by part
    use("process")
    cls = torch.arange(64, device="cuda") % FLAGSHIP["num_classes"]
    for _ in range(3):
        parts = {}
        t0 = time.perf_counter()
        inputs = draw_request(inner._prep, 64, cls, None, gen, None, guided=True)
        torch.cuda.synchronize()
        parts["draws and condition rows"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lat = inner.process(inputs, clip_x0=CLIP, guidance_scale=GUIDANCE)
        torch.cuda.synchronize()
        parts["the launch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        imgs = svc._decode(lat * svc.sampler.std + svc.sampler.mean)
        torch.cuda.synchronize()
        parts["denormalise, decode, quantise"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        imgs.cpu().numpy()
        parts["copy to the host"] = time.perf_counter() - t0
        print("[sampler_ab] process: the 64-bucket chunk split, wall ms: " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in parts.items()), flush=True)

    if args.sweep:
        hidden, lat_dim = FLAGSHIP["hidden_dims"], FLAGSHIP["latent_dim"]
        for b in BUCKETS:
            cls = torch.arange(b, device="cuda") % FLAGSHIP["num_classes"]
            inputs = draw_request(inner._prep, b, cls, None, gen, None, guided=True)
            plans = process_plans(lat_dim, hidden, False, b, True)
            plans += [p._replace(qbufs=1, smem=process_smem(lat_dim, hidden, False, p.cols,
                                                            p.rows, 1, p.slots))
                      for p in plans if p.qbufs == 2]
            chosen = inner.process.plan_for(b, True)
            for p in plans:
                run = lambda: inner.process(inputs, clip_x0=CLIP, guidance_scale=GUIDANCE, plan=p)
                run()
                ms = [event_ms(run) for _ in range(2)]
                model = p.waves * process_step_us(lat_dim, hidden, False, p) * steps / 1e3
                print(f"[sampler_ab] sweep: bucket {b} {p}{' (bound)' if p == chosen else ''}: "
                      f"{np.mean(ms):.3f} ms {[round(v, 3) for v in ms]}, cost model "
                      f"{model:.1f} ms", flush=True)

    if args.sweep_nets:
        for latent, hidden in SWEEP_NETS:
            sweep_net(latent, hidden)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[sampler_ab] card: {smi}")
    for (path, what), runs in sorted(results.items()):
        print(f"[sampler_ab] {path}: {what}: mean {np.mean(runs):.3f} "
              f"{[round(v, 3) for v in runs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

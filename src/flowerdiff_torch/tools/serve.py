"""Serve a run directory of the port over HTTP (port of tools/serve.py).

Builds the service from a finished run (`serving.service_from_run`, or
`pixel_service_from_run` for v4/v5: the latest checkpoints, trained first
where the VAE is missing), runs `warmup` over every bucket before the
server binds (on the card: every bucket's plan of the reverse-process
kernel is bound before any request), and serves it through the coalescing front end
(serving_http.py).

    python -m flowerdiff_torch.tools.serve --results_dir results_v1 \\
        --synthetic_size 1020 --port 8000 [--sampler ddim --ddim_steps 50] \\
        [--guidance_scale 7.0] [--buckets 16,64,256]

Then:
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/v1/sample \\
        -d '{"classes": [4, 53], "n_per_class": 5}' > grid.png

It runs on the CUDA card (and raises without one) unless
FLOWERDIFF_PLATFORM=cpu selects the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def ap_default_buckets() -> str:
    return "8,16,32,64,128,256"


def add_service_args(ap: argparse.ArgumentParser) -> None:
    """The flags of the service (those of serving.service_from_run)."""
    ap.add_argument("--results_dir", required=True)
    ap.add_argument("--version", default="v1")
    ap.add_argument("--synthetic_size", type=int, default=1020)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cond_dropout", type=float, default=None,
                    help="must match the training run (affects the checkpoint's tree)")
    ap.add_argument("--ema_decay", type=float, default=None,
                    help="must match the training run; sampling uses EMA")
    ap.add_argument("--guidance_scale", type=float, default=None)
    ap.add_argument("--sampler", default="ancestral", choices=["ancestral", "ddim"])
    ap.add_argument("--ddim_steps", type=int, default=50)
    ap.add_argument("--buckets", default=ap_default_buckets(),
                    help="bucket ladder; pixel presets (v4/v5) default to 4,16,64 unless "
                         "overridden")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--no_quantize", action="store_true",
                    help="keep f32 device->host image transfers (default: uint8 "
                         "quantisation on the device, 4x fewer bytes to the host)")
    ap.add_argument("--decode_bf16", action="store_true",
                    help="run the VAE decoder's convolutions in bf16")


def build_service(args, device=None):
    """The service of `args` on `device` (default: the CLI's, cuda unless
    FLOWERDIFF_PLATFORM=cpu)."""
    from flowerdiff_torch.cli import run_device
    from flowerdiff_torch.serving import pixel_service_from_run, service_from_run

    device = device or run_device()
    buckets = tuple(int(b) for b in args.buckets.split(","))
    quantize = not getattr(args, "no_quantize", False)
    if args.version in ("v4", "v5"):
        return pixel_service_from_run(
            args.results_dir, version=args.version, seed=args.seed, tiny=args.tiny,
            sampler_kind=args.sampler, ddim_steps=args.ddim_steps,
            buckets=buckets if args.buckets != ap_default_buckets() else (4, 16, 64),
            quantize_uint8=quantize, device=device)
    return service_from_run(
        args.results_dir, version=args.version, synthetic_size=args.synthetic_size,
        seed=args.seed, tiny=args.tiny, cond_dropout=args.cond_dropout,
        ema_decay=args.ema_decay, guidance_scale=args.guidance_scale,
        sampler_kind=args.sampler, ddim_steps=args.ddim_steps, buckets=buckets,
        quantize_uint8=quantize, decode_bf16=getattr(args, "decode_bf16", False),
        device=device)


def warm(service, seed: int) -> None:
    """`warmup` of every bucket, with color rows for a v3 model."""
    if getattr(service.model, "num_colors", None) is not None:
        service.warmup(seed, with_colors=True)
    else:
        service.warmup(seed)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_service_args(ap)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--max_batch", type=int, default=512)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    from flowerdiff_torch.data.flowers102 import class_names
    from flowerdiff_torch.serving_http import serve

    service = build_service(args)
    print(f"warming {len(service.buckets)} buckets on {service.device.type}...", flush=True)
    warm(service, args.seed + 99)
    names = class_names() if args.version not in ("v4", "v5") else None
    server = serve(service, args.seed, host=args.host, port=args.port,
                   max_wait_ms=args.max_wait_ms, max_batch=args.max_batch, verbose=True,
                   class_names=names)
    print(f"serving at http://{args.host}:{server.server_address[1]} "
          f"(sampler={args.sampler}, buckets={service.buckets})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.batcher.stop()


if __name__ == "__main__":
    main()

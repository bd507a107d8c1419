"""setup_s (host clock): from the start of the benchmark's process to the
window's start: imports, CUDA's start, the weights, the service, the kernels'
build where it is not yet built, the warm-up of the buckets the cell reaches,
the lead-in traffic."""


def read(ctx):
    return ctx.setup_s

"""padding_share (reverse-process kernel, kernels/full_sampler.ReverseProcess):
the padded rows over the rows launched, in percent, summed over the chunks
(`service.chunk`: bucket less take, over bucket) run inside the traced
stretch (program span; nothing where the program records no span)."""
from portbench.harness import spans


def read(ctx):
    got = spans.in_stretch(ctx, ("service.chunk",))
    if not got:
        return None
    rows = sum(s.attrs["bucket"] for s in got)
    return 100.0 * sum(s.attrs["bucket"] - s.attrs["take"] for s in got) / rows

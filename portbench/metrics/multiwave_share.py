"""multiwave_share (reverse-process kernel, kernels/full_sampler.ReverseProcess):
the share, in percent, of the `sampler.launch` spans run inside the traced
stretch whose plan runs its clusters in two or more waves (`waves`: more
clusters than the card holds at once, so the last wave's clusters run all T
steps on a few SMs). Program span; nothing where the program records no
span or its launches carry no `waves` (a program before the attribute)."""
from portbench.harness import spans


def read(ctx):
    got = spans.in_stretch(ctx, ("sampler.launch",))
    planned = [s for s in got or () if "waves" in s.attrs]
    if not planned:
        return None
    return 100.0 * sum(1 for s in planned if s.attrs["waves"] >= 2) / len(planned)

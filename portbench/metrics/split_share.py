"""split_share (service, serving.SamplingService.sample_async): the share,
in percent, of the `service.sample_async` calls run inside the traced
stretch that `request_plan` cut into two or more chunks: a window past the
ladder's top bucket, which runs a second launch (program span; nothing where
the program records no span)."""
from portbench.harness import spans


def read(ctx):
    got = spans.in_stretch(ctx, ("service.sample_async",))
    if not got:
        return None
    return 100.0 * sum(1 for s in got if s.attrs["chunks"] >= 2) / len(got)

"""copy_wait_ms (service, serving.SamplingService.sample_async): the mean
host ms, per chunk run inside the traced stretch, of its `service.cond_copy`
span: the chunk's copies of classes (and colours, x_init) to the card, which
wait behind queued work where the host memory is pageable (program span;
nothing where the program records no span)."""
from portbench.harness import spans


def read(ctx):
    got = spans.in_stretch(ctx, ("service.chunk", "service.cond_copy"))
    return None if got is None else spans.per_chunk_ms(got, ("service.cond_copy",))

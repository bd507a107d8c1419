"""issue_ms (service, serving.SamplingService.sample_async): the mean host
ms, per chunk run inside the traced stretch, of its spans that enqueue work
for the card: `sampler.draw`, `sampler.cond_rows`, `sampler.launch`,
`service.decode` and `service.to_host`, through which the card may sit idle
(program span; nothing where the program records no span)."""
from portbench.harness import spans

STEPS = ("sampler.draw", "sampler.cond_rows", "sampler.launch", "service.decode",
         "service.to_host")


def read(ctx):
    got = spans.in_stretch(ctx, ("service.chunk",) + STEPS)
    return None if got is None else spans.per_chunk_ms(got, STEPS)

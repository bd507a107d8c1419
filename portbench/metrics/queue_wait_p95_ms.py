"""queue_wait_p95_ms (front end, serving_http.CoalescingBatcher): the 95th
percentile of `batcher.queue`, from a request's `submit` until a window took
it, over the requests taken in the traced stretch (program span; nothing
where the program records no span)."""
from portbench.harness import spans
from portbench.harness.context import percentile


def read(ctx):
    got = spans.in_stretch(ctx, ("batcher.queue",), ended=True)
    return None if not got else percentile([(s.end - s.start) * 1e3 for s in got], 95)

"""latency_p50_ms (host clock): the median latency of the window's
requests, each from when it was sent (closed loop) or due (open loop) until
its images were on the host."""
from portbench.harness.context import percentile


def read(ctx):
    return percentile(ctx.latencies_ms(), 50)

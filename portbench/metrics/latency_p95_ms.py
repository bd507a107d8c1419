"""latency_p95_ms (host clock): the 95th percentile of the same latencies
as latency_p50_ms."""
from portbench.harness.context import percentile


def read(ctx):
    return percentile(ctx.latencies_ms(), 95)

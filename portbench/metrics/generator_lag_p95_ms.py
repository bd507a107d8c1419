"""generator_lag_p95_ms (load generator): the 95th percentile, over the
window's open-loop requests, of how late a client thread took a request up
after it was due. Nothing to read in a closed loop."""
from portbench.harness.context import percentile


def read(ctx):
    lags = [(r.t_send - r.due) * 1e3 for r in ctx.window_requests()
            if r.due is not None and r.t_send is not None]
    return percentile(lags, 95)

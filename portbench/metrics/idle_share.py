"""idle_share (device): the share of the traced stretch in which no
operation ran on the card, in percent. The stretch is a host interval
(harness/trace.py), so idle time at its edges counts."""


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())

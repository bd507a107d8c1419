"""slot_wait_share (front end, serving_http.CoalescingBatcher): the share of
the traced stretch, in percent, that the batcher's worker spent waiting for a
pipeline slot (`batcher.slot_wait`: a window held open while every slot holds
a dispatched window, or a blocked hand-over to the fetching thread). Zero
where it never waited; nothing where the program records no span or no
batcher ran in the stretch."""
from portbench.harness import spans


def read(ctx):
    trace, got = ctx.trace, spans.recorded()
    if trace is None or got is None or trace.window_s() <= 0:
        return None
    if not any(s.name == "batcher.window" and s.end is not None
               and trace.start <= s.start < trace.stop for s in got):
        return None
    waits = [s for s in got if s.name == "batcher.slot_wait" and s.end is not None]
    return 100.0 * spans.overlap_s(waits, trace.start, trace.stop) / trace.window_s()

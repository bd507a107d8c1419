"""images_per_dispatch (front end, serving_http.CoalescingBatcher): the
batcher's own counters, images over dispatches, taken between the window's
edges. Nothing to read where no batcher runs."""


def read(ctx):
    s0, s1 = ctx.run.stats0, ctx.run.stats1
    if s0 is None or s1 is None or s1["dispatches"] == s0["dispatches"]:
        return None
    return (s1["images"] - s0["images"]) / (s1["dispatches"] - s0["dispatches"])

"""process_roofline (reverse-process kernel, csrc/reverse_process.cu's
process_kernel): the bound of every launch in the traced stretch over the
device time of those launches, in percent. A launch's bound is the
benchmark's own (harness/arith.py) at its chunk's bucket, the rows as
launched (padded bucket x copies); its chunk is found from the host time of
the runtime call that launched it, inside one recorded `sample_async`."""
from portbench.harness import arith

KERNEL = "process_kernel"


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    launches = sorted((o for o in trace.ops if KERNEL in o.name and o.launched is not None),
                      key=lambda o: o.launched)
    seen = {}
    bound = busy = 0.0
    for o in launches:
        d = ctx.dispatch_at(o.launched)
        if d is None:
            continue
        k = seen.get(d.index, 0)
        seen[d.index] = k + 1
        if k >= len(d.plan):
            continue
        bound += arith.process_bound_s(ctx.cfg, d.plan[k])
        busy += o.end - o.start
    return 100.0 * bound / busy if busy > 0 else None

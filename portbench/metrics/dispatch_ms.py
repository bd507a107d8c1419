"""dispatch_ms (service, serving.SamplingService.sample_async): the mean
host time of the window's calls, on the benchmark's clock: the draws, the
condition rows, the launch and the decode's enqueue."""


def read(ctx):
    calls = [(d.t_issued - d.t_call) * 1e3 for d in ctx.window_dispatches()
             if d.t_issued is not None]
    return sum(calls) / len(calls) if calls else None

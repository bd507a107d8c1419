"""decode_share (decode, models/vae.Decoder under SamplingService._decode):
the device time of every operation other than the reverse-process kernel
(the decode's convolutions nearly all of it; the draws, quantisation and
copies the rest), as a share of the device's busy time, in percent."""

KERNEL = "process_kernel"


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    busy = trace.busy_s(clip=False)  # whole operations, as the sum below
    if busy <= 0:
        return None
    other = sum(o.end - o.start for o in trace.ops if KERNEL not in o.name)
    return 100.0 * other / busy

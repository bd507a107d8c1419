"""mfu (whole request): the model operations of the images delivered in the
window (the family's `image_flops`; the latent family's, harness/arith.py:
T steps of the denoiser over an image's rows, two when guided, padding not
counted, plus the decoder) over the window's seconds and the bf16 dense
peak, in percent."""
from portbench.harness import arith


def read(ctx):
    flops = ctx.delivered_images() * ctx.family.image_flops(ctx.cfg)
    return 100.0 * flops / (ctx.seconds * arith.BF16_FLOP_PER_S)

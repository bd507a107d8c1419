"""images_per_s (host clock): every image whose request returned inside the
window, over the window's seconds."""


def read(ctx):
    return ctx.delivered_images() / ctx.seconds

"""serve_img_per_s: requests completed over the whole window's seconds."""


def read(ctx):
    w = ctx.window
    return (w.attempted - w.failed) / w.seconds if w.seconds > 0 else None

"""pseudo_points_per_s: points labelled over the whole pass's seconds, the
JSON write included."""


def read(ctx):
    w = ctx.window
    return w.points / w.seconds if w.seconds > 0 and w.points else None

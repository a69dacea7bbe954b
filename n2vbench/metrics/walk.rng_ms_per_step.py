"""Stream ms of the walk's threefry (the port's ``walk.rng`` spans: key
folds and splits, uniforms) in the traced window per superstep dispatched
there (the ``walk.dispatch`` spans' ``supersteps``). Where the host paces
the launches (a superstep a launch set: ``er20-walk-rounds``,
``wec17-walk-fncache``) the stream waits on them inside the span, so this
reads the host's launch pace, not threefry's device work; in
``er20-walk-whole`` the uniforms are one batch and it reads the device's
work."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "walk.rng", "stream_ms", "walk.dispatch",
                     "supersteps")

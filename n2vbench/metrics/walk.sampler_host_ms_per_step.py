"""Host ms of the walk's draw less its RNG (the self time of the port's
``walk.draw`` spans: rows, sampler, step kernel launches) in the traced
window per superstep dispatched there."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "walk.draw", "self_ms", "walk.dispatch",
                     "supersteps")

"""Stream ms of the walks' copy to the host (the port's ``walk.copy``
spans) in the traced window per copy: one a unit."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "walk.copy", "stream_ms", "walk.copy")

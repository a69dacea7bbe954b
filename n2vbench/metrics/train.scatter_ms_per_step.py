"""Stream ms of the gradients' zero fills and scatter-adds (the port's
``train.scatter`` spans) in the traced window per optimizer step taken
there."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.scatter", "stream_ms", "train.round",
                     "steps")

"""Stream ms of dense Adam's update and apply (the port's ``train.adam``
spans) in the traced window per optimizer step taken there."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.adam", "stream_ms", "train.round", "steps")

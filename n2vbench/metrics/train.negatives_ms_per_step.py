"""Stream ms of the negatives' draws (the port's ``train.negatives``
spans) in the traced window per optimizer step taken there (the
``train.round`` spans' ``steps``)."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.negatives", "stream_ms", "train.round",
                     "steps")

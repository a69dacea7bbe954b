"""Stream ms of the row-Adam step's scatter (the port's
``train.rows.scatter`` spans: the row gradients' zero fills and deduped
scatter-adds) in the traced window per optimizer step taken there (the
``train.round`` spans' ``steps``)."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.rows.scatter", "stream_ms", "train.round",
                     "steps")

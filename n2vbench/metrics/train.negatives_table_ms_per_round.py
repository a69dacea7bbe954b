"""Host ms of the negatives' table (the port's ``train.negatives_table``
spans: bincount, Vose, upload) in the traced window per round consumed
there (the ``train.round`` spans' ``rounds``)."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.negatives_table", "host_ms", "train.round",
                     "rounds")

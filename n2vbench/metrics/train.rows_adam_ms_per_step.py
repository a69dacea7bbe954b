"""Stream ms of the row-Adam step's adam (the port's ``train.rows.adam``
spans: lazy Adam on the unique rows and the write-backs of rows and
moments) in the traced window per optimizer step taken there (the
``train.round`` spans' ``steps``)."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.rows.adam", "stream_ms", "train.round",
                     "steps")

"""Stream ms of the row-Adam step's dedup (the port's ``train.rows.dedup``
spans: the batch's sorted unique centre and context/negative rows and
their ``searchsorted`` inverses) in the traced window per optimizer step
taken there (the ``train.round`` spans' ``steps``)."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.rows.dedup", "stream_ms", "train.round",
                     "steps")

"""Stream ms of the row-Adam step's gather (the port's
``train.rows.gather`` spans: the owner gather of the unique rows from
the tables, its sum over the table mesh and the inverse gathers of the
batch's rows) in the traced window per optimizer step taken there (the
``train.round`` spans' ``steps``)."""
from n2vbench import spans


def read(ctx):
    return spans.per(ctx, "train.rows.gather", "stream_ms", "train.round",
                     "steps")

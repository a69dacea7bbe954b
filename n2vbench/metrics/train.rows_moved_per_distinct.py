"""Rows the row-Adam steps move for each row they name: the port's
``train.rows.adam`` spans' ``rows`` (its unique buffers, padding
included) over the rows the traced rounds' steps name, counted by the
benchmark from their ids (``ctx.rows["distinct"]``). 1.0 means no
padding."""
from n2vbench import spans


def read(ctx):
    rows = getattr(ctx, "rows", None)
    sums = spans.in_window(ctx)
    if not rows or not rows["distinct"] or not sums \
            or "train.rows.adam" not in sums:
        return None
    moved = sums["train.rows.adam"].counts.get("rows")
    return None if not moved else moved / rows["distinct"]

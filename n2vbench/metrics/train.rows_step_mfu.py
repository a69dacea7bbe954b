"""The whole row-Adam training step's share of the card's peak: the
larger of a step's counted FLOPs at the float32 peak and its counted bytes
at the HBM rate (``counts/train_rows_step.py``, with the rows the traced
steps name, ``ctx.rows``), over the traced window's time a step (walking
excluded, the round's host work and the negative table included)."""
from n2vbench.counts import train_rows_step


def read(ctx):
    rows = getattr(ctx, "rows", None)
    if ctx.trace is None or ctx.peaks is None or ctx.sgns is None \
            or not ctx.train_steps or not rows or not rows["steps"]:
        return None
    distinct = rows["distinct"] / rows["steps"]
    d, b, k = ctx.sgns["dim"], ctx.sgns["batch"], ctx.sgns["k"]
    bound = max(train_rows_step.flops_per_step(distinct, d, b, k)
                / ctx.peaks["f32_flops"],
                train_rows_step.bytes_per_step(distinct, d, b, k)
                / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / (ctx.trace.window_s / ctx.train_steps)

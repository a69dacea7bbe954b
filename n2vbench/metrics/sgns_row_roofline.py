"""The row entry of ``sgns_fused``'s share of its roofline: the bytes a
launch needs at the trainer's batch (``counts/sgns_row.py``) at the card's
HBM rate, over the kernel's mean time a launch in the trace."""
from n2vbench import profiling
from n2vbench.counts import sgns_row


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.sgns is None:
        return None
    calls, secs = profiling.matching(ctx.trace, "sgns_kernel")
    if calls == 0:
        return None
    need = sgns_row.bytes_per_launch(ctx.sgns["batch"], ctx.sgns["k"],
                                     ctx.sgns["dim"])
    return 100.0 * need / ctx.peaks["hbm_bytes_per_s"] / (secs / calls)

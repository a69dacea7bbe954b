"""``node2vec_step``'s share of its roofline: the bytes a launch needs
(``counts/node2vec_step.py``, over the walks of the traced window) at the
card's HBM rate, over the kernel's mean time a launch in the trace."""
import numpy as np

from n2vbench import profiling
from n2vbench.counts import node2vec_step


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.walk_units:
        return None
    calls, secs = profiling.matching(ctx.trace, "node2vec_step")
    if calls == 0:
        return None
    need = np.mean([node2vec_step.bytes_per_launch(ctx.deg, s, w)
                    for s, w in ctx.walk_units])
    return 100.0 * need / ctx.peaks["hbm_bytes_per_s"] / (secs / calls)

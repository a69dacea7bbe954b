"""Share of the traced walk window in which the device ran nothing: one
less the union of its intervals over the window."""
from n2vbench import profiling


def read(ctx):
    if ctx.trace is None or not ctx.supersteps or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - profiling.busy_seconds(ctx.trace)
                    / ctx.trace.window_s)

"""Device kernels launched in the traced window per walk superstep
dispatched there."""
from n2vbench import profiling


def read(ctx):
    if ctx.trace is None or not ctx.supersteps or not ctx.trace.device:
        return None
    return len(profiling.kernels(ctx.trace)) / ctx.supersteps

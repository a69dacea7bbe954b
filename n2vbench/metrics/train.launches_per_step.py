"""Device kernels launched in the traced training window per optimizer
step taken there."""
from n2vbench import profiling


def read(ctx):
    if ctx.trace is None or not ctx.train_steps or not ctx.trace.device:
        return None
    return len(profiling.kernels(ctx.trace)) / ctx.train_steps

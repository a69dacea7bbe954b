"""Seconds of ``WalkEngine.build`` on the host clock: the device layout
(padded rows, hot set, Vose tables) built from the CSR and uploaded."""


def read(ctx):
    return ctx.layout_build_s

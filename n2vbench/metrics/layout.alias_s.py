"""Seconds of the last ``WalkEngine.build``'s ``layout.alias`` stage, as
the port records it (``repro_torch.tracing``): the host Vose tables of the
padded and hot rows."""
from n2vbench import spans


def read(_ctx):
    return spans.layout_stage_s("layout.alias")

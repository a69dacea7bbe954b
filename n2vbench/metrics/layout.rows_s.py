"""Seconds of the last ``WalkEngine.build``'s ``layout.rows`` stage, as
the port records it (``repro_torch.tracing``): the padded rows and hot rows
packed from the CSR on the host."""
from n2vbench import spans


def read(_ctx):
    return spans.layout_stage_s("layout.rows")

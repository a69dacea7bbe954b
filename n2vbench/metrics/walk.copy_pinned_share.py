"""Share of the walks' copies to the host that landed in page-locked
memory: the port's ``walk.copy`` spans' ``pinned`` counts (1 a pinned
copy, 0 a pageable one) over the spans in the traced window, in %. None
where the spans count no ``pinned`` (the CPU, or a port that copies to
pageable memory only)."""
from n2vbench import spans


def read(ctx):
    sums = spans.in_window(ctx)
    if not sums or "walk.copy" not in sums \
            or "pinned" not in sums["walk.copy"].counts:
        return None
    copy = sums["walk.copy"]
    return 100.0 * copy.counts["pinned"] / copy.spans

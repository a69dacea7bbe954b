"""``walk.copy_pinned_share``, read alike, in the cells that report
``walk_steps_per_s.rounds`` (the rounds pipeline, paced by the host)."""
from n2vbench.harness import reader

read = reader("walk.copy_pinned_share")

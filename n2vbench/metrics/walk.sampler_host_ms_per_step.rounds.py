"""``walk.sampler_host_ms_per_step``, read alike, in the cells that report
``walk_steps_per_s.rounds`` (the rounds pipeline, paced by the host)."""
from n2vbench.harness import reader

read = reader("walk.sampler_host_ms_per_step")

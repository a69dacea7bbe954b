"""The walk engine: ``WalkEngine.build(graph, plan).run(seed=...)``."""
from repro_torch.engine.plan import BACKENDS, WalkPlan, WalkResult, WalkStats
from repro_torch.engine.sampler import Sampler

__all__ = ["BACKENDS", "Sampler", "UpdateReport", "WalkEngine", "WalkPlan",
           "WalkResult", "WalkStats", "round_seed"]


def __getattr__(name):
    # resolved lazily: engine.engine imports core.walk, which imports
    # engine.sampler, so an eager import here would be a cycle
    if name in ("WalkEngine", "round_seed"):
        from repro_torch.engine import engine as _engine
        return getattr(_engine, name)
    if name == "UpdateReport":
        from repro_torch.engine.update import UpdateReport
        return UpdateReport
    raise AttributeError(
        f"module 'repro_torch.engine' has no attribute {name!r}")

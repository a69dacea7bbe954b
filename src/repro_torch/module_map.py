"""Where each module of the JAX package lives in the port.

A module ``src/repro/<path>.py`` lives at ``src/repro_torch/<path>.py``,
the same relative path, unless ``NOT_CARRIED`` gives the reason the port
has no counterpart and needs none. ``MODULE_MAP`` applies that rule to
every ``src/repro/**/*.py`` of this checkout, so a new module of the JAX
package needs no edit here (tests/test_torch_hygiene.py holds both
directions). The port adds modules of its own beside them: ``random.py``
(threefry, bit-exact with ``jax.random``), ``device.py``, ``convert.py``,
``tracing.py`` (its spans and counts) and ``kernels/build.py``.
"""
from pathlib import Path

NOT_CARRIED = {
    "src/repro/kernels/ops.py":
        ("its padding of rows and heads to 128 lanes is a TPU tiling "
         "rule; the port's kernels take the unpadded contract "
         "(kernels/node2vec_step.py, kernels/flash_attention.py)"),
    "src/repro/kernels/ref.py":
        ("each oracle has a plain twin beside its wrapper "
         "(node2vec_step_ref -> kernels/node2vec_step.py "
         "node2vec_step_plain, flash_attention_ref -> "
         "kernels/flash_attention.py flash_attention_plain, "
         "sgns_fused_ref -> kernels/sgns.py sgns_fused_plain)"),
    "src/repro/models/actsharding.py":
        ("its activation constraints steer XLA's GSPMD partitioner; the "
         "port has no partitioner to constrain and its model code calls "
         "no constraint"),
    "src/repro/models/optflags.py":
        ("the port follows REPRO_SEQ_DECODE=1, JAX's default, and reads "
         "no environment"),
}


def counterpart(jax_module: str) -> str:
    """The port module of ``src/repro/<path>.py``, or ``"not carried:
    <reason>"``."""
    if jax_module in NOT_CARRIED:
        return "not carried: " + NOT_CARRIED[jax_module]
    return "src/repro_torch/" + jax_module.removeprefix("src/repro/")


_ROOT = Path(__file__).resolve().parents[2]
MODULE_MAP = {p.relative_to(_ROOT).as_posix():
              counterpart(p.relative_to(_ROOT).as_posix())
              for p in sorted((_ROOT / "src" / "repro").rglob("*.py"))}

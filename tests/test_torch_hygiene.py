"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports JAX or the JAX package, and the entry points refuse to
run without a card unless the caller names the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.graph import CSRGraph, PaddedGraph
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine, WalkPlan

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = {m for m in _imported_roots(path)
           if m in ("jax", "jaxlib", "repro", "flax", "optax")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = CSRGraph.from_edges(4, np.array([0, 1, 2]), np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        PaddedGraph.build(g)
    with pytest.raises(RuntimeError):
        WalkEngine.build("wec:k=5,deg=4", WalkPlan(backend="fused"))
    pg = PaddedGraph.build(g, device="cpu")
    assert pg.device == torch.device("cpu")
    walks = WalkEngine.build(pg, WalkPlan(length=3)).run(seed=0).walks
    assert walks.shape == (4, 3)

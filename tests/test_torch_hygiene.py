"""The port stands alone: no module of src/repro_torch/, not
chip_smoke.py and no script of examples/torch/ imports JAX or the JAX
package, and the entry points refuse to run without a card unless the
caller names the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.graph import CSRGraph, PaddedGraph
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.core.walk_distributed import ShardedGraph
from repro_torch.device import resolve_device
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.train.stream import StreamingSGNSTrainer, train_streamed

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples" / "torch").glob(
        "*.py"))


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


# the modules of the sharded backend and tables, with every other module
# of the port whose file name is a module name
DIST_MODULES = ("repro_torch.core.walk_distributed", "repro_torch.launch.mesh",
                "repro_torch.roofline.traffic", "repro_torch.runtime.balance")
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")
    if p.stem.isidentifier())


def test_port_modules_import_without_jax():
    """Every port module (the sharded backend's among them) imports in a
    fresh interpreter without loading JAX or the JAX package."""
    assert set(DIST_MODULES) <= set(PORT_MODULES)
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout, r.stdout


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WalkEngine.build("wec:k=5,deg=4", WalkPlan(backend="sharded"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedGraph.from_csr(g, 1)
    pg = PaddedGraph.build(g, device="cpu")
    assert pg.device == torch.device("cpu")
    walks = WalkEngine.build(pg, WalkPlan(length=3)).run(seed=0).walks
    assert walks.shape == (4, 3)


def test_serving_entry_points_need_a_card_or_the_cpu(monkeypatch):
    from repro_torch.launch import serve_graph
    from repro_torch.serve import EmbeddingService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.eye(16, 4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingService("wec:k=4,deg=4", emb)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_graph.main(["--smoke", "--requests", "10"])
    svc = EmbeddingService("wec:k=4,deg=4", emb, device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc.embed([1, 2], window=2).shape == (2, 4)


def test_trainer_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Node2VecConfig(walk_length=4, num_walks=1, window=2, dim=4,
                         negatives=1, batch_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSGNSTrainer(16, dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_streamed("wec:k=4,deg=4", cfg)
    emb, st = train_streamed("wec:k=4,deg=4", cfg, device="cpu")
    assert emb.shape == (16, 4) and st.steps > 0

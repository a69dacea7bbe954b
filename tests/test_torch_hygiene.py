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


# the modules this slice added: the dry-run, its sharding rules and
# shape-only meshes, the roofline terms and the module map
DRYRUN_MODULES = ("repro_torch.launch.dryrun", "repro_torch.launch.dryrun_walk",
                  "repro_torch.launch.sharding", "repro_torch.launch.mesh",
                  "repro_torch.roofline.analysis",
                  "repro_torch.roofline.traffic", "repro_torch.module_map")
NOT_CARRIED = {"src/repro/kernels/ops.py", "src/repro/kernels/ref.py",
               "src/repro/models/actsharding.py",
               "src/repro/models/optflags.py"}


def test_dryrun_modules_are_port_modules():
    assert set(DRYRUN_MODULES) <= set(PORT_MODULES)
    for m in DRYRUN_MODULES:
        path = ROOT / "src" / (m.replace(".", "/") + ".py")
        assert path in PORT_FILES


def test_module_map_covers_the_jax_package():
    """Every ``src/repro/**/*.py`` maps to a port module that exists, or
    to "not carried: <reason>"; exactly the four TPU- and XLA-only modules
    are not carried."""
    from repro_torch.module_map import MODULE_MAP
    jax_files = {p.relative_to(ROOT).as_posix()
                 for p in (ROOT / "src" / "repro").rglob("*.py")}
    assert set(MODULE_MAP) == jax_files
    skipped = {k for k, v in MODULE_MAP.items()
               if v.startswith("not carried: ")}
    assert skipped == NOT_CARRIED
    for k, v in MODULE_MAP.items():
        if k in skipped:
            assert len(v) > len("not carried: ") + 20, k
        else:
            assert (ROOT / v).is_file(), (k, v)
            assert v.startswith("src/repro_torch/"), v


def test_dryrun_entry_points_need_no_card(monkeypatch, tmp_path, capsys):
    """The dry-runs touch no device: they run, and put nothing on a card,
    where none is present."""
    from repro_torch.launch import dryrun, dryrun_walk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path / "lm")
    monkeypatch.setattr(dryrun_walk, "ART_DIR", tmp_path / "walk")
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k"]) \
        == 0
    assert dryrun_walk.main(["--cell", "fn_cache"]) == 0
    out = capsys.readouterr().out
    assert "bottleneck=" in out and "fn_cache" in out
    assert (tmp_path / "lm" / "mamba2-370m__decode_32k__pod16x16.json"
            ).is_file()
    assert (tmp_path / "walk" / "fn_cache.json").is_file()


def test_zero_memory_needs_a_card_or_the_cpu(monkeypatch):
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("seamless-m4t-medium")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.zero_memory(cfg, 2)
    assert M.zero_memory(cfg, 2, "cpu")["frames"].device.type == "cpu"

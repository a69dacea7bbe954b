"""Whole walks of the port's WalkEngine against repro.engine.WalkEngine
under the same plan and seed: reference and fused backends in all three
modes, the whole-walk kernel path (fused + pipeline), FN-Multi rounds, and
walks over a layout carried across from the JAX package."""
import jax
import numpy as np
import pytest
import torch

from repro.core.graph import PaddedGraph as JaxPaddedGraph
from repro.data import open_graph as jax_open_graph
from repro.engine import WalkEngine as JaxEngine
from repro.engine import WalkPlan as JaxPlan
from repro_torch.convert import key_from_numpy, padded_graph_from_numpy
from repro_torch.core.graph import FIELDS
from repro_torch.core.walk import run_reference
from repro_torch.engine import WalkEngine, WalkPlan, round_seed

SKEW = "skew:s=4,k=9,deg=20,seed=3"      # 512 vertices, skewed degrees
SMALL = "wec:k=8,deg=12,seed=1"          # 256 vertices

_JAX_WALKS: dict = {}


def _jax_walks(spec, seed, **kw):
    """JAX reference-backend walks, cached per (spec, plan, seed)."""
    key = (spec, seed, tuple(sorted(kw.items())))
    if key not in _JAX_WALKS:
        eng = JaxEngine.build(jax_open_graph(spec).graph,
                              JaxPlan(backend="reference", **kw))
        _JAX_WALKS[key] = eng.run(seed=seed).walks
    return _JAX_WALKS[key]


@pytest.mark.parametrize("mode", ["exact", "approx", "approx_always"])
@pytest.mark.parametrize("backend,pipeline", [("reference", False),
                                              ("fused", False),
                                              ("fused", True)])
def test_walks_match_jax(mode, backend, pipeline):
    """FN-Cache layout (cap=24): every backend and mode equals the JAX
    package's walks integer for integer."""
    kw = dict(p=0.5, q=2.0, length=8, mode=mode, approx_eps=5e-2, cap=24)
    eng = WalkEngine.build(SKEW, WalkPlan(backend=backend,
                                          pipeline=pipeline, **kw),
                           device="cpu")
    assert not eng._fused_persistent()        # hot set: per-step path
    res = eng.run(seed=11)
    assert res.walks.dtype == np.int32
    assert np.array_equal(res.walks, _jax_walks(SKEW, 11, **kw))
    assert res.stats.backend == backend and res.stats.supersteps == 8


@pytest.mark.parametrize("wk,length", [(32, 8), (7, 5), (5, 2), (9, 1)])
def test_fused_persistent_matches_jax(wk, length):
    """fused + pipeline on FN-Base runs the whole-walk kernel path; walks
    equal the JAX reference for odd walker counts and short walks."""
    kw = dict(p=0.5, q=2.0, length=length)
    eng = WalkEngine.build(SMALL, WalkPlan(backend="fused", pipeline=True,
                                           **kw), device="cpu")
    assert eng._fused_persistent() == (length >= 2)
    starts = ((np.arange(wk) * 3) % eng.n).astype(np.int32)
    wid = np.arange(wk, dtype=np.int32)
    got = eng.run(starts=starts, seed=11, walker_ids=wid).walks
    jeng = JaxEngine.build(jax_open_graph(SMALL).graph,
                           JaxPlan(backend="reference", **kw))
    want = jeng.run(starts=starts, seed=11, walker_ids=wid).walks
    assert np.array_equal(got, want)


def test_fn_base_exact_all_backends_match_jax():
    kw = dict(p=0.5, q=2.0, length=10)
    want = _jax_walks(SMALL, 3, **kw)
    for backend, pipeline in [("reference", False), ("fused", False),
                              ("fused", True)]:
        eng = WalkEngine.build(SMALL, WalkPlan(backend=backend,
                                               pipeline=pipeline, **kw),
                               device="cpu")
        assert np.array_equal(eng.run(seed=3).walks, want), backend


def test_rounds_match_jax():
    kw = dict(p=1.0, q=0.5, length=6, cap=24, mode="approx",
              approx_eps=5e-2)
    eng = WalkEngine.build(SKEW, WalkPlan(backend="fused", **kw),
                           device="cpu")
    jeng = JaxEngine.build(jax_open_graph(SKEW).graph,
                           JaxPlan(backend="reference", **kw))
    got = [r.walks for r in eng.rounds(2, seed=7)]
    want = [r.walks for r in jeng.rounds(2, seed=7)]
    assert len(got) == 2 and not np.array_equal(got[0], got[1])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(got[1], eng.run(seed=round_seed(7, 1)).walks)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_held_rounds_stay_equal_to_fresh_runs(backend):
    """Arrays yielded by ``rounds()`` and held across the later rounds keep
    their walks: no later round writes into a held round's memory."""
    kw = dict(p=1.0, q=0.5, length=6, cap=24, mode="approx",
              approx_eps=5e-2)
    eng = WalkEngine.build(SKEW, WalkPlan(backend=backend, **kw),
                           device="cpu")
    held = [r.walks for r in eng.rounds(4, seed=7)]
    assert len({w.tobytes() for w in held}) == 4
    for r, walks in enumerate(held):
        assert np.array_equal(walks, eng.run(seed=round_seed(7, r)).walks)


def test_walks_over_carried_layout_match_jax():
    """A layout and a key carried across from the JAX package give the
    JAX package's walks."""
    kw = dict(p=0.5, q=2.0, length=7, mode="approx_always", cap=24)
    jpg = JaxPaddedGraph.build(jax_open_graph(SKEW).graph, cap=24)
    pg = padded_graph_from_numpy({f: np.asarray(getattr(jpg, f))
                                  for f in FIELDS}, jpg.n, jpg.cap,
                                 jpg.hot_cap, device="cpu")
    want = JaxEngine.build(jpg, JaxPlan(backend="reference", **kw)) \
        .run(seed=5).walks
    got = WalkEngine.build(pg, WalkPlan(backend="fused", **kw)).run(seed=5)
    assert np.array_equal(got.walks, want)
    starts = torch.arange(pg.n, dtype=torch.int32)
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(5)))
    walks = run_reference(pg, starts, starts.long(), key,
                          WalkPlan(**kw).sampler(), 7)
    assert np.array_equal(walks.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_reference_backend_reads_clamped_rows(mode, backend):
    """Walkers starting at PAD_ID, n or n + 5 read row n - 1 for every
    field (deg, the hot position, the alias and weight rows), as the JAX
    package's clamped gathers do, and so walk on from a neighbour of n - 1;
    the JAX package's run_reference gives the same walks. FN-Cache layout,
    so the hot cache is read too."""
    from repro.core.walk import run_reference as jax_run_reference
    kw = dict(p=0.5, q=2.0, length=6, mode=mode, approx_eps=5e-2, cap=24)
    jpg = JaxPaddedGraph.build(jax_open_graph(SKEW).graph, cap=24)
    pg = padded_graph_from_numpy({f: np.asarray(getattr(jpg, f))
                                  for f in FIELDS}, jpg.n, jpg.cap,
                                 jpg.hot_cap, device="cpu")
    n = pg.n
    starts = np.array([2147483647, n, n + 5, 0, 7, n - 1], np.int32)
    wid = np.arange(len(starts), dtype=np.int32)
    want = np.asarray(jax_run_reference(
        jpg, jax.numpy.asarray(starts), jax.numpy.asarray(wid),
        jax.random.PRNGKey(4), JaxPlan(**kw).sampler(), 6))
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(4)))
    got = run_reference(pg, torch.from_numpy(starts), torch.from_numpy(
        wid).long(), key, WalkPlan(backend=backend, **kw).sampler(), 6)
    assert np.array_equal(got.numpy(), want)
    assert (want[:3] < n).all()


def test_sharded_backend_not_ported():
    """The sharded backend builds and walks (a world of one here; the
    2-process world is tests/test_torch_walk_distributed.py) and equals
    the JAX package's walks; bad backends and capacities are refused."""
    kw = dict(p=0.5, q=2.0, length=8, cap=24)
    eng = WalkEngine.build(SKEW, WalkPlan(backend="sharded", **kw),
                           device="cpu")
    assert (eng.mesh.size, eng.capacity) == (1, 512)
    res = eng.run(seed=3)
    assert np.array_equal(res.walks, _jax_walks(SKEW, 3, **kw))
    assert (res.stats.backend, res.stats.dropped,
            res.stats.collective_bytes) == ("sharded", 0, 0)
    with pytest.raises(ValueError):
        WalkPlan(backend="nope")
    for bad in (0, -1, "many", 1.5):
        with pytest.raises(ValueError, match="capacity"):
            WalkPlan(backend="sharded", capacity=bad)

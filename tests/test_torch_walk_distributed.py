"""The port's sharded (Pregel) walk backend against the JAX package's, on
the CPU: the range-partitioned layout field by field, the request
bucketing, hot lookup and serving exactly, the traffic models and the
balance report, and whole walks of a 2-process gloo world integer for
integer against JAX's reference backend (and, at capacity 1, against its
sharded backend on 2 fake devices, drops included)."""
import os
import subprocess
import sys
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import walk_distributed as JW
from repro.core.graph import PaddedGraph as JPaddedGraph
from repro.data import open_graph as j_open_graph
from repro.engine import WalkEngine as JEngine
from repro.engine import WalkPlan as JPlan
from repro.roofline import traffic as JT
from repro.runtime.balance import shard_balance as j_shard_balance
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import walk_distributed as W
from repro_torch.core.graph import PAD_ID, PaddedGraph
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.store import open_graph
from repro_torch.engine import WalkEngine, WalkPlan, round_seed
from repro_torch.roofline import traffic as T
from repro_torch.runtime.balance import shard_balance
from repro_torch.runtime.fault_tolerance import elastic_restart

from torch_world import World

SPEC = "wec:k=8,deg=12,seed=1"        # 256 vertices
SKEW = "skew:s=4,k=9,deg=20,seed=3"   # 512 vertices, skewed
KW = dict(p=0.5, q=2.0, length=10, approx_eps=5e-2)
H100 = dict(peak_flops=T.H100_F32_FLOPS, hbm_bw=T.H100_HBM_BW,
            link_bw=T.H100_NVLINK_BW)


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


@pytest.fixture(scope="module")
def graph():
    return open_graph(SPEC).graph


# ------------------------------------------------------------ layout --
@pytest.mark.parametrize("spec,cap", [(SPEC, None), (SPEC, 16), (SKEW, 24),
                                      (SPEC, 10_000)])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_layout_matches_jax_field_by_field(spec, cap, shards):
    """``sharded_arrays`` == JAX's ``ShardedGraph.from_csr`` (3 shards pad
    the rows; cap 10,000 leaves no hot set: the sentinel), each rank's
    ``from_csr`` and ``build`` == its block of JAX's arrays."""
    g = open_graph(spec).graph
    want = JW.ShardedGraph.from_csr(j_open_graph(spec).graph, shards,
                                    cap=cap)
    got = W.sharded_arrays(g, shards, cap=cap)
    assert (got["n"], got["n_orig"], got["cap"], got["hot_cap"]) == \
        (want.n, want.n_orig, want.cap, want.hot_cap)
    fields = W.ROW_FIELDS + W.HOT_FIELDS
    for k in fields:
        assert np.array_equal(got[k], np.asarray(getattr(want, k))), k
    pg = PaddedGraph.build(g, cap=cap, device="cpu")
    jbuilt = JW.ShardedGraph.build(JPaddedGraph.build(
        j_open_graph(spec).graph, cap=cap), shards)
    n_local = want.n // shards
    for r in range(shards):
        rows = slice(r * n_local, (r + 1) * n_local)
        for sg, ref in ((W.ShardedGraph.from_csr(g, shards, cap=cap, rank=r,
                                                 device="cpu"), want),
                        (W.ShardedGraph.build(pg, shards, r), jbuilt)):
            assert (sg.rank, sg.n_local) == (r, n_local)
            for k in fields:
                a = np.asarray(getattr(ref, k))
                assert np.array_equal(getattr(sg, k).numpy(),
                                      a[rows] if k in W.ROW_FIELDS else a), k
    if cap == 10_000:
        assert got["hot_ids"].tolist() == [PAD_ID]


# --------------------------------------------------- the exchange's parts --
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shards,capacity", [(2, 1), (3, 4), (4, 64)])
def test_bucket_requests_matches_jax(seed, shards, capacity):
    rng = np.random.default_rng(seed)
    w = 64
    dest = rng.integers(0, shards, w).astype(np.int32)
    remote = rng.random(w) < 0.7
    v = rng.integers(0, 1000, w).astype(np.int32)
    want = JW._bucket_requests(jnp.asarray(dest), jnp.asarray(remote),
                               jnp.asarray(v), shards, capacity)
    got = W._bucket_requests(torch.from_numpy(dest), torch.from_numpy(remote),
                             torch.from_numpy(v), shards, capacity)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_hot_lookup_and_serve_match_jax(graph):
    jg = JW.ShardedGraph.from_csr(j_open_graph(SPEC).graph, 2, cap=16)
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.integers(0, graph.n, 40), [PAD_ID, 0, 255]]
                       ).astype(np.int32)
    for hot_ids in (np.array(jg.hot_ids), np.array([PAD_ID], np.int32)):
        want = JW._hot_lookup(jnp.asarray(hot_ids), jnp.asarray(v))
        got = W._hot_lookup(torch.from_numpy(hot_ids), torch.from_numpy(v))
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    n_local = jg.n // 2
    for r in range(2):
        sg = W.ShardedGraph.from_csr(graph, 2, cap=16, rank=r,
                                     device="cpu")
        rows = slice(r * n_local, (r + 1) * n_local)
        recv = np.where(rng.random(v.shape) < 0.2, PAD_ID, v).astype(np.int32)
        want = JW._serve_requests(jg, jg.adj[rows], jg.wgt[rows],
                                  jnp.asarray(recv),
                                  jnp.int32(r * n_local))
        got = W._serve_requests(sg, torch.from_numpy(recv), r * n_local)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------ traffic and balance --
@pytest.mark.parametrize("shards,capacity,cap,length", [
    (1, 8, 16, 10), (2, 1, 16, 1), (4, 64, 913, 80), (8, 100, 128, 2)])
@pytest.mark.parametrize("pipeline", [False, True])
def test_traffic_models_match_jax(shards, capacity, cap, length, pipeline):
    assert T.walk_exchange_bytes(shards, capacity, cap) == \
        JT.walk_exchange_bytes(shards, capacity, cap)
    assert T.walk_collective_bytes(shards, capacity, cap, length) == \
        JT.walk_collective_bytes(shards, capacity, cap, length)
    assert T.sgns_exchange_bytes(capacity * 7, cap, shards) == \
        JT.sgns_exchange_bytes(capacity * 7, cap, shards)
    for w in (1, 7, 1024):
        assert T.walk_step_flops(w, cap) == JT.walk_step_flops(w, cap)
        assert T.walk_step_bytes(w, cap) == JT.walk_step_bytes(w, cap)
        for rates in (H100, dict(peak_flops=1e12, hbm_bw=1e11, link_bw=1e9)):
            assert T.walk_overlap_model(
                shards, capacity, cap, length, w, pipeline, width=cap + 3,
                **rates) == JT.walk_overlap_model(
                shards, capacity, cap, length, w, pipeline, width=cap + 3,
                **rates)
    deg = open_graph(SKEW).graph.deg
    for c in (None, 4, 24):
        assert T.walk_auto_capacity(deg, c, shards, 256) == \
            JT.walk_auto_capacity(deg, c, shards, 256)
    assert T.walk_auto_capacity(np.zeros(4), 4, shards, 3) == \
        JT.walk_auto_capacity(np.zeros(4), 4, shards, 3)


@pytest.mark.parametrize("shards,cap", [(1, 16), (2, 16), (3, 24), (8, 4)])
def test_shard_balance_matches_jax(shards, cap):
    got = shard_balance(open_graph(SKEW).graph, shards, cap)
    want = j_shard_balance(j_open_graph(SKEW).graph, shards, cap)
    for k in ("edges_per_shard", "hot_per_shard", "capped_work_per_shard"):
        assert np.array_equal(getattr(got, k), getattr(want, k))
    assert got.to_dict() == want.to_dict()


# ------------------------------------------------ 2-process walks --
@pytest.mark.parametrize("mode", ["exact", "approx", "approx_always"])
@pytest.mark.parametrize("spec,cap", [(SPEC, None), (SPEC, 16), (SPEC, 24),
                                      (SKEW, 24)])
def test_two_rank_walks_match_jax_reference(world, mode, spec, cap):
    """Barrier and pipelined walks of both ranks == JAX's reference
    backend, integer for integer, with no drop at the default capacity."""
    kw = dict(KW, mode=mode, cap=cap)
    want = np.asarray(JEngine.build(j_open_graph(spec).graph, JPlan(**kw))
                      .run(seed=3).walks)
    for pipeline in (False, True):
        for walks, stats, _ in world.run("torch_world:walks", spec,
                                         dict(kw, pipeline=pipeline), 3):
            assert stats.dropped == 0
            assert np.array_equal(walks, want), (mode, cap, pipeline)


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import warnings
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.data import open_graph
    from repro.engine import WalkEngine, WalkPlan
    g = open_graph("{spec}").graph
    mesh = Mesh(np.array(jax.devices()), ("rw",))
    out = {{}}
    for capacity in (1, None):
        for pipeline in (False, True):
            plan = WalkPlan(backend="sharded", capacity=capacity,
                            pipeline=pipeline, cap=16, **{kw})
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = WalkEngine.build(g, plan, mesh=mesh).run(seed=3)
            tag = f"{{capacity}}_{{int(pipeline)}}"
            out["walks_" + tag] = res.walks
            out["stats_" + tag] = np.array([
                res.stats.dropped, res.stats.collective_bytes,
                res.stats.exposed_collective_bytes])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's sharded backend on 2 fake devices (a subprocess: JAX fixes
    its device count when it starts)."""
    out = tmp_path_factory.mktemp("jax2") / "walks.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT.format(spec=SPEC, kw=KW),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("pipeline", [False, True])
def test_capacity_one_drops_match_jax_sharded(world, jax_sharded, pipeline):
    """At one request slot per destination walkers stay put where JAX's
    do: the same walks and the same drop count."""
    tag = f"1_{int(pipeline)}"
    want_stats = jax_sharded["stats_" + tag]
    assert want_stats[0] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = world.run("torch_world:walks", SPEC,
                        dict(KW, cap=16, capacity=1, pipeline=pipeline), 3)
    for walks, stats, capacity in out:
        assert capacity == 1
        assert stats.dropped == want_stats[0]
        assert np.array_equal(walks, jax_sharded["walks_" + tag])


@pytest.mark.parametrize("capacity", [1, None])
@pytest.mark.parametrize("pipeline", [False, True])
def test_walk_stats_bytes_match_jax(world, jax_sharded, capacity, pipeline):
    """``collective_bytes`` equals JAX's; the exposed share is JAX's model
    at the H100's rates (JAX's own stats use the TPU's): equal to JAX's
    in barrier mode, where all of it is exposed."""
    tag = f"{capacity}_{int(pipeline)}"
    _, total, exposed = jax_sharded["stats_" + tag]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        (_, stats, cap_used), _ = world.run(
            "torch_world:walks", SPEC,
            dict(KW, cap=16, capacity=capacity, pipeline=pipeline), 3)
    assert stats.collective_bytes == total > 0
    jg = JW.ShardedGraph.from_csr(j_open_graph(SPEC).graph, 2, cap=16)
    want = JT.walk_overlap_model(2, cap_used, jg.cap, KW["length"],
                                 jg.n // 2, pipeline, width=jg.hot_cap,
                                 **H100)
    assert (stats.exposed_collective_bytes, stats.overlap_efficiency) == \
        (want["exposed_bytes"], want["efficiency"])
    if not pipeline:
        assert stats.exposed_collective_bytes == exposed == total


def test_two_rank_walks_from_given_starts(world, graph):
    """Starts grouped by owner, with walker ids of their own, == the
    reference backend; starts on the wrong rank are refused."""
    starts = np.array([0, 5, 5, 127, 128, 200, 255, 130], np.int32)
    want = WalkEngine.build(SPEC, WalkPlan(cap=16, **KW), device="cpu") \
        .run(starts=starts, seed=9).walks
    for walks, _, _ in world.run("torch_world:walks", SPEC,
                                 dict(KW, cap=16), 9, starts):
        assert np.array_equal(walks, want)
    with pytest.raises(RuntimeError, match="grouped by owning shard"):
        world.run("torch_world:walks", SPEC, dict(KW, cap=16), 9,
                  starts[::-1].copy())


def test_strict_drops_raise_on_every_rank(world):
    with pytest.raises(RuntimeError, match="NEIG requests dropped") as e:
        world.run("torch_world:walks", SPEC,
                  dict(KW, cap=16, capacity=1, strict_drops=True), 3)
    assert "rank 0" in str(e.value) and "rank 1" in str(e.value)


# ------------------------------------------------ update and resume --
@pytest.mark.parametrize("cap,add,cut,relayout", [
    (16, ([3, 130], [200, 7]), False, False),
    (16, ([0] * 40, list(range(60, 100))), False, True),
    (None, ([1], [254]), True, False)])
def test_sharded_update_matches_fresh_build(world, graph, cap, add, cut,
                                            relayout):
    """Walks after ``update()`` on both ranks == a sharded engine built on
    the patched store == the reference backend on it; the report's
    invalidated shards are those of the affected rows (all on a
    relayout)."""
    from repro_torch.data.deltas import DeltaBatch
    remove = ([0], [int(graph.neighbors(0)[0])]) if cut else ([], [])
    kw = dict(KW, cap=cap)
    out = world.run("torch_world:updated_walks", SPEC, kw, add, remove, 5)
    st = open_graph(SPEC)
    patch = st.apply(DeltaBatch.build(add=add, remove=remove))
    want = WalkEngine.build(st, WalkPlan(**kw), device="cpu").run(seed=5)
    for patched, fresh, (re, inv, _, shards) in out:
        assert (re, shards) == (relayout, 2)
        assert inv == (2 if relayout else
                       len(np.unique(patch.affected // 128)))
        assert np.array_equal(patched, fresh)
        assert np.array_equal(patched, want.walks)


def test_world_two_resumed_at_world_one_equals_unbroken(world, tmp_path):
    """Two of four rounds at world 2, then ``elastic_restart`` in a world
    of one (the sharded backend without a group): the rounds equal an
    unbroken run's, checkpointed ones included."""
    cfg_kw = dict(p=0.5, q=2.0, walk_length=6, num_walks=4, cap=16,
                  seed=2, backend="sharded")
    (first, summary), _ = world.run("torch_world:crashed_rounds", SPEC,
                                    cfg_kw, str(tmp_path), 2)
    assert summary["dropped"] == 0 and summary["collective_bytes"] > 0
    cfg = Node2VecConfig(**cfg_kw)
    resumed = elastic_restart(open_graph(SPEC).graph, cfg,
                              Checkpointer(str(tmp_path)), device="cpu")
    assert resumed.completed_rounds() == 2
    assert resumed.engine.mesh.size == 1
    got = list(resumed.rounds())
    plain = WalkEngine.build(SPEC, Node2VecConfig(
        **dict(cfg_kw, backend="reference")).plan(), device="cpu")
    for r in range(4):
        assert np.array_equal(got[r], plain.run(
            seed=round_seed(cfg.seed, r)).walks)
    for a, b in zip(first, got):
        assert np.array_equal(a, b)


def test_resume_at_world_two_needs_one_checkpoint_dir(world, tmp_path):
    """Two of four rounds at world 2, resumed at world 2 from the same
    directory, equal an unbroken run; a rank that reads another directory
    (no checkpoint) makes every rank refuse before it walks."""
    cfg_kw = dict(p=0.5, q=2.0, walk_length=6, num_walks=4, cap=16,
                  seed=3, backend="sharded")
    world.run("torch_world:crashed_rounds", SPEC, cfg_kw, str(tmp_path), 2)
    with pytest.raises(RuntimeError) as err:
        world.run("torch_world:resumed_rounds", SPEC, cfg_kw,
                  str(tmp_path), rank_dirs=True)
    msg = str(err.value)
    assert msg.count("read 0 to 2 completed rounds") == 2, msg
    got = world.run("torch_world:resumed_rounds", SPEC, cfg_kw,
                    str(tmp_path))
    plain = WalkEngine.build(SPEC, Node2VecConfig(
        **dict(cfg_kw, backend="reference")).plan(), device="cpu")
    for done, rounds in got:
        assert done == 2 and len(rounds) == 4
        for r, w in enumerate(rounds):
            assert np.array_equal(w, plain.run(
                seed=round_seed(3, r)).walks)


def test_meshes_reuse_one_group_per_role(world):
    """Every walk mesh (and every sharded engine) goes through one group,
    every table mesh over the same ranks (and the sharded trainer) through
    another; a prefix table mesh has a third, held by rank 0 alone."""
    got = world.run("torch_world:mesh_groups")
    for r, g in enumerate(got):
        assert g["walk_shared"] and g["table_shared"] and g["apart"]
        assert g["prefix"] == (0 if r == 0 else -1, True)


def test_sharded_engine_in_a_world_of_one_matches_jax_reference(graph):
    """Without ``torch.distributed`` the sharded backend is a world of one
    (a 1-device mesh), built from a CSR, a PaddedGraph or a
    ShardedGraph."""
    kw = dict(KW, cap=16, mode="approx")
    want = np.asarray(JEngine.build(j_open_graph(SPEC).graph, JPlan(**kw))
                      .run(seed=4).walks)
    pg = PaddedGraph.build(graph, cap=16, device="cpu")
    sg = W.ShardedGraph.from_csr(graph, 1, cap=16, device="cpu")
    for g in (SPEC, pg, sg):
        eng = WalkEngine.build(g, WalkPlan(backend="sharded", **kw),
                               device=None if g is not SPEC else "cpu")
        assert eng.mesh.size == 1 and eng.mesh.group is None
        assert np.array_equal(eng.run(seed=4).walks, want)
    with pytest.raises(ValueError, match="requires backend='sharded'"):
        WalkEngine.build(sg, WalkPlan(**kw))
    with pytest.raises(ValueError, match="shard 0 of 2"):
        WalkEngine.build(W.ShardedGraph.from_csr(graph, 2, cap=16,
                                                 device="cpu"),
                         WalkPlan(backend="sharded", **kw))
    auto = WalkEngine.build(pg, WalkPlan(backend="sharded", capacity="auto",
                                         **kw))
    assert auto.capacity == JT.walk_auto_capacity(
        graph.deg, 16, 1, graph.n)

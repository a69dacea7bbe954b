"""Incremental device updates: the port's ``engine/update.patch_padded``,
``WalkEngine.update`` and ``WalkRoundRunner.submit_update`` against the JAX
package's on the same graphs and churn batches. Every ``PaddedGraph``
field, the relayout flag, walks, ``UpdateReport`` and ``WalkStats`` must be
equal exactly; walks after an update also equal a fresh rebuild."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.graph import PaddedGraph as JPaddedGraph
from repro.core.node2vec import Node2VecConfig as JConfig
from repro.data import open_graph as j_open_graph
from repro.data.deltas import DeltaBatch as JBatch
from repro.data.deltas import weight_churn, zipf_churn
from repro.engine import WalkEngine as JEngine
from repro.engine import WalkPlan as JPlan
from repro.engine.update import patch_padded as j_patch_padded
from repro.runtime.fault_tolerance import WalkRoundRunner as JRunner
from repro_torch.core.graph import FIELDS, PaddedGraph
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.deltas import DeltaBatch
from repro_torch.data.store import open_graph
from repro_torch.engine import WalkEngine, WalkPlan, round_seed
from repro_torch.engine.update import patch_padded, patch_sharded
from repro_torch.runtime.fault_tolerance import WalkRoundRunner

SMALL = "wec:k=8,deg=12,seed=1"                        # 256 vertices
SKEW = "skew:s=4,k=9,deg=20,seed=3,relabel=degree"     # 512, relabelled
BATCH_FIELDS = ("add_src", "add_dst", "add_wgt", "rem_src", "rem_dst")


def _churn(spec, num_batches, seed, batch_edges=12, **kw):
    """Churn in original ids, generated against a pristine copy."""
    base = spec.split(",relabel")[0]
    return list(zipf_churn(j_open_graph(base).graph, num_batches=num_batches,
                           batch_edges=batch_edges, seed=seed, **kw))


def _weights(spec, num_batches, seed):
    """Weight-only churn among the 64 highest-degree vertices."""
    base = spec.split(",relabel")[0]
    return list(weight_churn(j_open_graph(base).graph,
                             num_batches=num_batches, batch_edges=12,
                             seed=seed, top=64))


def _mine(batches):
    return [DeltaBatch(**{f: getattr(b, f) for f in BATCH_FIELDS})
            for b in batches]


def _same_layout(pg, jpg):
    assert (pg.n, pg.cap, pg.hot_cap) == (jpg.n, jpg.cap, jpg.hot_cap)
    for f in FIELDS:
        x, y = getattr(pg, f).cpu().numpy(), np.asarray(getattr(jpg, f))
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


def _same_update_report(rep, jrep):
    for f in ("version", "relayout", "device_shards",
              "invalidated_device_shards", "hot_rows_updated"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.invalidated_fraction == jrep.invalidated_fraction
    assert np.array_equal(rep.patch.affected, jrep.patch.affected)
    assert rep.patch.delta_edges == jrep.patch.delta_edges


@pytest.mark.parametrize("spec", [SMALL, SKEW])
@pytest.mark.parametrize("cap", [None, 16])
def test_patch_padded_matches_jax(spec, cap):
    """Each batch spliced into both layouts: every field equal to JAX's
    patched layout, the relayout flag and hot-row count equal, and where no
    relayout was needed, equal to a from-scratch build as well. The old
    layout is left as it was."""
    st, jst = open_graph(spec), j_open_graph(spec)
    pg = PaddedGraph.build(st.graph, cap=cap, device="cpu")
    jpg = JPaddedGraph.build(jst.graph, cap=cap)
    flags = []
    # weight churn first (no relayout, hot rows respliced), then mixed churn
    jbatches = _weights(spec, 2, seed=2) + _churn(spec, 3, seed=4)
    for b, jb in zip(_mine(jbatches), jbatches):
        before = {f: getattr(pg, f).clone() for f in FIELDS}
        rep, jrep = st.apply(b), jst.apply(jb)
        new, relayout, hot = patch_padded(pg, st.graph, rep.affected, cap,
                                          None)
        jpg, jrelayout, jhot = j_patch_padded(jpg, jst.graph, jrep.affected,
                                              cap, None)
        assert (relayout, hot) == (jrelayout, jhot)
        _same_layout(new, jpg)
        for f in FIELDS:                 # functional: pg untouched
            assert torch.equal(getattr(pg, f), before[f]), f
        if not relayout:
            _same_layout(new, JPaddedGraph.build(jst.graph, cap=cap))
        flags.append((relayout, hot))
        pg = new
    assert not any(relayout for relayout, _ in flags[:2])
    if cap == 16:                        # the hot rows were respliced
        assert all(hot for _, hot in flags[:2])


def test_patch_padded_relayout_flag_on_hot_membership():
    """A cold vertex grown past cap flips hot membership: both packages
    relayout; a weight-only batch on a hub does not."""
    st, jst = open_graph(SMALL), j_open_graph(SMALL)
    g = st.graph
    v = int(np.argmin(g.deg))
    fresh = [u for u in range(g.n)
             if u != v and u not in set(g.neighbors(v).tolist())][:12]
    hub = int(np.argmax(g.deg))
    nb = g.neighbors(hub)[:4].astype(np.int64)
    cases = [((np.full(12, v), fresh), True),
             ((np.full(4, hub), nb, np.full(4, 1.7, np.float32)), False)]
    for add, want in cases:
        pg = PaddedGraph.build(st.graph, cap=8, device="cpu")
        jpg = JPaddedGraph.build(jst.graph, cap=8)
        rep = st.apply(DeltaBatch.build(add=add))
        jrep = jst.apply(JBatch.build(add=add))
        new, relayout, hot = patch_padded(pg, st.graph, rep.affected, 8,
                                          None)
        jnew, jrelayout, jhot = j_patch_padded(jpg, jst.graph,
                                               jrep.affected, 8, None)
        assert relayout == jrelayout == want
        assert hot == jhot
        _same_layout(new, jnew)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("spec,cap", [(SMALL, None), (SMALL, 8),
                                      (SKEW, 16)])
def test_engine_update_matches_jax_and_rebuild(backend, spec, cap):
    plan = dict(p=0.5, q=2.0, length=8, cap=cap)
    batches = _churn(spec, 3, seed=4)
    eng = WalkEngine.build(spec, WalkPlan(backend=backend, **plan),
                           device="cpu")
    jeng = JEngine.build(spec, JPlan(backend="reference", **plan))
    reports = [eng.update(_mine(batches[:2])), eng.update(_mine(batches[2:]))]
    jreports = [jeng.update(batches[:2]), jeng.update(batches[2])]
    for rep, jrep in zip(reports, jreports):
        _same_update_report(rep, jrep)
    got = eng.run(seed=3)
    want = jeng.run(seed=3)
    assert np.array_equal(got.walks, want.walks)
    _same_layout(eng.pg, jeng.pg)
    st = open_graph(spec)
    st.apply(_mine(batches))
    fresh = WalkEngine.build(st, WalkPlan(backend=backend, **plan),
                             device="cpu").run(seed=3)
    assert np.array_equal(got.walks, fresh.walks)
    for f in ("graph_version", "delta_edges", "invalidated_shard_fraction"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.graph_version == 3


def test_pipeline_walks_after_update_match_jax():
    """fused + pipeline on FN-Base: the whole-walk path reads the spliced
    rows (weight churn: no relayout) and equals JAX's walks."""
    plan = dict(p=0.5, q=2.0, length=8)
    eng = WalkEngine.build(SMALL, WalkPlan(backend="fused", pipeline=True,
                                           **plan), device="cpu")
    jeng = JEngine.build(SMALL, JPlan(backend="reference", **plan))
    batches = _weights(SMALL, 2, seed=3)
    rep = eng.update(_mine(batches))
    jeng.update(batches)
    assert not rep.relayout and eng._fused_persistent()
    assert np.array_equal(eng.run(seed=5).walks, jeng.run(seed=5).walks)


def test_walkstats_stamp_version_and_churn_as_jax():
    plan = dict(length=5, cap=16)
    eng = WalkEngine.build(SMALL, WalkPlan(**plan), device="cpu")
    jeng = JEngine.build(SMALL, JPlan(**plan))
    fields = ("graph_version", "delta_edges", "invalidated_shard_fraction")
    for batches in (None, _churn(SMALL, 2, seed=6), _churn(SMALL, 1, seed=7)):
        if batches is not None:
            eng.update(_mine(batches))
            jeng.update(batches)
        a, b = eng.run(seed=0).stats, jeng.run(seed=0).stats
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
    assert a.graph_version == 3 and a.delta_edges > 0


def test_rounds_stamp_the_version_they_walked():
    """The update snapshot is taken when a round is enqueued: a round in
    flight during update() reports the old version."""
    eng = WalkEngine.build(SMALL, WalkPlan(length=4, cap=16), device="cpu")
    it = eng.rounds(3, seed=1)
    first = next(it)                     # round 1 already enqueued
    eng.update(_mine(_churn(SMALL, 1, seed=2)))
    rest = list(it)
    assert [r.stats.graph_version for r in [first] + rest] == [0, 0, 1]


def test_runner_updates_land_at_round_r_plus_2():
    st = j_open_graph(SMALL)
    g = st.graph
    hub = int(np.argmax(g.deg))
    nb = g.neighbors(hub)[:3].astype(np.int64)
    add = (np.full(3, hub), nb, np.full(3, 2.2, np.float32))
    kw = dict(walk_length=6, num_walks=4, cap=16, seed=3)

    runner = WalkRoundRunner(open_graph(SMALL).graph, Node2VecConfig(**kw),
                             device="cpu")
    it = runner.rounds()
    walks = [next(it)]
    runner.submit_update(DeltaBatch.build(add=add))
    walks.extend(it)
    jrunner = JRunner(g, JConfig(**kw))
    jit = jrunner.rounds()
    jwalks = [next(jit)]
    jrunner.submit_update(JBatch.build(add=add))
    jwalks.extend(jit)

    versions = [runner.round_stats[r].graph_version for r in range(4)]
    assert versions == [jrunner.round_stats[r].graph_version
                        for r in range(4)] == [0, 0, 1, 1]
    assert [r.version for r in runner.update_reports] == [1]
    for a, b in zip(walks, jwalks):
        assert np.array_equal(a, b)
    fresh_st = open_graph(SMALL)
    fresh_st.apply(DeltaBatch.build(add=add))
    fresh = WalkEngine.build(fresh_st, Node2VecConfig(**kw).plan(),
                             device="cpu")
    for r in (2, 3):
        assert np.array_equal(
            walks[r], fresh.run(seed=round_seed(kw["seed"], r)).walks)


def test_update_without_store_and_sharded_raise():
    pg = PaddedGraph.build(open_graph(SMALL).graph, cap=16, device="cpu")
    eng = WalkEngine.build(pg, WalkPlan(length=4, cap=16))
    assert eng.store is None
    with pytest.raises(ValueError, match="GraphStore"):
        eng.update(DeltaBatch.build(add=([0], [1])))
    with pytest.raises(NotImplementedError, match="item 9"):
        patch_sharded(None, None, np.zeros(1, np.int64), 16, None)


def test_empty_update_keeps_the_layout():
    eng = WalkEngine.build(SMALL, WalkPlan(length=4, cap=16), device="cpu")
    pg = eng.pg
    rep = eng.update(DeltaBatch.build())
    assert eng.pg is pg and not rep.relayout and rep.version == 1
    assert dataclasses.asdict(rep)["invalidated_device_shards"] == 0

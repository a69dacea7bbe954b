"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the fused walk backend, the fused streamed SGNS trainer and
LM serving (prefill through ``flash_attention``) on the card against the
CPU.

They skip where no card is present. On a machine with a card (which has
no JAX, so this file imports none and the repository's conftest, which
does, is skipped)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.graph import PAD_ID
from repro_torch.core.walk import unified_row
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch import random as jr
from repro_torch.configs import smoke_config
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.kernels import node2vec_step as K
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain, route)
from repro_torch.models import model as M
from repro_torch.kernels.sgns import (sgns_fused, sgns_fused_plain,
                                      sgns_fused_tables,
                                      sgns_fused_tables_plain)
from repro_torch.train.stream import train_streamed

pytestmark = pytest.mark.cuda


def _load_smoke():
    """chip_smoke.py, whose edge-case inputs of the walk kernels these
    tests share (it imports only the standard library at module level)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _step_inputs(rng, w, d, dp):
    """Sorted candidate rows, prev rows overlapping them, u in the row."""
    deg = rng.integers(1, d + 1, w)
    lane = np.arange(d)[None, :]
    cand = np.sort(rng.integers(0, 1 << 20, (w, d)), axis=1) + np.arange(d)
    cand = np.where(lane < deg[:, None], cand, PAD_ID).astype(np.int32)
    cw = np.where(lane < deg[:, None], rng.random((w, d)) + 0.1,
                  0.0).astype(np.float32)
    pick = cand[np.arange(w)[:, None],
                rng.integers(0, deg[:, None], (w, dp))]
    prev = np.where(rng.random((w, dp)) < 0.5, pick,
                    rng.integers(0, 1 << 20, (w, dp)))
    degp = rng.integers(1, dp + 1, w)
    prev = np.where(np.arange(dp)[None, :] < degp[:, None], prev, PAD_ID)
    prev = np.sort(prev, axis=1).astype(np.int32)
    u = cand[np.arange(w), rng.integers(0, deg)].astype(np.int32)
    return cand, cw, u, prev, rng.random(w).astype(np.float32)


@pytest.mark.parametrize("w,d,dp", [(7, 1, 1), (64, 130, 300),
                                    (4096, 793, 793), (16, 9000, 9000)])
def test_step_kernel_matches_plain(cuda, w, d, dp):
    """The last shape is too wide for shared memory: global scratch."""
    rng = np.random.default_rng(d)
    args = [torch.from_numpy(a).to(cuda) for a in _step_inputs(rng, w, d,
                                                                dp)]
    before = K.node2vec_step.launches
    got = K.node2vec_step(*args, 0.5, 2.0)
    assert K.node2vec_step.launches == before + 1
    assert torch.equal(got, K.node2vec_step_plain(*args, 0.5, 2.0))


EDGE_WIDTHS = list(SMOKE.STEP_EDGE_WIDTHS)


@pytest.mark.parametrize("d", EDGE_WIDTHS)
def test_step_row_entry_matches_plain_at_edges(cuda, d):
    """The live-lane kernel equals the plain version at every width, with
    v's and u's live lengths at block and level edges and rand near 1;
    20,000 searches u's row in place."""
    rng = np.random.default_rng(d)
    w = 3 * len(SMOKE.edge_lives(d))
    cand, live = SMOKE.edge_rows(np, rng, w, d, PAD_ID)
    cw = np.where(cand != PAD_ID, rng.random((w, d)) + 0.1,
                  0.0).astype(np.float32)
    pick = cand[np.arange(w)[:, None],
                rng.integers(0, np.maximum(live, 1)[:, None], (w, d))]
    other, _ = SMOKE.edge_rows(np, rng, w, d, PAD_ID)
    prev = np.sort(np.where(rng.random((w, d)) < 0.5, pick, other),
                   axis=1).astype(np.int32)
    u = cand[np.arange(w), rng.integers(0, np.maximum(live, 1))]
    args = [torch.from_numpy(a).to(cuda) for a in (
        cand, cw, u.astype(np.int32), prev, SMOKE.edge_rand(np, rng, w))]
    before = K.node2vec_step.launches
    got = K.node2vec_step(*args, 0.5, 2.0)
    assert K.node2vec_step.launches == before + 1
    assert torch.equal(got, K.node2vec_step_plain(*args, 0.5, 2.0))


@pytest.mark.parametrize("d", EDGE_WIDTHS)
def test_step_layout_entry_matches_plain_and_row_entry(cuda, d):
    """The layout entry reads v's and u's rows in place: its slots and
    next vertices equal the plain version's (unified_row, exact_slots,
    the gather), and its slots the row entry's on the unified rows; the
    live lengths sit at block and level edges, dead ends included."""
    rng = np.random.default_rng(d + 1)
    pg, rows = SMOKE.edge_layout(np, torch, rng, d, min(d, 40), PAD_ID)
    assert pg.hot_cap == d
    wk = 3 * len(rows)
    v = np.resize(np.arange(len(rows)), wk)
    u = rng.integers(0, len(rows), wk)
    for i in range(0, wk, 3):                    # u in N(v): alpha = 1/p
        if len(rows[v[i]]):
            u[i] = rng.choice(rows[v[i]])
    r = SMOKE.edge_rand(np, rng, wk)
    u, v, r = (torch.from_numpy(a).to(cuda) for a in (
        u.astype(np.int32), v.astype(np.int32), r))
    before = K.node2vec_step.launches
    slot, nxt = K.node2vec_step_layout(pg, u, v, r, 0.5, 2.0)
    assert K.node2vec_step.launches == before + 1
    want = K.node2vec_step_layout_plain(pg, u, v, r, 0.5, 2.0)
    assert torch.equal(slot, want[0]) and torch.equal(nxt, want[1])
    cand, cw, _ = unified_row(pg, v, ("adj", "wgt"))
    prev, _ = unified_row(pg, u, ("adj",))
    assert torch.equal(K.node2vec_step(cand, cw, u, prev, r, 0.5, 2.0), slot)


def _walk_random(n, d, w, steps):
    """A padded random graph of n vertices (degrees uniform in 0..d) and w
    walkers on it."""
    rng = np.random.default_rng(n)
    deg = rng.integers(0, d + 1, n)
    lane = np.arange(d)[None, :]
    adj = np.sort(rng.integers(0, n - d, (n, d)), axis=1) + np.arange(d)
    adj = np.where(lane < deg[:, None], adj, PAD_ID).astype(np.int32)
    wgt = np.where(lane < deg[:, None], rng.random((n, d)) + 0.1,
                   0.0).astype(np.float32)
    return (adj, wgt, deg.astype(np.int32),
            rng.integers(0, n, w).astype(np.int32),
            rng.integers(0, n, w).astype(np.int32),
            rng.random((w, steps)).astype(np.float32))


WALK_RANDOM = [(64, 1, 7, 5), (2048, 147, 4096, 9), (30000, 12000, 8, 3)]


@pytest.mark.parametrize(
    "case", WALK_RANDOM + list(SMOKE.WALK_EDGE_WIDTHS) + ["hub"],
    ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_walk_kernel_matches_plain(cuda, case):
    """The walk kernel equals the plain version on random graphs (n, D, W,
    steps), and at the edge widths with live lengths at block and level
    edges, dead ends, rand at 0 and 1 - 2^-24, W = 4k + 3 and 37 steps, a
    walker from PAD_ID and one whose u0 is past n; 12,000 and 20,000
    search u's row in place. "hub": the walkers that draw PAD_ID at the
    hub stay there."""
    if isinstance(case, tuple):
        arrays = _walk_random(*case)
    elif case == "hub":
        arrays = SMOKE.pad_hub(np, torch)
    else:
        arrays = SMOKE.walk_edge_inputs(np, np.random.default_rng(case),
                                        case, PAD_ID)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    for p, q in [(0.5, 2.0), (1.0, 1.0)]:
        before = K.node2vec_walk.launches
        got = K.node2vec_walk(*args, p, q)
        assert K.node2vec_walk.launches == before + 1
        want = K.node2vec_walk_plain(*args, p, q)
        assert torch.equal(got, want)
        if case == "hub" and p == 1.0:
            assert bool((got[:3] == PAD_ID).all())


@pytest.mark.parametrize("mode,cap,pipeline", [("exact", 24, False),
                                               ("approx", 24, False),
                                               ("exact", None, True)])
def test_fused_walks_on_card_match_cpu(cuda, mode, cap, pipeline):
    kw = dict(p=0.5, q=2.0, length=8, mode=mode, approx_eps=5e-2, cap=cap,
              pipeline=pipeline)
    spec = "skew:s=4,k=9,deg=20,seed=3"
    cpu = WalkEngine.build(spec, WalkPlan(backend="reference", **kw),
                           device="cpu").run(seed=11).walks
    eng = WalkEngine.build(spec, WalkPlan(backend="fused", **kw))
    before = K.node2vec_step.launches + K.node2vec_walk.launches
    assert np.array_equal(eng.run(seed=11).walks, cpu)
    assert K.node2vec_step.launches + K.node2vec_walk.launches > before


CHURN_SPEC = "wec:k=8,deg=12,seed=1"


def _churn_batches(spec):
    """Weight churn among the hubs (no relayout), then mixed churn."""
    from repro_torch.data.deltas import weight_churn, zipf_churn
    from repro_torch.data.store import open_graph
    g = open_graph(spec).graph
    return (list(weight_churn(g, num_batches=2, batch_edges=12, seed=2,
                              top=64))
            + list(zipf_churn(g, num_batches=2, batch_edges=12, seed=4)))


@pytest.mark.parametrize("cap", [None, 16])
def test_patched_layout_on_card_equals_fresh_build(cuda, cap):
    """patch_padded on the card: every field equals a from-scratch build at
    the same store version where no relayout was needed; walks on the fused
    backend after each update equal the CPU reference backend's."""
    from repro_torch.core.graph import FIELDS, PaddedGraph
    from repro_torch.data.store import open_graph
    plan = dict(p=0.5, q=2.0, length=8, cap=cap)
    eng = WalkEngine.build(CHURN_SPEC, WalkPlan(backend="fused", **plan))
    cpu = WalkEngine.build(CHURN_SPEC, WalkPlan(backend="reference", **plan),
                           device="cpu")
    st = open_graph(CHURN_SPEC)
    relayouts = []
    for batch in _churn_batches(CHURN_SPEC):
        rep = eng.update(batch)
        cpu.update(batch)
        st.apply(batch)
        relayouts.append(rep.relayout)
        if not rep.relayout:
            fresh = PaddedGraph.build(st.graph, cap=cap, device=cuda)
            for f in FIELDS:
                assert torch.equal(getattr(eng.pg, f), getattr(fresh, f)), f
        assert np.array_equal(eng.run(seed=3).walks, cpu.run(seed=3).walks)
    assert not any(relayouts[:2])


def test_service_refresh_on_card_equals_a_fresh_service(cuda):
    """EmbeddingService on the fused backend: after each refresh, walk-
    window embeddings on the card equal a service built fresh at the same
    version, and the CPU service's within float rounding."""
    from repro_torch.data.store import open_graph
    from repro_torch.serve import EmbeddingService
    g = open_graph(CHURN_SPEC).graph
    emb = np.random.default_rng(0).normal(size=(g.n, 32)).astype(np.float32)
    kw = dict(plan=WalkPlan(p=0.5, q=2.0, backend="fused", cap=16),
              cache_size=64)
    svc = EmbeddingService(CHURN_SPEC, emb, **kw)
    cpu = EmbeddingService(CHURN_SPEC, emb, device="cpu", **kw)
    nodes = np.arange(0, g.n, 5)[:128]
    batches = _churn_batches(CHURN_SPEC)
    for i, batch in enumerate(batches):
        assert svc.refresh(batch) == cpu.refresh(batch)
        st = open_graph(CHURN_SPEC)
        st.apply(batches[:i + 1])
        fresh = EmbeddingService(st, emb, **kw)
        got = svc.embed(nodes, window=6)
        assert np.array_equal(got, fresh.embed(nodes, window=6))
        np.testing.assert_allclose(got, cpu.embed(nodes, window=6),
                                   rtol=0, atol=1e-6)


def test_walk_kernel_on_patched_fn_base_matches_plain(cuda):
    """fused + pipeline on FN-Base after a weight-churn update: the whole
    walk reads the spliced rows, equal to its plain version and to the CPU
    reference backend."""
    kw = dict(p=0.5, q=2.0, length=12, pipeline=True)
    eng = WalkEngine.build(CHURN_SPEC, WalkPlan(backend="fused", **kw))
    cpu = WalkEngine.build(CHURN_SPEC, WalkPlan(backend="reference", **kw),
                           device="cpu")
    for batch in _churn_batches(CHURN_SPEC)[:2]:
        assert not eng.update(batch).relayout
        cpu.update(batch)
    assert eng._fused_persistent()
    pg = eng.pg
    rng = np.random.default_rng(0)
    u0 = torch.from_numpy(rng.integers(0, pg.n, 1024).astype(np.int32))
    v1 = torch.from_numpy(rng.integers(0, pg.n, 1024).astype(np.int32))
    rand = torch.from_numpy(rng.random((1024, 11)).astype(np.float32))
    args = (pg.adj, pg.wgt, pg.deg, u0.to(cuda), v1.to(cuda), rand.to(cuda))
    before = K.node2vec_walk.launches
    got = K.node2vec_walk(*args, 0.5, 2.0)
    assert K.node2vec_walk.launches == before + 1
    assert torch.equal(got, K.node2vec_walk_plain(*args, 0.5, 2.0))
    assert np.array_equal(eng.run(seed=4).walks, cpu.run(seed=4).walks)


@pytest.mark.parametrize("b,k,d", [(8, 1, 16), (1024, 5, 128),
                                   (3, 12, 300), (256, 40, 64),
                                   (256, 5, 1024)])
def test_sgns_kernel_matches_plain(cuda, b, k, d):
    """K=40 takes two chunks of negatives."""
    rng = np.random.default_rng(b + k + d)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(b, k, d)).astype(np.float32),
        (rng.random(b) > 0.2).astype(np.float32))]
    before = sgns_fused.launches
    got = sgns_fused(*args)
    again = sgns_fused(*args)
    assert sgns_fused.launches == before + 2
    masked = args[3] == 0
    for g, a, w in zip(got, again, sgns_fused_plain(*args)):
        assert torch.equal(g, a)            # deterministic, loss included
        torch.testing.assert_close(g, w, atol=3e-4, rtol=3e-4)
    for g in got[1:]:
        assert bool((g[masked] == 0).all())


@pytest.mark.parametrize("v,b,k,d", [(300, 8, 1, 16), (5000, 1024, 5, 128),
                                     (100, 3, 12, 300), (700, 256, 40, 64),
                                     (300, 256, 5, 1024)])
def test_sgns_tables_entry_equals_old_composition(cuda, v, b, k, d):
    """The table entry reads the rows in place and divides in the kernel:
    the same bits as the gathers, the row entry and the divisions; within
    3e-4 of its plain version, zero grads on masked rows, and the same
    bits again on a second launch."""
    rng = np.random.default_rng(v + b + k + d)
    emb_in, emb_out = (torch.from_numpy(rng.normal(size=(v, d)).astype(
        np.float32)).to(cuda) for _ in range(2))
    center, pos = (torch.from_numpy(rng.integers(0, v, b).astype(
        np.int32)).to(cuda) for _ in range(2))
    negs = torch.from_numpy(rng.integers(0, v, (b, k)).astype(
        np.int32)).to(cuda)
    valid = torch.from_numpy((rng.random(b) > 0.2).astype(
        np.float32)).to(cuda)
    denom = torch.clamp(valid.sum(), min=1.0)
    args = (emb_in, emb_out, center, pos, negs, valid, denom)
    before = sgns_fused.launches
    got = sgns_fused_tables(*args)
    again = sgns_fused_tables(*args)
    old = sgns_fused(emb_in[center.long()], emb_out[pos.long()],
                     emb_out[negs.long()], valid)
    assert sgns_fused.launches == before + 3
    masked = valid == 0
    for g, a, o, w in zip(got, again, old, sgns_fused_tables_plain(*args)):
        assert torch.equal(g, a) and torch.equal(g, o / denom)
        torch.testing.assert_close(g, w, atol=3e-4, rtol=3e-4)
    for g in got[1:]:
        assert bool((g[masked] == 0).all())
    # a kept loss (a trainer's history) must not keep the grads alive
    assert got[0].untyped_storage().nbytes() == 4


def test_sgns_tables_entry_on_two_streams(cuda):
    """Launches on two streams at once each have their own completion
    counter: both give the single-stream bits."""
    rng = np.random.default_rng(5)
    v, b, k, d = 5000, 1024, 5, 128
    emb_in, emb_out = (torch.from_numpy(rng.normal(size=(v, d)).astype(
        np.float32)).to(cuda) for _ in range(2))
    idx = [torch.from_numpy(rng.integers(0, v, shape).astype(
        np.int32)).to(cuda) for shape in (b, b, (b, k))]
    valid = torch.ones(b, dtype=torch.float32, device=cuda)
    args = (emb_in, emb_out, *idx, valid, valid.sum())
    want = sgns_fused_tables(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        outs.append(sgns_fused_tables(*args))
        with torch.cuda.stream(side):
            outs.append(sgns_fused_tables(*args))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for got in outs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_fused_streamed_trainer_on_card_matches_cpu(cuda):
    cfg = Node2VecConfig(p=0.5, q=2.0, walk_length=10, num_walks=2, window=4,
                         dim=16, negatives=3, batch_size=256, seed=0,
                         backend="fused", sgns_backend="fused")
    spec = "wec:k=7,deg=10,seed=1"
    cpu, cpu_st = train_streamed(spec, cfg, device="cpu")
    before = sgns_fused.launches
    card, st = train_streamed(spec, cfg)
    assert sgns_fused.launches - before == st.steps == cpu_st.steps
    np.testing.assert_allclose(card, cpu, rtol=2e-4, atol=2e-4)
    again, _ = train_streamed(spec, cfg)
    assert np.array_equal(card, again)      # deterministic on the card


@pytest.mark.parametrize("b,s,h,kv,dh,window", [
    (2, 128, 4, 2, 32, 0), (2, 256, 4, 1, 32, 64), (1, 96, 3, 3, 16, 0),
    (1, 1, 4, 2, 128, 0), (2, 300, 8, 2, 100, 50), (1, 130, 2, 1, 256, 0)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, b, s, h, kv, dh, window, dtype, tol,
                                    causal):
    rng = np.random.default_rng(s + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, dh)).astype(
        np.float32)).to(cuda, dtype) for n in (h, kv, kv))
    before = flash_attention.launches
    before_tc = flash_attention.launches_tc
    got = flash_attention(q, k, v, window, causal)
    again = flash_attention(q, k, v, window, causal)
    assert flash_attention.launches == before + 2
    assert flash_attention.launches_tc - before_tc == \
        (2 if route(dtype, dh) == "tc" else 0)
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, window, causal).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,kv,dh,window", [
    (2, 200, 16, 2, 64, 0), (2, 200, 16, 2, 128, 96), (1, 4100, 8, 1, 128, 0),
    (1, 4100, 16, 2, 64, 96), (1, 200, 8, 1, 128, 0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_route_matches_plain(cuda, b, s, h, kv, dh, window,
                                               causal):
    """bf16 at the model widths (dh 64, 128) on the tensor-core route:
    ragged S, GQA 8:1, window 96 and not causal, within bf16's 3e-2 of the
    float32 plain version, two launches equal, no SIMT launch."""
    rng = np.random.default_rng(s + dh + window)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, dh)).astype(
        np.float32)).to(cuda, torch.bfloat16) for n in (h, kv, kv))
    before = (flash_attention.launches, flash_attention.launches_tc,
              flash_attention.launches_simt)
    got = flash_attention(q, k, v, window, causal)
    again = flash_attention(q, k, v, window, causal)
    after = (flash_attention.launches, flash_attention.launches_tc,
             flash_attention.launches_simt)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, window, causal).float(), atol=3e-2, rtol=3e-2)


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def _serve_logits(cfg, params, tokens, feed):
    """Prefill 20 tokens, then 8 steps whose input tokens are ``feed``
    [9, B]: the stacked logits on the CPU and the kernel launches at
    prefill, (total, tensor-core, SIMT)."""
    dev = params["embed"]["tok"].device
    count = lambda: (flash_attention.launches, flash_attention.launches_tc,
                     flash_attention.launches_simt)
    before = count()
    logits, caches = M.prefill(cfg, params, {"tokens": tokens.to(dev)},
                               max_len=28)
    launched = tuple(a - b for a, b in zip(count(), before))
    seq = [logits]
    for i in range(8):
        logits, caches = M.serve_step(cfg, params, feed[i].to(dev), 20 + i,
                                      caches)
        seq.append(logits)
    assert tuple(a - b for a, b in zip(count(), before)) == launched
    return torch.stack(seq).float().cpu(), launched


@pytest.mark.parametrize("arch,window", [("yi-6b", 0), ("minitron-4b", 0),
                                         ("yi-6b", 8)])
def test_serving_on_card_matches_cpu(cuda, arch, window):
    """float32 smoke config: prefill launches the kernel once per layer,
    decode never; logits agree with the CPU and greedy tokens are equal.
    The same params in bf16 (head_dim 16) launch only the tensor-core
    route, and the card's bf16 logits stay within twice the distance of
    the CPU's bf16 logits from the CPU's float32 ones (bf16's own error;
    the kernel and cuBLAS round in other places than the plain path)."""
    cfg = dataclasses.replace(smoke_config(arch), window=window)
    params = M.init_params(cfg, jr.PRNGKey(0))
    host = _cpu(params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))
    outs = {}
    for name, p in (("card", params), ("cpu", host)):
        dev = p["embed"]["tok"].device
        before = flash_attention.launches
        logits, caches = M.prefill(cfg, p, {"tokens": tokens.to(dev)},
                                   max_len=28)
        launched = flash_attention.launches - before
        seq = [logits]
        for i in range(8):
            logits, caches = M.serve_step(cfg, p, seq[-1].argmax(-1), 20 + i,
                                          caches)
            seq.append(logits)
        outs[name] = torch.stack(seq).cpu()
        assert launched == (cfg.num_layers if name == "card" else 0)
        assert flash_attention.launches - before == launched
    torch.testing.assert_close(outs["card"], outs["cpu"], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(outs["card"].argmax(-1), outs["cpu"].argmax(-1))

    # bf16, fed the float32 run's greedy tokens, so that a flipped argmax
    # does not change what the later steps see
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    feed = outs["card"].argmax(-1)
    card16, launched = _serve_logits(cfg16, params, tokens, feed)
    assert launched == (cfg.num_layers, cfg.num_layers, 0)
    cpu16, launched = _serve_logits(cfg16, host, tokens, feed)
    assert launched == (0, 0, 0)
    gap_cpu = float((cpu16 - outs["cpu"]).abs().max())
    gap_card = float((card16 - outs["card"]).abs().max())
    assert torch.isfinite(card16).all() and 0 < gap_card <= 2 * gap_cpu

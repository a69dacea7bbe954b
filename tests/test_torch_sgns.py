"""The port's SGNS stage against the JAX package on the CPU: init params,
the fused kernel's plain version, both gradient backends, the optimizers,
the host corpus, and node2vec end to end. Integers are compared exactly,
floats within the stated tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skipgram as jsg
from repro.core.node2vec import Node2VecConfig as JConfig
from repro.core.node2vec import node2vec as j_node2vec
from repro.data import corpus as jcorpus
from repro.data import open_graph as j_open_graph
from repro.kernels.ops import sgns_fused_op
from repro.kernels.ref import sgns_fused_ref
from repro.optim import optimizers as jopt
from repro_torch import random as jr
from repro_torch.convert import adam_state_from_numpy, sgns_params_from_numpy
from repro_torch.core import skipgram as tsg
from repro_torch.core.node2vec import Node2VecConfig, node2vec
from repro_torch.data import corpus as tcorpus
from repro_torch.data.store import open_graph
from repro_torch.kernels.sgns import (sgns_fused, sgns_fused_plain,
                                      sgns_fused_tables,
                                      sgns_fused_tables_plain)
from repro_torch.optim import optimizers as topt

KERNEL_SHAPES = [(8, 1, 16), (64, 5, 32), (100, 8, 128), (512, 5, 200),
                 (3, 12, 300)]


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else x)


def _rows(b, k, d, seed):
    rng = np.random.default_rng(seed)
    ci = rng.normal(size=(b, d)).astype(np.float32)
    po = rng.normal(size=(b, d)).astype(np.float32)
    no = rng.normal(size=(b, k, d)).astype(np.float32)
    valid = (rng.random(b) > 0.2).astype(np.float32)
    return ci, po, no, valid


# ------------------------------------------------------------- init --
@pytest.mark.parametrize("vocab,dim,seed", [(60, 24, 1), (128, 16, 0),
                                            (37, 128, 2 ** 31 + 5)])
def test_init_params_bit_exact(vocab, dim, seed):
    want = jsg.init_params(jsg.SGNSConfig(vocab=vocab, dim=dim),
                           jax.random.PRNGKey(seed))
    got = tsg.init_params(tsg.SGNSConfig(vocab=vocab, dim=dim),
                          jr.PRNGKey(seed))
    for k in ("emb_in", "emb_out"):
        assert got[k].dtype == torch.float32
        assert np.array_equal(_np(got[k]), np.asarray(want[k]))


# ----------------------------------------------------------- kernel --
@pytest.mark.parametrize("b,k,d", KERNEL_SHAPES)
def test_sgns_fused_plain_matches_pallas_and_autodiff(b, k, d):
    args = _rows(b, k, d, b + k + d)
    got = sgns_fused_plain(*map(torch.from_numpy, args))
    jargs = tuple(map(jnp.asarray, args))
    for want in (sgns_fused_op(*jargs), sgns_fused_ref(*jargs)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=3e-4,
                                       rtol=3e-4)
    masked = args[3] == 0
    for g in got[1:]:
        assert np.all(_np(g)[masked] == 0)


def test_sgns_fused_wrapper_on_cpu_runs_plain_and_checks():
    args = [torch.from_numpy(a) for a in _rows(16, 4, 32, 0)]
    before = sgns_fused.launches
    got = sgns_fused(*args)
    assert sgns_fused.launches == before    # no kernel launched on the CPU
    for g, w in zip(got, sgns_fused_plain(*args)):
        assert torch.equal(g, w)
    ci, po, no, valid = args
    with pytest.raises(TypeError):
        sgns_fused(ci.double(), po, no, valid)
    with pytest.raises(ValueError):
        sgns_fused(ci[:, :8], po, no, valid)
    with pytest.raises(ValueError):
        sgns_fused(ci, po, no[:, :0], valid)
    with pytest.raises(ValueError):
        sgns_fused(ci.t().contiguous().t(), po, no, valid)
    with pytest.raises(ValueError):
        sgns_fused(ci, po, no, valid.to("meta"))


# --------------------------------------------------------- backends --
def _batch(rng, vocab, b, k):
    c = rng.integers(0, vocab, b).astype(np.int32)
    return {"center": c, "pos": ((c + 1) % vocab).astype(np.int32),
            "neg": rng.integers(0, vocab, (b, k)).astype(np.int32),
            "valid": (rng.random(b) > 0.2).astype(np.float32)}


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_sgns_grads_match_jax(backend):
    rng = np.random.default_rng(5)
    jparams = jsg.init_params(jsg.SGNSConfig(vocab=60, dim=24),
                              jax.random.PRNGKey(1))
    # a trained-looking emb_out so every term of the grads is live
    jparams["emb_out"] = jnp.asarray(
        rng.normal(size=(60, 24)).astype(np.float32) * 0.3)
    tparams = sgns_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    batch = _batch(rng, 60, 128, 4)
    jloss, jgrads = jsg.sgns_grads(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, backend)
    tloss, tgrads = tsg.sgns_grads(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, backend)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    for k in ("emb_in", "emb_out"):
        np.testing.assert_allclose(_np(tgrads[k]), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vocab,b,k,d", [(60, 128, 4, 24),
                                         (500, 1024, 5, 128),
                                         (40, 33, 40, 16)])
def test_sgns_fused_tables_plain_matches_jax_fused(vocab, b, k, d):
    """The table entry's plain version (rows gathered, the plain kernel,
    every output over denom), scattered into the tables, gives JAX
    sgns_grads(backend="fused")'s loss and grads within 1e-4; the wrapper
    runs it on CPU tensors, launches nothing and checks its inputs."""
    rng = np.random.default_rng(vocab + b)
    jparams = jsg.init_params(jsg.SGNSConfig(vocab=vocab, dim=d),
                              jax.random.PRNGKey(2))
    jparams["emb_out"] = jnp.asarray(
        rng.normal(size=(vocab, d)).astype(np.float32) * 0.3)
    batch = _batch(rng, vocab, b, k)
    jloss, jgrads = jsg.sgns_grads(
        jparams, {k_: jnp.asarray(v) for k_, v in batch.items()}, "fused")
    emb_in, emb_out = (torch.from_numpy(np.array(jparams[n]))
                       for n in ("emb_in", "emb_out"))
    idx = [torch.from_numpy(batch[n]) for n in ("center", "pos", "neg")]
    valid = torch.from_numpy(batch["valid"])
    denom = torch.clamp(valid.sum(), min=1.0)
    before = sgns_fused.launches
    got = sgns_fused_tables(emb_in, emb_out, *idx, valid, denom)
    assert sgns_fused.launches == before
    want = sgns_fused_tables_plain(emb_in, emb_out, *idx, valid, denom)
    composed = sgns_fused_plain(emb_in[idx[0].long()], emb_out[idx[1].long()],
                                emb_out[idx[2].long()], valid)
    for g, w, c in zip(got, want, composed):
        assert torch.equal(g, w) and torch.equal(g, c / denom)
    np.testing.assert_allclose(float(got[0]), float(jloss), rtol=1e-4,
                               atol=1e-4)
    g_in = torch.zeros_like(emb_in).index_add_(0, idx[0].long(), got[1])
    g_out = torch.zeros_like(emb_out).index_add_(0, idx[1].long(), got[2]) \
        .index_add_(0, idx[2].reshape(-1).long(), got[3].reshape(-1, d))
    for g, name in ((g_in, "emb_in"), (g_out, "emb_out")):
        np.testing.assert_allclose(_np(g), np.asarray(jgrads[name]),
                                   rtol=1e-4, atol=1e-4)
    masked = batch["valid"] == 0
    for g in got[1:]:
        assert np.all(_np(g)[masked] == 0)
    with pytest.raises(TypeError):
        sgns_fused_tables(emb_in, emb_out, idx[0].long(), *idx[1:], valid,
                          denom)
    with pytest.raises(ValueError):
        sgns_fused_tables(emb_in, emb_out[:, :8], *idx, valid, denom)
    with pytest.raises(ValueError):
        sgns_fused_tables(emb_in, emb_out, *idx, valid, denom.double())


def test_train_step_fused_matches_jnp_and_jax():
    """Five Adam steps on both backends of both packages from one init."""
    cfg = jsg.SGNSConfig(vocab=60, dim=24, negatives=4)
    rng = np.random.default_rng(3)
    jopt_ = jopt.adam(0.05)
    topt_ = topt.adam(0.05)
    jp = {b: jsg.init_params(cfg, jax.random.PRNGKey(1))
          for b in ("jnp", "fused")}
    js = {b: jopt_.init(p) for b, p in jp.items()}
    tp = {b: tsg.init_params(tsg.SGNSConfig(vocab=60, dim=24, negatives=4),
                             jr.PRNGKey(1)) for b in ("jnp", "fused")}
    ts = {b: topt_.init(p) for b, p in tp.items()}
    for _ in range(5):
        batch = _batch(rng, 60, 128, 4)
        for b in ("jnp", "fused"):
            jp[b], js[b], jl = jsg.train_step(
                jp[b], js[b], {k: jnp.asarray(v) for k, v in batch.items()},
                jopt_, b)
            tp[b], ts[b], tl = tsg.train_step(
                tp[b], ts[b],
                {k: torch.from_numpy(v) for k, v in batch.items()}, topt_, b)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                       atol=1e-4)
    for k in ("emb_in", "emb_out"):
        for b in ("jnp", "fused"):
            np.testing.assert_allclose(_np(tp[b][k]), np.asarray(jp[b][k]),
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(tp["fused"][k]), _np(tp["jnp"][k]),
                                   rtol=1e-4, atol=1e-4)
    assert int(ts["fused"].count) == 5


def test_sgns_grads_rejects_unknown_backend():
    params = tsg.init_params(tsg.SGNSConfig(vocab=8, dim=4), jr.PRNGKey(0))
    batch = {"center": torch.zeros(2, dtype=torch.int32),
             "pos": torch.ones(2, dtype=torch.int32),
             "neg": torch.zeros((2, 1), dtype=torch.int32)}
    with pytest.raises(ValueError):
        tsg.sgns_grads(params, batch, "pallas")


def test_loss_and_normalization_match_jax():
    rng = np.random.default_rng(9)
    tables = {k: rng.normal(size=(40, 8)).astype(np.float32)
              for k in ("emb_in", "emb_out")}
    batch = _batch(rng, 40, 32, 3)
    tparams = sgns_params_from_numpy(tables, device="cpu")
    jparams = {k: jnp.asarray(v) for k, v in tables.items()}
    for valid in (True, False):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        want = jsg.sgns_loss(jparams, jb["center"], jb["pos"], jb["neg"],
                             jb["valid"] if valid else None)
        got = tsg.sgns_loss(tparams, tb["center"].long(), tb["pos"].long(),
                            tb["neg"].long(), tb["valid"] if valid else None)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tsg.serving_table(tparams),
                               jsg.serving_table(jparams), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------- optimizers --
def _carry(state):
    return adam_state_from_numpy(
        {"count": np.asarray(state.count),
         "mu": {k: np.asarray(v) for k, v in state.mu.items()},
         "nu": {k: np.asarray(v) for k, v in state.nu.items()}},
        device="cpu")


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "sgd_momentum"])
def test_optimizer_updates_match_jax(name):
    """Three steps from state carried across from the JAX package."""
    make = {"adam": lambda m: m.adam(0.05),
            "adamw": lambda m: m.adam(0.01, b2=0.95, weight_decay=0.1),
            "sgd": lambda m: m.sgd(0.1),
            "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9)}[name]
    jo, to = make(jopt), make(topt)
    rng = np.random.default_rng(4)
    tables = {"emb_in": rng.normal(size=(20, 6)).astype(np.float32),
              "emb_out": rng.normal(size=(20, 6)).astype(np.float32),
              "bias": rng.normal(size=(6,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in tables.items()}
    js = jo.init(jp)
    # one JAX step first, so the state carried across is not all zeros
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in tables.items()}
    u, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
    jp = jopt.apply_updates(jp, u)
    tp = sgns_params_from_numpy({"emb_in": np.asarray(jp["emb_in"]),
                                 "emb_out": np.asarray(jp["emb_out"])},
                                device="cpu")
    tp["bias"] = torch.from_numpy(np.array(jp["bias"]))
    if name.startswith("adam"):
        ts = _carry(js)
    else:
        ts = to.init(tp)._replace(count=torch.tensor(1, dtype=torch.int32))
        if js.momentum is not None:
            ts = ts._replace(momentum={k: torch.from_numpy(np.array(v))
                                       for k, v in js.momentum.items()})
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in tables.items()}
        u, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                          js, jp)
        jp = jopt.apply_updates(jp, u)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in grads.items()},
                           ts, tp)
        tp = topt.apply_updates(tp, tu)
        for k in tables:
            np.testing.assert_allclose(_np(tu[k]), np.asarray(u[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    assert int(ts.count) == int(js.count) == 4


def test_optimizer_config_identity():
    assert topt.adam(0.1) == topt.adam(0.1)
    assert hash(topt.adam(0.1)) == hash(topt.adam(0.1))
    assert topt.adam(0.1) != topt.adam(0.2)
    assert topt.sgd(0.1) != topt.adam(0.1)
    sched = topt.adam(lambda c: 0.1)
    assert sched == sched and sched != topt.adam(lambda c: 0.1)


def test_adam_state_from_numpy_checks():
    with pytest.raises(ValueError):
        sgns_params_from_numpy({"emb_in": np.zeros((2, 2))}, device="cpu")
    st = adam_state_from_numpy(jopt.adam(0.1).init(
        {"emb_in": jnp.zeros((3, 2))}), device="cpu")
    assert int(st.count) == 0 and st.mu["emb_in"].shape == (3, 2)


# ------------------------------------------------------------ corpus --
@pytest.mark.parametrize("w,l,window,seed", [(1, 2, 1, 0), (4, 8, 3, 1),
                                             (16, 12, 5, 2), (7, 5, 10, 3)])
def test_host_corpus_matches_jax(w, l, window, seed):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, 50, (w, l)).astype(np.int32)
    walks[:, -1] = walks[:, -2]        # dead-end self-loop tails
    for a, b in zip(tcorpus.sgns_pairs(walks, window),
                    jcorpus.sgns_pairs(walks, window)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ts = tcorpus.NegativeSampler(walks, 50)
    js = jcorpus.NegativeSampler(walks, 50)
    assert np.array_equal(ts.prob, js.prob)
    assert np.array_equal(ts.alias, js.alias)
    assert np.array_equal(ts.sample(np.random.default_rng(1), (33, 4)),
                          js.sample(np.random.default_rng(1), (33, 4)))
    got = list(tcorpus.walks_to_sgns_batches(walks, 50, window, 3, 16,
                                             seed=seed, epochs=2))
    want = list(jcorpus.walks_to_sgns_batches(walks, 50, window, 3, 16,
                                              seed=seed, epochs=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("center", "pos", "neg", "valid"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# --------------------------------------------------- node2vec end to end --
def _f1(emb, labels, seed=0):
    """Micro-F1 of a least-squares probe on a 50% split (the scoring of
    benchmarks/bench_accuracy.py)."""
    rng = np.random.default_rng(seed)
    n = emb.shape[0]
    idx = rng.permutation(n)
    tr, te = idx[:n // 2], idx[n // 2:]
    y = np.eye(labels.max() + 1)[labels]
    w, *_ = np.linalg.lstsq(emb[tr], y[tr], rcond=None)
    return float(((emb[te] @ w).argmax(1) == labels[te]).mean())


def test_node2vec_f1_matches_jax():
    spec = "sbm:n=400,c=4,pin=0.06,pout=0.004,seed=1"
    kw = dict(p=1.0, q=0.5, walk_length=20, num_walks=4, window=5, dim=32,
              epochs=2, batch_size=4096, seed=0)
    jds, tds = j_open_graph(spec), open_graph(spec)
    wgt = (np.random.default_rng(0).random(jds.graph.m) * 4 + 0.5).astype(
        np.float32)
    jds.graph.wgt, tds.graph.wgt = wgt, wgt.copy()
    assert np.array_equal(jds.labels, tds.labels)
    j_emb = j_node2vec(jds.graph, JConfig(**kw))
    t_emb = node2vec(tds.graph, Node2VecConfig(**kw), device="cpu")
    assert t_emb.shape == j_emb.shape == (400, 32)
    assert np.all(np.isfinite(t_emb))
    f_j, f_t = _f1(j_emb, jds.labels), _f1(t_emb, tds.labels)
    assert f_t > 0.5, f_t
    assert abs(f_t - f_j) <= 0.02, (f_t, f_j)


def test_node2vec_config_plan():
    cfg = Node2VecConfig(p=0.5, q=2.0, walk_length=7, cap=16, mode="approx",
                         backend="fused", pipeline=True)
    plan = cfg.plan()
    assert (plan.p, plan.q, plan.length, plan.cap, plan.mode, plan.backend,
            plan.pipeline) == (0.5, 2.0, 7, 16, "approx", "fused", True)
    assert Node2VecConfig().plan().backend == "reference"
    sharded = Node2VecConfig(backend="sharded", capacity="auto",
                             strict_drops=True).plan()
    assert (sharded.backend, sharded.capacity, sharded.strict_drops) == \
        ("sharded", "auto", True)
    assert Node2VecConfig().plan(mesh=object()).backend == "sharded"
    assert Node2VecConfig(backend="fused").plan(mesh=object()).backend == \
        "fused"

"""The port's sharded SGNS trainer at one process against the JAX package's
on a 1-device mesh, on the CPU: buffer sizes, lazy row-Adam, the row
grads, the dedup's integer streams, one epoch, and the streamed trainer
(tests/test_train_shard.py's contracts)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alias import build_alias
from repro.core.skipgram import SGNSConfig as JSGNSConfig
from repro.core.skipgram import init_params as j_init_params
from repro.kernels.sgns import sgns_row_grads as j_sgns_row_grads
from repro.launch.mesh import make_table_mesh
from repro.optim.optimizers import adam_rows as j_adam_rows
from repro.roofline.traffic import sgns_exchange_bytes as j_exchange_bytes
from repro.train import StreamingSGNSTrainer as JTrainer
from repro.train import device_negatives as j_negatives
from repro.train import pow2_bucket as j_pow2_bucket
from repro.train import shard_opt_state as j_shard_opt_state
from repro.train import shard_params as j_shard_params
from repro.train import table_rows as j_table_rows
from repro.train import train_epoch_sharded as j_train_epoch_sharded
from repro_torch import random as jr
from repro_torch.kernels.sgns import sgns_row_grads
from repro_torch.optim.optimizers import AdamState, adam, adam_rows
from repro_torch.train.pairs import device_negatives
from repro_torch.roofline.traffic import sgns_exchange_bytes
from repro_torch.train.shard import (pow2_bucket,
                                     table_rows, train_epoch_sharded,
                                     unique_padded, world_shards)
from repro_torch.train.stream import StreamingSGNSTrainer

V, D, B, K, STEPS = 67, 8, 16, 3, 4


@pytest.mark.parametrize("n", [0, 1, 2, 3, 256, 257, 1024, 65536 * 6])
def test_pow2_bucket_matches_jax(n):
    assert pow2_bucket(n) == j_pow2_bucket(n)


@pytest.mark.parametrize("vocab,shards", [(257, 1), (257, 2), (256, 2),
                                          (10, 4), (131_072, 1)])
def test_table_rows_and_exchange_bytes_match_jax(vocab, shards):
    assert table_rows(vocab, shards) == j_table_rows(vocab, shards)
    assert sgns_exchange_bytes(vocab, 128, shards) == \
        j_exchange_bytes(vocab, 128, shards)


@pytest.mark.parametrize("count", [1, 2, 17, 1000])
def test_adam_rows_matches_jax(count):
    rng = np.random.default_rng(count)
    g, mu = (rng.normal(size=(13, 8)).astype(np.float32) for _ in range(2))
    nu = rng.random((13, 8)).astype(np.float32)
    want = j_adam_rows(0.025).update(jnp.asarray(g), (jnp.asarray(mu),
                                                      jnp.asarray(nu)),
                                     jnp.int32(count))
    got = adam_rows(0.025).update(torch.from_numpy(g), (
        torch.from_numpy(mu), torch.from_numpy(nu)),
        torch.tensor(count, dtype=torch.int32))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_adam_rows_schedule_reads_the_previous_count():
    seen = []
    opt = adam_rows(lambda c: seen.append(int(c)) or 0.01)
    z = torch.zeros(2, 3)
    opt.update(z, (z, z), torch.tensor(5, dtype=torch.int32))
    assert seen == [4]
    state = opt.init({"emb_in": z})
    assert int(state.count) == 0 and state.count.dtype == torch.int32


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("b,k,d", [(8, 1, 16), (64, 5, 32), (33, 4, 20)])
def test_sgns_row_grads_match_jax(backend, b, k, d):
    rng = np.random.default_rng(b * k + d)
    ci, po = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    no = rng.normal(size=(b, k, d)).astype(np.float32)
    valid = (rng.random(b) > 0.2).astype(np.float32)
    want = j_sgns_row_grads(*map(jnp.asarray, (ci, po, no, valid)), "jnp")
    got = sgns_row_grads(*map(torch.from_numpy, (ci, po, no, valid)),
                         backend)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_sgns_row_grads_rejects_unknown_backend():
    z = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="jnp|fused"):
        sgns_row_grads(z, z, z[:, None], torch.ones(2), "sharded")


@pytest.mark.parametrize("n,vocab,size,seed", [(1, 5, 1, 0), (16, 5, 16, 1),
                                               (64, 67, 256, 2),
                                               (300, 10_000, 512, 3)])
def test_unique_padded_matches_jnp_unique(n, vocab, size, seed):
    x = np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)
    want = np.asarray(jnp.unique(jnp.asarray(x), size=size,
                                 fill_value=vocab))
    got = unique_padded(torch.from_numpy(x), size, vocab)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    q = np.asarray(jnp.searchsorted(jnp.asarray(want), jnp.asarray(x)))
    assert np.array_equal(torch.searchsorted(got, torch.from_numpy(x)).numpy(),
                          q)


# --------------------------------------------------------- one epoch --
def _epoch_inputs():
    rng = np.random.default_rng(0)
    n = STEPS * B - 5
    c = rng.integers(0, V, STEPS * B).astype(np.int32)
    x = rng.integers(0, V, STEPS * B).astype(np.int32)
    valid = rng.random(STEPS * B) < 0.9
    perm2d = rng.permutation(STEPS * B).astype(np.int32).reshape(STEPS, B)
    prob, alias = build_alias(rng.random(V) + 0.1)
    params = {k: np.asarray(v) for k, v in j_init_params(
        JSGNSConfig(vocab=V, dim=D, negatives=K),
        jax.random.PRNGKey(0)).items()}
    return n, c, x, valid, perm2d, prob, alias, params


def test_sharded_epoch_matches_jax():
    """One sharded epoch on the 1-shard mesh and the port's: each step's
    negatives, unique row sets and inverses exact; tables, moments and
    losses within 2e-4 / 1e-4."""
    n, c, x, valid, perm2d, prob, alias, params = _epoch_inputs()
    u_in, u_out = pow2_bucket(B), pow2_bucket(B * (1 + K))
    mesh = make_table_mesh(max_shards=1)
    jp = j_shard_params({k: jnp.asarray(v) for k, v in params.items()}, V,
                        mesh)
    jp2, js2, jlosses = j_train_epoch_sharded(
        jp, j_shard_opt_state(jp, mesh), *map(jnp.asarray, (
            c, x, valid, perm2d, prob, alias)), jax.random.PRNGKey(3),
        mesh=mesh, opt=j_adam_rows(0.025), negatives=K, backend="jnp",
        n_pairs=n, u_in=u_in, u_out=u_out)

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = adam_rows(0.025)
    state = opt.init(tp)
    kept = {k: t.clone() for k, t in tp.items()}
    p2, s2, losses = train_epoch_sharded(
        tp, state, *map(torch.from_numpy, (c, x, valid, perm2d, prob,
                                           alias)),
        jr.PRNGKey(3), opt=opt, negatives=K, backend="jnp", n_pairs=n,
        u_in=u_in, u_out=u_out)

    for s in range(STEPS):   # the integer streams of each step
        idx = perm2d[s]
        want_neg = np.array(j_negatives(
            jax.random.fold_in(jax.random.PRNGKey(3), s), jnp.asarray(prob),
            jnp.asarray(alias), (B, K))).reshape(-1)
        neg = device_negatives(jr.fold_in(jr.PRNGKey(3), s),
                               torch.from_numpy(prob),
                               torch.from_numpy(alias), (B, K)).reshape(-1)
        assert np.array_equal(neg.numpy(), want_neg)
        ctx = np.concatenate([x[idx], want_neg])
        for ids, size, queries in ((c[idx], u_in, (c[idx],)),
                                   (ctx, u_out, (x[idx], want_neg))):
            ju = jnp.unique(jnp.asarray(ids), size=size, fill_value=V)
            tu = unique_padded(torch.from_numpy(ids), size, V)
            assert np.array_equal(tu.numpy(), np.asarray(ju))
            for q in queries:
                assert np.array_equal(
                    torch.searchsorted(tu, torch.from_numpy(q)).numpy(),
                    np.asarray(jnp.searchsorted(ju, jnp.asarray(q))))
    for k in ("emb_in", "emb_out"):
        np.testing.assert_allclose(p2[k].numpy(), np.asarray(jp2[k]),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(s2.mu[k].numpy(), np.asarray(js2.mu[k]),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(s2.nu[k].numpy(), np.asarray(js2.nu[k]),
                                   rtol=0, atol=2e-4)
        assert torch.equal(tp[k], kept[k])          # inputs not written
        assert not bool(state.mu[k].any()) and not bool(state.nu[k].any())
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0,
                               atol=1e-4)
    assert int(s2.count) == int(js2.count) == STEPS and int(state.count) == 0


def test_sharded_epoch_touches_only_batch_rows():
    n, c, x, valid, perm2d, prob, alias, params = _epoch_inputs()
    c = c % 20                 # centres from rows 0..19 only
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = adam_rows(0.025)
    p2, s2, _ = train_epoch_sharded(
        tp, opt.init(tp), *map(torch.from_numpy, (c, x, valid, perm2d, prob,
                                                  alias)),
        jr.PRNGKey(3), opt=opt, negatives=K, backend="jnp", n_pairs=n,
        u_in=B, u_out=B * (1 + K))
    assert torch.equal(p2["emb_in"][20:], tp["emb_in"][20:])
    assert not bool(s2.mu["emb_in"][20:].any())
    assert bool(s2.mu["emb_in"][:20].any())
    with pytest.raises(ValueError, match="smaller"):
        train_epoch_sharded(
            tp, opt.init(tp), *map(torch.from_numpy, (c, x, valid, perm2d,
                                                      prob, alias)),
            jr.PRNGKey(3), opt=opt, negatives=K, backend="jnp", n_pairs=n,
            u_in=B // 2, u_out=B * (1 + K))


# --------------------------------------------------- streamed trainer --
def _rounds(vocab, n=3, w=32, l=9, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (w, l)).astype(np.int32)
            for _ in range(n)]


KW = dict(dim=16, window=3, negatives=3, batch_size=64, shard_tables=True)


def _trainer(vocab=129, **kw):
    return StreamingSGNSTrainer(vocab, **{**KW, "device": "cpu", **kw})


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_sharded_trainer_matches_jax(backend):
    """Two rounds against JAX's 1-shard trainer (its jnp closed form; the
    fused route is held to it at 2e-5 below), tables within 2e-4."""
    rounds = _rounds(129, n=2)
    jt = JTrainer(129, mesh=make_table_mesh(max_shards=1), **KW)
    jemb, jst = jt.train(iter(rounds))
    tr = _trainer(sgns_backend=backend)
    emb, st = tr.train(iter(rounds))
    np.testing.assert_allclose(emb, np.asarray(jemb), rtol=0, atol=2e-4)
    np.testing.assert_allclose(tr.loss_history(), jt.loss_history(),
                               rtol=0, atol=1e-4)
    for k in ("emb_in", "emb_out"):
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jt.params[k]), rtol=0,
                                   atol=2e-4)
    assert (st.steps, st.pairs, st.shards, st.collective_bytes,
            st.h2d_bytes, st.h2d_bytes_concat) == \
        (jst.steps, jst.pairs, jst.shards, jst.collective_bytes,
         jst.h2d_bytes, jst.h2d_bytes_concat)
    assert st.shards == 1 and st.collective_bytes == 0


def test_sharded_streamed_matches_concat():
    rounds = _rounds(129)
    a = _trainer()
    emb_a, _ = a.train(iter(rounds))
    b = _trainer()
    for r in rounds:
        b.consume(r)
    emb_b, _ = b.finish()
    assert np.array_equal(emb_a, emb_b)
    for k in ("emb_in", "emb_out"):
        assert torch.equal(a.params[k], b.params[k])
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])


def test_sharded_fused_matches_jnp():
    embs = {b: _trainer(sgns_backend=b).train(iter(_rounds(129)))[0]
            for b in ("jnp", "fused")}
    np.testing.assert_allclose(embs["fused"], embs["jnp"], rtol=0,
                               atol=2e-5)


def test_sharded_differs_from_dense():
    """Lazy row-Adam is a different optimizer: not silently dense."""
    sharded = _trainer()
    dense = _trainer(shard_tables=False)
    e_s, _ = sharded.train(iter(_rounds(129)))
    e_d, _ = dense.train(iter(_rounds(129)))
    assert sharded._opt != adam(0.025) and dense._opt == adam(0.025)
    assert np.abs(e_s - e_d).max() > 1e-3


def test_world_larger_than_one_raises(monkeypatch):
    """``world_shards`` is the world's size (a real world of two trains in
    tests/test_torch_dist_train.py); outside a world the trainer holds
    every row."""
    import torch.distributed as dist
    assert world_shards() == 1
    tr = _trainer()
    assert (tr.shards, tr.mesh.size, tr.mesh.group) == (1, 1, None)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    assert world_shards() == 2


def test_opt_state_handed_in_is_unchanged():
    tr = _trainer()
    tr.consume(_rounds(129, n=1)[0])
    before = AdamState(tr.opt_state.count.clone(),
                       {k: v.clone() for k, v in tr.opt_state.mu.items()},
                       {k: v.clone() for k, v in tr.opt_state.nu.items()})
    held = tr.opt_state
    params = {k: v.clone() for k, v in tr.params.items()}
    held_params = tr.params
    tr.consume(_rounds(129, n=1, seed=9)[0])
    assert torch.equal(held.count, before.count)
    for k in ("emb_in", "emb_out"):
        assert torch.equal(held.mu[k], before.mu[k])
        assert torch.equal(held.nu[k], before.nu[k])
        assert torch.equal(held_params[k], params[k])
        assert not torch.equal(tr.params[k], params[k])

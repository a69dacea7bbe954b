"""Port's sampling layer and walk kernels' plain versions against the JAX
package: prefix_sum vs jnp.cumsum, exact slots vs the Pallas step kernel
(interpret mode) and its oracle, alias draws, approx bounds, Sampler.choose.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alias import alias_sample as jax_alias_sample
from repro.core.graph import PAD_ID
from repro.core.transition import approx_gap as jax_approx_gap
from repro.core.transition import unnormalized_probs as jax_probs
from repro.engine.sampler import HotContext as JaxHot
from repro.engine.sampler import Sampler as JaxSampler
from repro.kernels.ops import node2vec_step_op, node2vec_walk_op
from repro.kernels.ref import node2vec_step_ref
from repro_torch.core.alias import alias_sample
from repro_torch.core.transition import approx_gap, unnormalized_probs
from repro_torch.engine.sampler import (HotContext, Sampler, exact_slots,
                                        prefix_sum)
from repro_torch.kernels import node2vec_step as K


def _make_step_inputs(rng, w, d, dp):
    """tests/test_kernels.py's generator: sorted rows, overlapping prev."""
    deg = rng.integers(1, d + 1, w)
    cand = np.full((w, d), PAD_ID, np.int32)
    cw = np.zeros((w, d), np.float32)
    for i in range(w):
        ids = np.sort(rng.choice(10000, size=deg[i], replace=False))
        cand[i, :deg[i]] = ids
        cw[i, :deg[i]] = rng.random(deg[i]).astype(np.float32) + 0.1
    degp = rng.integers(1, dp + 1, w)
    prev = np.full((w, dp), PAD_ID, np.int32)
    for i in range(w):
        pool = np.unique(np.concatenate(
            [cand[i, :deg[i]], rng.choice(10000, size=dp)]))
        ids = np.sort(rng.choice(pool, size=min(degp[i], len(pool)),
                                 replace=False).astype(np.int32))
        prev[i, :len(ids)] = ids
    u = cand[np.arange(w), rng.integers(0, deg)]
    r = rng.random(w).astype(np.float32)
    return cand, cw, u, prev, r


def _walk_graph(rng, n, d):
    deg = rng.integers(0, d + 1, n)
    lane = np.arange(d)[None, :]
    adj = np.sort(rng.integers(0, n - d, (n, d)), axis=1) + np.arange(d)
    adj = np.where(lane < deg[:, None], adj, PAD_ID).astype(np.int32)
    wgt = np.where(lane < deg[:, None], rng.random((n, d)) + 0.1,
                   0.0).astype(np.float32)
    return adj, wgt, deg.astype(np.int32)


@pytest.mark.parametrize("d", [1, 7, 16, 17, 32, 100, 128, 130, 513, 793])
def test_prefix_sum_matches_jnp_cumsum(d):
    """The base-16 blocked scan equals XLA's cumsum bit for bit (a plain
    sequential scan does not from D = 32 up)."""
    rng = np.random.default_rng(d)
    x = (rng.random((257, d)) * rng.choice([0.0, 0.5, 1.0, 2.0, 4.0],
                                           size=(257, d))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    got = prefix_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


STEP_SWEEP = [(w, d, dp, pq) for w, d, dp in
              [(16, 8, 8), (64, 130, 40), (256, 128, 128), (7, 200, 300),
               (33, 64, 1)]
              for pq in [(0.5, 2.0), (2.0, 0.5), (1.0, 1.0)]] + \
    [(w, d, dp, (0.5, 2.0)) for w, d, dp in
     [(1, 1, 1), (1, 40, 40), (64, 1, 40), (64, 40, 1), (2, 3, 5),
      (17, 29, 11), (31, 40, 23), (64, 17, 40), (5, 13, 37), (48, 25, 25)]]


_step_ref = jax.jit(node2vec_step_ref, static_argnums=(5, 6))


@pytest.mark.parametrize("w,d,dp,pq", STEP_SWEEP)
def test_exact_slots_match_step_oracle(w, d, dp, pq):
    """exact_slots and the step kernel's plain version (reached through
    the wrapper with CPU tensors) equal the Pallas kernel's oracle."""
    rng = np.random.default_rng(w * d + dp)
    args = _make_step_inputs(rng, w, d, dp)
    want = np.asarray(_step_ref(*map(jnp.asarray, args), *pq))
    targs = [torch.from_numpy(a) for a in args]
    assert np.array_equal(exact_slots(*targs, *pq).numpy(), want)
    got = K.node2vec_step(*targs, *pq)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    deg = (args[0] != PAD_ID).sum(1)
    assert np.all(got.numpy() < np.maximum(deg, 1))


@pytest.mark.parametrize("w,d,dp", [(7, 200, 300), (64, 130, 40),
                                    (17, 29, 11)])
def test_step_plain_matches_pallas_interpret(w, d, dp):
    """The same slots as the Pallas kernel itself (interpret mode)."""
    rng = np.random.default_rng(w + d + dp)
    args = _make_step_inputs(rng, w, d, dp)
    want = np.asarray(node2vec_step_op(*map(jnp.asarray, args), 0.5, 2.0))
    got = K.node2vec_step(*map(torch.from_numpy, args), 0.5, 2.0)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,w,steps", [(64, 5, 9, 6), (200, 37, 33, 4)])
def test_walk_plain_matches_pallas_walk(n, d, w, steps):
    """node2vec_walk's plain version equals the Pallas whole-walk kernel
    (interpret mode), dead ends included."""
    rng = np.random.default_rng(n + d)
    adj, wgt, deg = _walk_graph(rng, n, d)
    u0 = rng.integers(0, n, w).astype(np.int32)
    v1 = rng.integers(0, n, w).astype(np.int32)
    rand = rng.random((w, steps)).astype(np.float32)
    args = (adj, wgt, deg, u0, v1, rand)
    want = np.asarray(node2vec_walk_op(*map(jnp.asarray, args), 0.5, 2.0))
    got = K.node2vec_walk(*map(torch.from_numpy, args), 0.5, 2.0)
    assert np.array_equal(got.numpy(), want)


def test_unnormalized_probs_match():
    rng = np.random.default_rng(1)
    cand, cw, u, prev, _ = _make_step_inputs(rng, 40, 30, 20)
    for p, q in [(0.5, 2.0), (0.3, 7.0), (1.0, 1.0)]:
        want = np.asarray(jax.vmap(lambda a, b, c, e: jax_probs(
            a, b, c, e, p, q))(*map(jnp.asarray, (cand, cw, u, prev))))
        got = unnormalized_probs(*map(torch.from_numpy, (cand, cw, u, prev)),
                                 p, q)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("pq", [(0.5, 2.0), (2.0, 0.5), (1.0, 1.0),
                                (0.25, 3.0)])
def test_approx_gap_matches(pq):
    rng = np.random.default_rng(7)
    du = rng.integers(0, 400, 500).astype(np.int32)
    dv = rng.integers(0, 400, 500).astype(np.int32)
    lo = (rng.random(500) + 0.05).astype(np.float32)
    hi = (lo + rng.random(500) * 3).astype(np.float32)
    want = np.asarray(jax_approx_gap(*map(jnp.asarray, (du, dv, lo, hi)),
                                     *pq))
    got = approx_gap(*map(torch.from_numpy, (du, dv, lo, hi)), *pq)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, 5, 64])
def test_alias_sample_matches(width):
    rng = np.random.default_rng(width)
    w = 300
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(4),
                                                 i))(jnp.arange(w))
    prob = rng.random((w, width)).astype(np.float32)
    alias = rng.integers(0, width, (w, width)).astype(np.int32)
    live = rng.integers(0, width + 1, w).astype(np.int32)
    want = np.asarray(jax.vmap(jax_alias_sample)(
        keys, jnp.asarray(prob), jnp.asarray(alias), jnp.asarray(live)))
    got = alias_sample(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                       torch.from_numpy(prob), torch.from_numpy(alias),
                       torch.from_numpy(live))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "approx", "approx_always"])
def test_sampler_choose_matches(mode):
    """One superstep draw for all three modes on shared inputs and keys."""
    rng = np.random.default_rng(11)
    w, d = 64, 40
    cand, cw, u, prev, _ = _make_step_inputs(rng, w, d, 30)
    keys = np.asarray(jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(2), i))(jnp.arange(w)))
    hot_np = dict(
        is_hot_v=rng.random(w) < 0.6, is_hot_u=rng.random(w) < 0.3,
        deg_u=rng.integers(1, 50, w).astype(np.int32),
        deg_v=(cand != PAD_ID).sum(1).astype(np.int32),
        w_min_v=np.full(w, 0.1, np.float32),
        w_max_v=np.full(w, 1.1, np.float32),
        alias_p=rng.random((w, d)).astype(np.float32),
        alias_i=rng.integers(0, d, (w, d)).astype(np.int32))
    hot_np["alias_deg"] = hot_np["deg_v"]
    kw = dict(p=0.5, q=2.0, mode=mode, eps=0.5)
    jc = JaxSampler(**kw).choose(
        jnp.asarray(keys), *map(jnp.asarray, (cand, cw, u, prev)),
        JaxHot(**{k: jnp.asarray(v) for k, v in hot_np.items()}))
    for fused in (False, True):
        tc = Sampler(fused=fused, **kw).choose(
            torch.from_numpy(keys.astype(np.int64)),
            *map(torch.from_numpy, (cand, cw, u, prev)),
            HotContext(**{k: torch.from_numpy(v)
                          for k, v in hot_np.items()}))
        assert np.array_equal(tc.slot().numpy(), np.asarray(jc.slot()))


def test_wrappers_validate_inputs():
    rng = np.random.default_rng(0)
    cand, cw, u, prev, r = map(torch.from_numpy,
                               _make_step_inputs(rng, 8, 6, 5))
    with pytest.raises(TypeError):
        K.node2vec_step(cand.long(), cw, u, prev, r, 1.0, 1.0)
    with pytest.raises(ValueError):
        K.node2vec_step(cand, cw, u[:4], prev, r, 1.0, 1.0)
    with pytest.raises(ValueError):
        K.node2vec_step(cand.t().contiguous().t(), cw, u, prev, r, 1.0, 1.0)
    meta = [t.to("meta") for t in (cand, cw, u, prev, r)]
    with pytest.raises(ValueError):
        K.node2vec_step(*meta, 1.0, 1.0)

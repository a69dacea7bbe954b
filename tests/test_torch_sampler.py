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


@pytest.mark.parametrize("n,d,w,steps", [(64, 5, 9, 6), (200, 37, 33, 4),
                                         (600, 256, 9, 3), (800, 384, 9, 3)])
def test_walk_plain_matches_pallas_walk(n, d, w, steps):
    """node2vec_walk's plain version equals the Pallas whole-walk kernel
    (interpret mode), dead ends included, at widths where the op's padding
    to 128 lanes leaves the scan's total unchanged (D <= 256, or a multiple
    of 128)."""
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


# ---- the live-lane draw of csrc/node2vec_step.cu, emulated in numpy ----

BASE = 16


def _block_scan(a, nl):
    """In-block inclusive float32 scans of the live entries of one level
    [R, n] (entries at or past nl[r] are NaN and never read), and the live
    block totals (the next level, NaN past its live entries)."""
    rows, n = a.shape
    nb = -(-n // BASE)
    ap = np.pad(a, ((0, 0), (0, nb * BASE - n)), constant_values=np.nan)
    within = np.full((rows, nb * BASE), np.nan, np.float32)
    acc = np.zeros((rows, nb), np.float32)
    for j in range(BASE):
        idx = np.arange(nb) * BASE + j
        live = idx[None, :] < nl[:, None]
        acc = np.where(live, acc + ap[:, idx], acc)
        within[:, idx] = np.where(live, acc, np.nan)
    nbl = -(-nl // BASE)
    totals = np.where(np.arange(nb)[None, :] < nbl[:, None], acc, np.nan)
    return within[:, :n], totals.astype(np.float32), nbl


def _levels(x, live):
    """Every level of the blocked scan with the padded width's structure
    (the top has <= 16 entries), touching live entries only."""
    levels, a, nl, n = [], x, live, x.shape[1]
    while True:
        within, totals, nbl = _block_scan(a, nl)
        levels.append((within, nl, n))
        if n <= BASE:
            return levels
        a, nl, n = totals, nbl, -(-n // BASE)


def _prefix(levels, r, l, i):
    """P_l(i) of row r: W_l(i) + P_{l+1}(i // 16 - 1), where W past the
    live entries is the last live block's total in that block, else 0
    (the rule of scan_levels)."""
    within, nl, n = levels[l]
    li = int(nl[r])
    if i < li:
        w = within[r, i]
    elif li > 0 and i // BASE == (li - 1) // BASE:
        w = within[r, li - 1]
    else:
        w = np.float32(0.0)
    if n <= BASE or i < BASE:
        return np.float32(w)
    return np.float32(w + _prefix(levels, r, l + 1, i // BASE - 1))


def _live_rows(rng, rows, d, live):
    """Probabilities with NaN in every dead lane, and the same rows
    zero-padded as the padded contract holds them."""
    lane = np.arange(d)[None, :]
    vals = (rng.random((rows, d)) * rng.choice([0.5, 1.0, 2.0, 4.0],
                                               (rows, d))).astype(np.float32)
    return (np.where(lane < live[:, None], vals, np.nan).astype(np.float32),
            np.where(lane < live[:, None], vals, 0.0).astype(np.float32))


@pytest.mark.parametrize("d", [147, 300, 913, 4100])
def test_trimmed_total_equals_padded_cumsum(d):
    """The total the live-lane kernel forms from live blocks alone, by the
    padded width's level structure, equals cum[D - 1] of the zero-padded
    row (prefix_sum and jnp.cumsum) for every live length 0..D; cum[L - 1]
    does not, from D = 300 on."""
    rng = np.random.default_rng(d)
    differ = 0
    for lo in range(0, d + 1, 1024):
        live = np.arange(lo, min(lo + 1024, d + 1))
        dead_nan, padded = _live_rows(rng, len(live), d, live)
        levels = _levels(dead_nan, live)
        got = np.array([_prefix(levels, r, 0, d - 1)
                        for r in range(len(live))], np.float32)
        cum = prefix_sum(torch.from_numpy(padded)).numpy()
        assert np.array_equal(got, cum[:, -1])
        jcum = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(padded))
        assert np.array_equal(got, jcum[:, -1])
        at_live = cum[np.arange(len(live)), np.maximum(live - 1, 0)]
        differ += int(((got != at_live) & (live > 0)).sum())
    assert (differ > 0) == (d > 256)


def _emulated_draw(cand, w, u, prev, r, p, q):
    """The live-lane draw of one batch of padded rows, lane by lane as the
    kernel does it: only live lanes read, prefixes by the blocked rule,
    total by the padded structure, slot clamped to D - 1."""
    rows, d = cand.shape
    live = (cand != PAD_ID).sum(1)
    plive = (prev != PAD_ID).sum(1)
    p_inv, q_inv = np.float32(1.0 / p), np.float32(1.0 / q)
    probs = np.full((rows, d), np.nan, np.float32)
    for i in range(rows):
        x = cand[i, :live[i]]
        member = np.isin(x, prev[i, :plive[i]])
        alpha = np.where(x == u[i], p_inv,
                         np.where(member, np.float32(1.0), q_inv))
        probs[i, :live[i]] = alpha.astype(np.float32) * w[i, :live[i]]
    levels = _levels(probs, live)
    slots = np.zeros(rows, np.int32)
    for i in range(rows):
        target = np.float32(r[i] * _prefix(levels, i, 0, d - 1))
        count = 0
        for j in range(live[i]):
            b = j // BASE
            cum = levels[0][0][i, j]
            if b > 0:
                cum = np.float32(cum + _prefix(levels, i, 1, b - 1))
            count += int(cum <= target)
        slots[i] = min(count, d - 1)
    return slots


@pytest.mark.parametrize("d", [1, 16, 17, 147, 300, 913])
def test_emulated_live_draw_matches_exact_slots(d):
    """The kernel's algorithm (live lanes only) draws exact_slots' slots on
    rows whose live lengths sit at block and level edges, rand near 1
    included."""
    rng = np.random.default_rng(d + 5)
    edges = sorted({x for x in (0, 1, 15, 16, 17, 31, 255, 256, 257, 272,
                                d // 2, d - 1, d) if 0 <= x <= d})
    live = np.array(edges * 3)
    rows = len(live)
    cand = np.sort(rng.integers(0, 1 << 20, (rows, d)), axis=1) + np.arange(d)
    lane = np.arange(d)[None, :]
    cand = np.where(lane < live[:, None], cand, PAD_ID).astype(np.int32)
    w = np.where(lane < live[:, None], rng.random((rows, d)) + 0.1,
                 0.0).astype(np.float32)
    pick = cand[np.arange(rows)[:, None],
                rng.integers(0, np.maximum(live, 1)[:, None], (rows, d))]
    prev = np.sort(np.where(rng.random((rows, d)) < 0.5, pick, PAD_ID),
                   axis=1).astype(np.int32)
    u = cand[np.arange(rows), rng.integers(0, np.maximum(live, 1))]
    r = rng.random(rows).astype(np.float32)
    r[::3] = np.float32(1 - 2.0 ** -24)
    got = _emulated_draw(cand, w, u, prev, r, 0.5, 2.0)
    want = exact_slots(*map(torch.from_numpy, (cand, w, u, prev, r)), 0.5,
                       2.0).numpy()
    assert np.array_equal(got, want)


def _emulated_small_draw(cand, w, u, prev, r, p, q):
    """The walk kernel's draw over rows of width D <= 256 (draw_small), as
    it computes it: membership by a fixed-depth search of u's row padded
    with PAD_ID (depth 7 over 128 lanes when u has at most 128 live ones,
    else 8 over 256), probabilities 0 past the live lanes, the blocks'
    totals scanned in order, total = the last padded block's total + the
    level-1 prefix before it, and each block's count of cum <= target (a
    5-step search of its prefixes) capped at its live lanes."""
    rows, d = cand.shape
    live = (cand != PAD_ID).sum(1)
    p_inv, q_inv = np.float32(1.0 / p), np.float32(1.0 / q)
    row = np.full((rows, 256), PAD_ID, np.int64)
    row[:, :prev.shape[1]] = prev
    x = np.full((rows, 256), PAD_ID, np.int64)
    x[:, :d] = cand
    pos = np.zeros((rows, 256), np.int64)
    deep = (prev != PAD_ID).sum(1) > 128
    for h in (128, 64, 32, 16, 8, 4, 2, 1):
        at = np.take_along_axis(row, pos + h - 1, axis=1)
        pos += np.where((at < x) & (deep[:, None] | (h < 128)), h, 0)
    member = np.take_along_axis(row, pos, axis=1) == x
    alpha = np.where(x == u[:, None], p_inv,
                     np.where(member, np.float32(1.0), q_inv))
    wt = np.zeros((rows, 256), np.float32)
    wt[:, :d] = w
    lane = np.arange(256)[None, :]
    probs = np.where(lane < live[:, None], alpha.astype(np.float32) * wt,
                     np.float32(0.0)).reshape(rows, 16, 16)
    within = np.zeros_like(probs)
    acc = np.zeros((rows, 16), np.float32)
    for j in range(16):
        acc = acc + probs[:, :, j]
        within[:, :, j] = acc
    t = within[:, :, 15]
    incl = np.zeros((rows, 16), np.float32)
    run = np.zeros(rows, np.float32)
    for b in range(16):
        run = run + t[:, b]
        incl[:, b] = run
    n1 = -(-d // 16)
    total = t[:, n1 - 1] + incl[:, n1 - 2] if n1 > 1 else t[:, 0]
    target = (r * total).astype(np.float32)
    carry = np.concatenate([np.zeros((rows, 1), np.float32), incl[:, :-1]],
                           axis=1)
    cum = within + carry[:, :, None]
    count = np.zeros((rows, 16), np.int64)
    for h in (8, 4, 2, 1):
        at = np.take_along_axis(cum, (count + h - 1)[:, :, None], 2)[:, :, 0]
        count += np.where(at <= target[:, None], h, 0)
    at = np.take_along_axis(cum, count[:, :, None], 2)[:, :, 0]
    count += at <= target[:, None]
    cap = np.maximum(live[:, None] - 16 * np.arange(16)[None, :], 0)
    return np.minimum(np.minimum(count, cap).sum(1), d - 1)


@pytest.mark.parametrize("d", [1, 16, 17, 100, 147, 255, 256])
def test_emulated_small_draw_matches_exact_slots(d):
    """The walk kernel's draw over rows of at most 256 lanes draws
    exact_slots' slots, with live lengths at block edges and rand at 0 and
    near 1."""
    rng = np.random.default_rng(d + 11)
    edges = sorted({x for x in (0, 1, 2, 15, 16, 17, 31, 32, 33, 100, 240,
                                241, d // 2, d - 1, d) if 0 <= x <= d})
    live = np.array(edges * 6)
    rows = len(live)
    cand = np.sort(rng.integers(0, 1 << 20, (rows, d)), axis=1) + np.arange(d)
    lane = np.arange(d)[None, :]
    cand = np.where(lane < live[:, None], cand, PAD_ID).astype(np.int32)
    w = np.where(lane < live[:, None], rng.random((rows, d)) + 0.1,
                 0.0).astype(np.float32)
    pick = cand[np.arange(rows)[:, None],
                rng.integers(0, np.maximum(live, 1)[:, None], (rows, d))]
    prev = np.sort(np.where(rng.random((rows, d)) < 0.5, pick, PAD_ID),
                   axis=1).astype(np.int32)
    u = cand[np.arange(rows), rng.integers(0, np.maximum(live, 1))]
    r = rng.random(rows).astype(np.float32)
    r[::3] = np.float32(1 - 2.0 ** -24)
    r[1::5] = 0.0
    for p, q in [(0.5, 2.0), (1.0, 1.0), (4.0, 0.25)]:
        got = _emulated_small_draw(cand, w, u, prev, r, p, q)
        want = exact_slots(*map(torch.from_numpy, (cand, w, u, prev, r)), p,
                           q).numpy()
        assert np.array_equal(got, want)


def _hub_graph(seed=0, n=1200):
    """Random edges plus hubs of degree ~300-1000, so FN-Cache rows span
    three scan levels at hot_cap >= 913."""
    from repro.core.graph import CSRGraph as JaxCSR
    rng = np.random.default_rng(seed)
    src = [rng.integers(0, n, 6 * n)]
    dst = [rng.integers(0, n, 6 * n)]
    for hub, deg in zip(range(6), (300, 520, 700, 913, 960, 1000)):
        src.append(np.full(deg, hub))
        dst.append(rng.choice(np.arange(6, n), deg, replace=False))
    src, dst = np.concatenate(src), np.concatenate(dst)
    wgt = (rng.random(src.size) * 3 + 0.25).astype(np.float32)
    return JaxCSR.from_edges(n, src, dst, wgt)


def _layout_pair(g, cap, hot_cap=None):
    from repro.core.graph import PaddedGraph as JaxPG
    from repro_torch.convert import padded_graph_from_numpy
    from repro_torch.core.graph import FIELDS
    jpg = JaxPG.build(g, cap=cap, hot_cap=hot_cap)
    pg = padded_graph_from_numpy({f: np.asarray(getattr(jpg, f))
                                  for f in FIELDS}, jpg.n, jpg.cap,
                                 jpg.hot_cap, device="cpu")
    return jpg, pg


def _jax_layout_draw(jpg, u, v, r, p, q):
    """The JAX package's step on its own full-width rows: unified_row,
    Sampler.exact, the gather and the dead-end rule."""
    from repro.core.walk import unified_row as jax_unified_row
    rows = jax.vmap(lambda x: jax_unified_row(jpg, x))
    ids, w = rows(jnp.asarray(v))[:2]
    prev = rows(jnp.asarray(u))[0]
    slot = JaxSampler(p=p, q=q).exact(jnp.asarray(r), ids, w, jnp.asarray(u),
                                      prev)
    nxt = jnp.take_along_axis(ids, slot[:, None].astype(jnp.int32), 1)[:, 0]
    nxt = jnp.where(jpg.deg[jnp.asarray(v)] > 0, nxt, jnp.asarray(v))
    return np.asarray(slot), np.asarray(nxt)


@pytest.mark.parametrize("cap,hot_cap", [(None, None), (24, None),
                                         (24, 1100)])
def test_layout_plain_matches_jax(cap, hot_cap):
    """node2vec_step_layout (its plain version, on the CPU) draws the JAX
    package's slots and next vertices on FN-Base and FN-Cache layouts
    (hot_cap 1,000 and 1,100: three scan levels), hubs and dead ends
    included."""
    g = _hub_graph()
    jpg, pg = _layout_pair(g, cap, hot_cap)
    assert pg.hot_cap >= 913
    rng = np.random.default_rng(3)
    wk = 512
    v = np.concatenate([np.arange(6), rng.integers(0, g.n, wk - 6)])
    nbr = [g.neighbors(x) for x in v]
    u = np.array([rng.choice(nb) if len(nb) else rng.integers(0, g.n)
                  for nb in nbr]).astype(np.int32)
    v = v.astype(np.int32)
    r = rng.random(wk).astype(np.float32)
    r[:6] = np.float32(1 - 2.0 ** -24)
    for p, q in [(1.0, 0.5), (0.5, 2.0)]:
        want = _jax_layout_draw(jpg, u, v, r, p, q)
        slot, nxt = K.node2vec_step_layout(
            pg, *map(torch.from_numpy, (u, v, r)), p, q)
        assert slot.dtype == nxt.dtype == torch.int32
        assert np.array_equal(slot.numpy(), want[0])
        assert np.array_equal(nxt.numpy(), want[1])


def _pad_hub():
    """A hub of 600 live lanes in a graph of max degree 914 whose row's
    padded total exceeds cum[L - 1] so that rand = 1 - 2^-24 gives slot
    == L: returns (graph, L, rand)."""
    from repro.core.graph import CSRGraph as JaxCSR
    n, live = 1000, 600
    src = np.concatenate([np.zeros(live), np.ones(913)])
    dst = np.concatenate([np.arange(1, live + 1), np.arange(87, 1000)])
    r = np.float32(1 - 2.0 ** -24)
    for seed in range(400):
        wgt = np.random.default_rng(seed).random(src.size).astype(
            np.float32) + np.float32(0.25)
        g = JaxCSR.from_edges(n, src, dst, wgt)
        row = np.zeros((1, g.max_degree), np.float32)
        row[0, :live] = g.weights(0)
        cum = prefix_sum(torch.from_numpy(row))[0]
        if cum[-1] > cum[live - 1] and \
                int((cum[:live] <= r * cum[-1]).sum()) == live:
            return g, live, r
    raise AssertionError("no row with total > cum[L - 1] found")


def test_slot_past_the_live_lanes_gives_pad():
    """slot == L when r * total reaches cum[L - 1] while staying below the
    padded total (which exceeds cum[L - 1] by an ulp in some rows at D >
    256): the padded row's id there is PAD_ID, in the JAX package as here,
    since the clamp is to D - 1, not L - 1. A hub of 600 live lanes in a
    layout of hot_cap 914, rand = 1 - 2^-24."""
    g, live, r = _pad_hub()
    jpg, pg = _layout_pair(g, cap=24)
    assert pg.hot_cap == 914 and int(pg.deg[0]) == live
    u = np.array([1, 5, 600], np.int32)
    v = np.zeros(3, np.int32)
    rand = np.full(3, r, np.float32)
    slot, nxt = K.node2vec_step_layout(
        pg, *map(torch.from_numpy, (u, v, rand)), 1.0, 1.0)
    want = _jax_layout_draw(jpg, u, v, rand, 1.0, 1.0)
    assert np.array_equal(slot.numpy(), want[0])
    assert np.array_equal(nxt.numpy(), want[1])
    assert slot.tolist() == [live] * 3 and nxt.tolist() == [PAD_ID] * 3


# ---- walks that reach PAD_ID --------------------------------------------

def _fn_base(g):
    """adj, wgt, deg of the FN-Base layout (width = max degree)."""
    from repro.core.graph import PaddedGraph as JaxPG
    jpg = JaxPG.build(g)
    return tuple(np.array(getattr(jpg, f)) for f in ("adj", "wgt", "deg"))


def _pad_walkers(g, rng, w, steps):
    """Three walkers that step from the hub 0 to PAD_ID at their first
    step (rand = 1 - 2^-24 throughout), then w - 3 random ones."""
    n = g.n
    u0 = np.concatenate([[1, 5, 600], rng.integers(0, n, w - 3)])
    v1 = np.concatenate([[0, 0, 0], rng.integers(0, n, w - 3)])
    rand = rng.random((w, steps)).astype(np.float32)
    rand[:3] = np.float32(1 - 2.0 ** -24)
    return u0.astype(np.int32), v1.astype(np.int32), rand


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)])
def test_walk_after_pad_matches_jax_op(p, q):
    """A walk that draws PAD_ID (slot == L at the hub) stays at PAD_ID in
    every later column, reading nothing, as the JAX package's
    node2vec_walk_op keeps it (its take fills deg with INT_MIN there);
    the other walkers of the batch equal the op's too."""
    g, _, _ = _pad_hub()
    adj, wgt, deg = _fn_base(g)
    assert adj.shape == (g.n, 914)
    u0, v1, rand = _pad_walkers(g, np.random.default_rng(0), 11, 6)
    want = np.asarray(node2vec_walk_op(*map(jnp.asarray, (
        adj, wgt, deg, u0, v1, rand)), p, q))
    got = K.node2vec_walk(*map(torch.from_numpy, (adj, wgt, deg, u0, v1,
                                                  rand)), p, q)
    assert np.array_equal(got.numpy(), want)
    if (p, q) == (1.0, 1.0):
        assert (want[:3] == PAD_ID).all()


def test_walk_from_out_of_range_ids_matches_jax_op():
    """v1 at PAD_ID, n or n + 5 stays there; a u0 at one of them gives the
    first step no prev row, as the op's filled take does."""
    rng = np.random.default_rng(7)
    n, d, w, steps = 64, 9, 12, 4
    adj, wgt, deg = _walk_graph(rng, n, d)
    u0 = rng.integers(0, n, w).astype(np.int32)
    v1 = rng.integers(0, n, w).astype(np.int32)
    v1[:3] = [PAD_ID, n, n + 5]
    u0[3:6] = [PAD_ID, n, n + 5]
    rand = rng.random((w, steps)).astype(np.float32)
    args = (adj, wgt, deg, u0, v1, rand)
    want = np.asarray(node2vec_walk_op(*map(jnp.asarray, args), 0.5, 2.0))
    got = K.node2vec_walk(*map(torch.from_numpy, args), 0.5, 2.0)
    assert np.array_equal(got.numpy(), want)
    assert (want[:3] == v1[:3, None]).all()


def _jax_walk_steps(adj, wgt, deg, u0, v1, rand, p, q):
    """The whole-walk kernel's draws step by step in the JAX package on
    D-wide rows (its exact_slots, take with the op's fill), without the
    op's 128-lane padding of the width."""
    from repro.engine.sampler import exact_slots as jax_exact_slots
    adj, wgt, deg = map(jnp.asarray, (adj, wgt, deg))
    u, v = jnp.asarray(u0), jnp.asarray(v1)
    prev = jnp.take(adj, u, axis=0)
    cols = []
    for s in range(rand.shape[1]):
        cand, w = jnp.take(adj, v, axis=0), jnp.take(wgt, v, axis=0)
        slot = jax_exact_slots(cand, w, u, prev, jnp.asarray(rand[:, s]), p,
                               q)
        nxt = jnp.take_along_axis(cand, slot[:, None], axis=1)[:, 0]
        nxt = jnp.where(jnp.take(deg, v) > 0, nxt, v)
        u, v, prev = v, nxt, cand
        cols.append(nxt)
    return np.asarray(jnp.stack(cols, axis=1))


@pytest.mark.parametrize("d", [300, 793, 913, 914])
def test_walk_plain_matches_jax_steps_at_any_width(d):
    """At widths whose 128-lane padding in node2vec_walk_op changes the
    scan's levels (and so, in some rows, the total), node2vec_walk's plain
    version equals the JAX package's draws step by step on the D-wide
    rows; 914 is the hub graph, whose first three walkers reach PAD_ID."""
    rng = np.random.default_rng(d)
    if d == 914:
        g, _, _ = _pad_hub()
        adj, wgt, deg = _fn_base(g)
        u0, v1, rand = _pad_walkers(g, rng, 11, 5)
    else:
        adj, wgt, deg = _walk_graph(rng, 3 * d, d)
        u0, v1 = (rng.integers(0, 3 * d, 40).astype(np.int32)
                  for _ in range(2))
        rand = rng.random((40, 5)).astype(np.float32)
        rand[::4] = np.float32(1 - 2.0 ** -24)
    args = (adj, wgt, deg, u0, v1, rand)
    for p, q in [(0.5, 2.0), (1.0, 1.0)]:
        got = K.node2vec_walk(*map(torch.from_numpy, args), p, q)
        assert np.array_equal(got.numpy(), _jax_walk_steps(*args, p, q))


@pytest.mark.parametrize("last_hot", [False, True])
def test_unified_row_clamps_like_jax(last_hot):
    """Ids PAD_ID, n and n + 5 read row n - 1 in every field, as the JAX
    package's clamped gathers do, on FN-Cache layouts whose last vertex is
    cold (the PAD_ID hub graph) or hot (a hub of degree 40 at cap 24)."""
    from repro.core.graph import CSRGraph as JaxCSR
    from repro.core.walk import unified_row as jax_unified_row
    from repro_torch.core.walk import unified_row
    if last_hot:
        rng = np.random.default_rng(2)
        n = 60
        src = np.concatenate([np.full(40, n - 1), rng.integers(0, n, 90)])
        dst = np.concatenate([np.arange(40), rng.integers(0, n, 90)])
        g = JaxCSR.from_edges(n, src, dst, (rng.random(130) + 0.5).astype(
            np.float32))
    else:
        g, _, _ = _pad_hub()
    jpg, pg = _layout_pair(g, cap=24)
    assert (int(pg.hot_pos[g.n - 1]) >= 0) == last_hot
    ids = np.array([PAD_ID, g.n, g.n + 5, g.n - 1], np.int32)
    got = unified_row(pg, torch.from_numpy(ids))
    want = jax.vmap(lambda x: jax_unified_row(jpg, x))(jnp.asarray(ids))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert all(np.array_equal(a[i].numpy(), a[3].numpy())
                   for i in range(3))


@pytest.mark.parametrize("cap", [None, 24])
def test_layout_plain_from_pad_matches_jax(cap):
    """node2vec_step_layout's plain version from u = v = PAD_ID (and n, n +
    5) draws what the JAX package's step draws on its clamped rows: row n -
    1, whose degree is not 0, so the walker leaves PAD_ID."""
    g, _, _ = _pad_hub()
    jpg, pg = _layout_pair(g, cap)
    ids = np.array([PAD_ID, g.n, g.n + 5, PAD_ID], np.int32)
    u = ids.copy()
    u[3] = 1
    rng = np.random.default_rng(5)
    r = rng.random(4).astype(np.float32)
    for p, q in [(1.0, 0.5), (0.5, 2.0)]:
        want = _jax_layout_draw(jpg, u, ids, r, p, q)
        slot, nxt = K.node2vec_step_layout(
            pg, *map(torch.from_numpy, (u, ids, r)), p, q)
        assert np.array_equal(slot.numpy(), want[0])
        assert np.array_equal(nxt.numpy(), want[1])
        assert (nxt.numpy() < g.n).all()

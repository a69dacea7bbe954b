"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the CPU, at smoke widths on numpy inputs from a
seed: ``init_moe`` within ``normal``'s 3 ulps, ``moe_apply`` at 1, 2 and 4
routing groups (f32 1e-5, grads 1e-4, bf16 to bf16's rounding), each
token's experts and each expert's token slots equal to ``jax.lax.top_k``'s
integer for integer, ties included, capacity as JAX computes it, and the
JAX package's own routing properties (tests/test_models.py) held on the
port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import random as jr
from repro_torch.models import moe as tmoe


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arch, **changes):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **changes),
            dataclasses.replace(tconfigs.smoke_config(arch), **changes))


def _params(jcfg, seed):
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _jax_route(cfg, p, x, g):
    """JAX's ``moe_apply`` routing (src/repro/models/moe.py:64-87), step by
    step: (top_e [G,Tg,k], sel_idx [G,E,C], sel_valid [G,E,C])."""
    b, s, d = x.shape
    tg = b * s // g
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = min(max(1, int(tg * k / e * cfg.capacity_factor)), tg)
    xg = x.reshape(g, tg, d)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, -1, keepdims=True)
    assign = jax.nn.one_hot(top_e, e, dtype=jnp.float32)
    weight_te = jnp.einsum("gtke,gtk->gte", assign, top_p)
    score = jnp.where(weight_te > 0, weight_te, -1.0)
    sel_score, sel_idx = jax.lax.top_k(jnp.swapaxes(score, 1, 2), cap)
    return (np.asarray(top_e), np.asarray(sel_idx),
            np.asarray(sel_score > 0))


def _port_route(cfg, p, x, g):
    b, s, d = x.shape
    r = tmoe.route(cfg, p, x.reshape(g, b * s // g, d))
    return r.top_e.numpy(), r.sel_idx.numpy(), r.sel_valid.numpy()


@pytest.mark.parametrize("arch,act", [("phi3.5-moe-42b-a6.6b", "swiglu"),
                                      ("mixtral-8x22b", "swiglu"),
                                      ("mixtral-8x22b", "sq_relu"),
                                      ("mixtral-8x22b", "gelu")])
def test_init_moe_matches_jax(arch, act):
    """Same keys and shapes (``gate`` only for swiglu); values within
    ``normal``'s 3 ulps."""
    jcfg, tcfg = _pair(arch, mlp_act=act)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = tmoe.init_moe(tcfg, jr.PRNGKey(3))
    assert set(tp) == set(jp) and ("gate" in tp) == (act == "swiglu")
    for k in jp:
        assert tp[k].dtype == torch.float32 and tp[k].shape == jp[k].shape
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=2e-7,
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("tg,e,k,cf,want", [
    (16384, 16, 2, 1.25, 2560),     # phi3.5-moe prefill, B=4 x S=4,096
    (4, 16, 2, 1.25, 1),            # phi3.5-moe decode at B=4: int(0.625)
    (48, 4, 2, 1.25, 30), (3, 4, 2, 4.0, 3), (1, 8, 2, 1.25, 1),
    (37, 8, 2, 1.25, 11)])
def test_capacity_as_jax_computes_it(tg, e, k, cf, want):
    cfg = dataclasses.replace(tconfigs.smoke_config("phi3.5-moe-42b-a6.6b"),
                              moe_experts=e, moe_top_k=k, capacity_factor=cf)
    assert tmoe.capacity(cfg, tg) == want == min(
        max(1, int(tg * k / e * cf)), tg)


def test_top_k_keeps_the_lower_index_first():
    scores = torch.tensor([[0.5, 0.25, 0.5, -1.0, 0.5, -1.0, -1.0]])
    vals, idx = tmoe.top_k(scores, 6)
    jv, ji = jax.lax.top_k(jnp.asarray(scores.numpy()), 6)
    assert idx.tolist() == [[0, 2, 4, 1, 3, 5]] == np.asarray(ji).tolist()
    assert np.array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_apply_matches_jax(arch, groups):
    """f32 output within 1e-5; each token's experts and each expert's
    token slots (and which are valid) equal to JAX's."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, 4)
    x = _x((2, 24, jcfg.d_model), groups)
    want = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), groups)
    got = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), groups)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(_port_route(tcfg, tp, torch.from_numpy(x), groups),
                    _jax_route(jcfg, jp, jnp.asarray(x), groups)):
        assert np.array_equal(a, b)


def test_decode_shape_drops_colliding_tokens_as_jax_does():
    """Four tokens over 16 experts take capacity 1 (phi3.5-moe at decode,
    B=4): tokens that share an expert past the first drop, in both.
    Tokens 0-2 are one row, so they share both experts and two of them
    drop from each (the lower token index keeps the slot)."""
    jcfg, tcfg = _pair("phi3.5-moe-42b-a6.6b", moe_experts=16)
    jp, tp = _params(jcfg, 6)
    x = _x((4, 1, jcfg.d_model), 6)
    x[1:3] = x[0]
    got = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), 1)
    np.testing.assert_allclose(
        _np(got), np.asarray(jmoe.moe_apply(jcfg, jp, jnp.asarray(x), 1)),
        atol=1e-5, rtol=1e-5)
    top_e, sel_idx, valid = _port_route(tcfg, tp, torch.from_numpy(x), 1)
    jtop_e, jsel_idx, jvalid = _jax_route(jcfg, jp, jnp.asarray(x), 1)
    assert np.array_equal(top_e, jtop_e) and np.array_equal(sel_idx,
                                                            jsel_idx)
    assert np.array_equal(valid, jvalid) and sel_idx.shape == (1, 16, 1)
    assert valid.sum() <= 4 * 2 - 4     # tokens 1, 2 lost both experts
    assert (_np(got)[1:3] == 0).all() and (_np(got)[0] != 0).any()


@pytest.mark.parametrize("groups", [1, 2])
def test_router_ties_pick_the_lower_indices(groups):
    """A zero router makes every probability 1/E: experts 0..k-1 for every
    token, and each expert's slots take tokens 0..C-1 (experts past k-1
    hold unassigned tokens at weight 0), in JAX and in the port; the
    outputs agree and stay finite."""
    jcfg, tcfg = _pair("phi3.5-moe-42b-a6.6b")
    jp, tp = _params(jcfg, 7)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _x((2, 10, jcfg.d_model), 8)
    k = tcfg.moe_top_k
    tg = 20 // groups
    cap = tmoe.capacity(tcfg, tg)
    top_e, sel_idx, valid = _port_route(tcfg, tp, torch.from_numpy(x),
                                        groups)
    assert (top_e == np.arange(k)).all()
    assert (sel_idx == np.arange(cap)).all()
    assert valid[:, :k].all() and not valid[:, k:].any()
    for a, b in zip((top_e, sel_idx, valid),
                    _jax_route(jcfg, jp, jnp.asarray(x), groups)):
        assert np.array_equal(a, b)
    got = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), groups)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        _np(got), np.asarray(jmoe.moe_apply(jcfg, jp, jnp.asarray(x),
                                            groups)), atol=1e-5, rtol=1e-5)


def test_moe_apply_bf16_matches_jax():
    """bf16 compute: the routing equal to JAX's bf16 routing, the output
    within bf16's rounding of JAX's bf16 output (3e-2 of values of rms
    ~1), and off the port's own f32 output (so a port that computed in
    f32 would fail)."""
    jcfg, tcfg = _pair("phi3.5-moe-42b-a6.6b", dtype="bfloat16")
    jp, tp = _params(jcfg, 9)
    x = _x((2, 16, jcfg.d_model), 9)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tmoe.moe_apply(tcfg, tp, xt, 2)
    want = jmoe.moe_apply(jcfg, jp, xj, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)
    for a, b in zip(_port_route(tcfg, tp, xt, 2),
                    _jax_route(jcfg, jp, xj, 2)):
        assert np.array_equal(a, b)
    f32 = tmoe.moe_apply(dataclasses.replace(tcfg, dtype="float32"), tp,
                         xt.float(), 2)
    assert (_np(got) - _np(f32)).std() > 1e-3


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_grads_match_jax(groups):
    """Grads of sum(y^2) with respect to x and every weight, router
    included (through the renormalised top-k probabilities), within
    1e-4."""
    jcfg, tcfg = _pair("phi3.5-moe-42b-a6.6b")
    jp, tp = _params(jcfg, 10)
    x = _x((2, 16, jcfg.d_model), 10)
    jg = jax.grad(lambda p, xx: jnp.sum(
        jmoe.moe_apply(jcfg, p, xx, groups) ** 2), (0, 1))(jp,
                                                          jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tmoe.moe_apply(tcfg, leaves, tx, groups).square().sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg[1]), atol=1e-4,
                               rtol=1e-4)
    for k in jp:
        np.testing.assert_allclose(_np(leaves[k].grad), np.asarray(jg[0][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_moe_routing_properties():
    """tests/test_models.py::test_moe_routing_properties on the port:
    finite, shape kept, zero in -> zero out (no biases)."""
    cfg = tconfigs.smoke_config("mixtral-8x22b")
    p = tmoe.init_moe(cfg, jr.PRNGKey(4))
    x = torch.from_numpy(_x((2, 8, cfg.d_model), 4))
    y = tmoe.moe_apply(cfg, p, x, num_groups=2)
    assert y.shape == x.shape and torch.isfinite(y).all()
    y0 = tmoe.moe_apply(cfg, p, torch.zeros_like(x), num_groups=2)
    assert float(y0.abs().max()) < 1e-5
    with pytest.raises(ValueError, match="num_groups"):
        tmoe.moe_apply(cfg, p, x, num_groups=3)


def test_moe_group_invariance():
    """tests/test_models.py::test_moe_group_invariance on the port: with
    capacity not binding (cf 4 >= E / k), 1 and 4 groups agree (1e-4)."""
    cfg = dataclasses.replace(tconfigs.smoke_config("phi3.5-moe-42b-a6.6b"),
                              capacity_factor=4.0)
    p = tmoe.init_moe(cfg, jr.PRNGKey(5))
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 5))
    np.testing.assert_allclose(_np(tmoe.moe_apply(cfg, p, x, 1)),
                               _np(tmoe.moe_apply(cfg, p, x, 4)), atol=1e-4,
                               rtol=1e-4)

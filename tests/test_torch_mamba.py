"""The port's Mamba2 (SSD) block (``repro_torch.models.mamba``) against the
JAX package's ``repro.models.mamba`` on the CPU, at smoke widths on numpy
inputs from a seed: ``init_mamba`` within ``normal``'s 3 ulps (the same
``split`` and ``fold_in`` keys), the causal conv, ``mamba_apply`` over one
and several chunks (f32 1e-4, bf16 to bf16's rounding), the prefill state,
decode steps from JAX's state, grads (1e-4), and the JAX package's own
chunked == stepwise and prefill-state == decode-state checks
(tests/test_models.py, 2e-3 and 1e-4) held on the port. Where JAX's grads
turn NaN (the raw intra-chunk decay overflows exp once a chunk's decay
sum passes ~88), the port's stay finite and agree with JAX's finite
ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as jmb
from repro_torch import configs as tconfigs
from repro_torch import random as jr
from repro_torch.models import mamba as tmb


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arch="mamba2-370m", **changes):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **changes),
            dataclasses.replace(tconfigs.smoke_config(arch), **changes))


def _params(jcfg, seed):
    jp = jmb.init_mamba(jcfg, jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_init_mamba_matches_jax(arch):
    """Same key use (``split(key, 6)`` and ``fold_in`` 7, 8, 9), shapes and
    dtypes; values within ``normal``'s 3 ulps, the constants exact."""
    jcfg, tcfg = _pair(arch)
    jp = jmb.init_mamba(jcfg, jax.random.PRNGKey(5))
    tp = tmb.init_mamba(tcfg, jr.PRNGKey(5))
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32 and tp[k].shape == jp[k].shape
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=2e-7,
                                   rtol=1e-6, err_msg=k)
    for k in ("conv_bias_x", "A_log", "dt_bias", "D", "norm"):
        assert np.array_equal(_np(tp[k]), np.asarray(jp[k])), k


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jmb._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tmb._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("s", [12, 64, 256, 512, 768])
def test_mamba_apply_and_prefill_state_match_jax(s):
    """One chunk (S <= 256) and two or three chunks of 256: the output
    within 1e-4, the prefill state (h in float32, the last K-1 pre-conv
    rows of each stream) within 1e-4."""
    jcfg, tcfg = _pair()
    jp, tp = _params(jcfg, 1)
    x = _x((2, s, jcfg.d_model), s)
    jy, jc = jmb.mamba_prefill(jcfg, jp, jnp.asarray(x))
    ty, tc = tmb.mamba_prefill(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].shape == jc[k].shape and tc[k].dtype == torch.float32
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_mamba_decode_matches_jax():
    """Eight decode steps from JAX's prefill state (converted): each
    output and the state after each step within 1e-4."""
    jcfg, tcfg = _pair()
    jp, tp = _params(jcfg, 2)
    x = _x((3, 16, jcfg.d_model), 2)
    _, jc = jmb.mamba_prefill(jcfg, jp, jnp.asarray(x))
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for t in range(8):
        xt = _x((3, 1, jcfg.d_model), 100 + t)
        jo, jc = jmb.mamba_decode(jcfg, jp, jnp.asarray(xt), jc)
        before = {k: v.clone() for k, v in tc.items()}
        to, new = tmb.mamba_decode(tcfg, tp, torch.from_numpy(xt), tc)
        assert all(torch.equal(before[k], tc[k]) for k in tc)  # pure
        tc = new
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-4,
                                   rtol=1e-4)
        for k in jc:
            np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]),
                                       atol=1e-4, rtol=1e-4, err_msg=k)


def test_mamba_init_cache_matches_jax():
    jcfg, tcfg = _pair()
    jc = jmb.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    tc = tmb.init_mamba_cache(tcfg, 3, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["h"].dtype == torch.float32 and tc["cx"].dtype == \
        torch.bfloat16
    assert all(not v.any() for v in tc.values())


def test_mamba_bf16_matches_jax():
    """bf16 compute over two chunks: within bf16's rounding of JAX's bf16
    output (3e-2), and off the port's own f32 output."""
    jcfg, tcfg = _pair(dtype="bfloat16")
    jp, tp = _params(jcfg, 3)
    x = _x((2, 512, jcfg.d_model), 3, scale=1.0)
    want = jmb.mamba_apply(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tmb.mamba_apply(tcfg, tp, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)
    f32 = tmb.mamba_apply(dataclasses.replace(tcfg, dtype="float32"), tp,
                          xt.float())
    assert np.abs(_np(got) - _np(f32)).mean() > 1e-4


def test_sequence_not_a_multiple_of_the_chunk_raises():
    jcfg, tcfg = _pair()
    _, tp = _params(jcfg, 0)
    with pytest.raises(ValueError, match="chunk"):
        tmb.mamba_apply(tcfg, tp, torch.zeros((1, 300, tcfg.d_model)))
    with pytest.raises(AssertionError):   # JAX asserts the same
        jmb.mamba_apply(jcfg, jmb.init_mamba(jcfg, jax.random.PRNGKey(0)),
                        jnp.zeros((1, 300, jcfg.d_model)))


def _grads(jcfg, tcfg, jp, tp, x):
    jg = jax.grad(lambda p, xx: jnp.sum(jmb.mamba_apply(jcfg, p, xx) ** 2),
                  (0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tmb.mamba_apply(tcfg, leaves, tx).square().sum().backward()
    return jg, tx.grad, {k: v.grad for k, v in leaves.items()}


def test_mamba_grads_match_jax():
    """Grads of sum(y^2) with respect to x and every weight within 1e-4 at
    S=17, where JAX's are finite."""
    jcfg, tcfg = _pair()
    jp, tp = _params(jcfg, 4)
    jg, gx, gp = _grads(jcfg, tcfg, jp, tp, _x((2, 17, jcfg.d_model), 4))
    np.testing.assert_allclose(_np(gx), np.asarray(jg[1]), atol=1e-4,
                               rtol=1e-4)
    for k in jp:
        np.testing.assert_allclose(_np(gp[k]), np.asarray(jg[0][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_grads_stay_finite_where_jax_overflows():
    """One chunk of 256 at unit-scale inputs: the intra-chunk decay sums
    pass 88, JAX's exp of the raw difference overflows above the diagonal
    and its grads hold NaN; the port's are all finite, and within 1e-4 of
    JAX's on every leaf where JAX's are finite (the output equal too)."""
    jcfg, tcfg = _pair()
    jp, tp = _params(jcfg, 5)
    x = _x((1, 256, jcfg.d_model), 5, scale=1.0)
    jg, gx, gp = _grads(jcfg, tcfg, jp, tp, x)
    jleaves = dict(jg[0], x=jg[1])
    tleaves = dict(gp, x=gx)
    assert any(np.isnan(np.asarray(v)).any() for v in jleaves.values())
    finite = 0
    for k, v in jleaves.items():
        assert torch.isfinite(tleaves[k]).all(), k
        v = np.asarray(v)
        if np.isfinite(v).all():
            finite += 1
            np.testing.assert_allclose(_np(tleaves[k]), v, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    assert finite >= 3
    np.testing.assert_allclose(
        _np(tmb.mamba_apply(tcfg, tp, torch.from_numpy(x))),
        np.asarray(jmb.mamba_apply(jcfg, jp, jnp.asarray(x))), atol=1e-4,
        rtol=1e-4)


def test_mamba_chunked_equals_stepwise():
    """tests/test_models.py::test_mamba_chunked_equals_stepwise on the
    port: the chunked scan == the token-by-token recurrence (2e-3)."""
    cfg = tconfigs.smoke_config("mamba2-370m")
    p = tmb.init_mamba(cfg, jr.PRNGKey(2))
    x = torch.from_numpy(_x((2, 12, cfg.d_model), 2))
    y_full = tmb.mamba_apply(cfg, p, x)
    cache = tmb.init_mamba_cache(cfg, 2, torch.float32)
    ys = []
    for t in range(12):
        y_t, cache = tmb.mamba_decode(cfg, p, x[:, t:t + 1], cache)
        ys.append(y_t)
    np.testing.assert_allclose(_np(y_full), _np(torch.cat(ys, 1)),
                               atol=2e-3, rtol=2e-3)


def test_mamba_prefill_state_matches_decode():
    """tests/test_models.py::test_mamba_prefill_state_matches_decode on
    the port: h within 2e-3, the conv caches within 1e-4."""
    cfg = tconfigs.smoke_config("mamba2-370m")
    p = tmb.init_mamba(cfg, jr.PRNGKey(3))
    x = torch.from_numpy(_x((1, 10, cfg.d_model), 3))
    _, pre = tmb.mamba_prefill(cfg, p, x)
    cache = tmb.init_mamba_cache(cfg, 1, torch.float32)
    for t in range(10):
        _, cache = tmb.mamba_decode(cfg, p, x[:, t:t + 1], cache)
    np.testing.assert_allclose(_np(pre["h"]), _np(cache["h"]), atol=2e-3,
                               rtol=2e-3)
    for k in ("cx", "cb", "cc"):
        np.testing.assert_allclose(_np(pre[k]), _np(cache[k]), atol=1e-4)

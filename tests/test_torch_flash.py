"""The port's ``flash_attention`` on the CPU: its plain version against the
JAX package's Pallas kernel (interpret mode, through ``flash_attention_op``)
at the shapes of tests/test_flash_attention.py, f32 within 3e-3 and bf16
within 3e-2 as there; against the materialized oracle
``flash_attention_ref`` where the op's padding departs from it
(``causal=False`` at a ragged S); and the wrapper's contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention_op
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain,
                                                 route, visible)
from repro_torch.models.attention import _expand_kv, attend

SHAPES = [(2, 128, 4, 2, 32, 0), (1, 256, 2, 2, 64, 0), (2, 256, 4, 1, 32, 64),
          (1, 96, 3, 3, 16, 0), (1, 128, 2, 2, 128, 0)]
PROPERTY = [(1, 64, 1, 16, 0), (2, 64, 4, 32, 1), (1, 128, 2, 16, 2),
            (2, 128, 1, 32, 3), (1, 192, 4, 16, 0), (2, 192, 2, 32, 1)]


def _qkv(b, s, h, kv, dh, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(dtype),
            rng.normal(size=(b, s, kv, dh)).astype(dtype),
            rng.normal(size=(b, s, kv, dh)).astype(dtype))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _ref_model_layout(q, k, v, window=0, causal=True):
    """flash_attention_ref per batch row on [H, S, dh], GQA expanded."""
    h, kv = q.shape[2], k.shape[2]
    ke, ve = np.repeat(k, h // kv, 2), np.repeat(v, h // kv, 2)
    out = np.stack([np.asarray(flash_attention_ref(
        jnp.asarray(np.swapaxes(q[b], 0, 1)),
        jnp.asarray(np.swapaxes(ke[b], 0, 1)),
        jnp.asarray(np.swapaxes(ve[b], 0, 1)), window=window, causal=causal))
        for b in range(q.shape[0])])
    return np.swapaxes(out, 1, 2)


@pytest.mark.parametrize("b,s,h,kv,dh,window", SHAPES)
def test_plain_matches_pallas_kernel(b, s, h, kv, dh, window):
    q, k, v = _qkv(b, s, h, kv, dh)
    want = np.asarray(flash_attention_op(*map(jnp.asarray, (q, k, v)),
                                         window=window))
    got = flash_attention_plain(*_torch(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("b,s,h,dh,seed", PROPERTY)
def test_plain_matches_pallas_kernel_sweep(b, s, h, dh, seed):
    q, k, v = _qkv(b, s, h, h, dh, seed)
    want = np.asarray(flash_attention_op(*map(jnp.asarray, (q, k, v))))
    got = flash_attention_plain(*_torch(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("window", [0, 40])
def test_plain_bf16_matches_pallas_kernel(window):
    """bf16 inputs, f32 arithmetic, bf16 output: the JAX kernel on the same
    bf16 values, and the f32 result, within 3e-2."""
    q, k, v = _qkv(1, 128, 4, 2, 32, seed=1)
    jbf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(flash_attention_op(*jbf, window=window), np.float32)
    tq, tk, tv = [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in jbf]
    got = flash_attention_plain(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)
    f32 = flash_attention_plain(*_torch(q, k, v), window=window)
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("window", [0, 24])
def test_non_causal_follows_the_oracle_not_the_op(window):
    """At S=96 the op pads S to 128 with zero keys, which its kernel counts
    for causal=False; the port takes the unpadded contract."""
    q, k, v = _qkv(1, 96, 2, 2, 16, seed=4)
    want = _ref_model_layout(q, k, v, window, causal=False)
    got = flash_attention_plain(*_torch(q, k, v), window=window,
                                causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    op = np.asarray(flash_attention_op(*map(jnp.asarray, (q, k, v)),
                                       window=window, causal=False))
    assert np.abs(op - want).max() > 0.05          # the op's padding quirk


@pytest.mark.parametrize("b,s,h,kv,dh,window", SHAPES[:3])
def test_plain_equals_attend_with_the_mask(b, s, h, kv, dh, window):
    """In f32 the kernel's function is the JAX model's ``attend`` with its
    causal (windowed) mask as a -1e30 bias: the same scores, mask and
    softmax."""
    q, k, v = _torch(*_qkv(b, s, h, kv, dh, seed=2))
    bias = torch.where(visible(s, window), 0.0, NEG_INF)
    want = attend(q, _expand_kv(k, h // kv), _expand_kv(v, h // kv), bias)
    torch.testing.assert_close(flash_attention_plain(q, k, v, window), want,
                               atol=1e-5, rtol=1e-5)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = _torch(*_qkv(2, 33, 4, 2, 16, seed=3))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, window=8),
                       flash_attention_plain(q, k, v, window=8))
    assert flash_attention.launches == before     # no kernel was launched


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(*_qkv(1, 16, 4, 2, 8))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :8].contiguous(), v[:, :8].contiguous())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    # a meta tensor (the dry-run's abstract step) takes the meta route: an
    # empty result of q's shape, no launch counted
    before = flash_attention.launches
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 100, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
    (torch.float32, 100, "simt")])
def test_route_is_a_function_of_dtype_and_dh(dtype, dh, want):
    """bf16 with dh a multiple of 16 takes the tensor-core kernel, all else
    the float32 SIMT kernel: the choice reads nothing but dtype and dh."""
    assert route(dtype, dh) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_rejects_what_neither_route_takes(dtype):
    with pytest.raises(ValueError, match="dh"):
        route(dtype, 264)
    q, k, v = _torch(*_qkv(1, 8, 2, 1, 264), dtype=dtype)
    with pytest.raises(ValueError, match="dh"):
        flash_attention(q, k, v)

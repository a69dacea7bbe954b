"""The port's cross attention (encoder-decoder and VLM layers) against the
JAX package on the CPU, at smoke widths with seeded non-zero memory (zero
frames encode to 0 and zero patches give zero k and v, which would hide a
wrong cross layer): ``attn_train(memory=)`` and its grads under GQA,
``memory_kv`` and ``cross_decode``, the encoder's route through the flash
kernel's plain version, ``init_params`` with the encoder and the cross
layers, the converter's encoder subtree, ``prefill`` + ``serve_step`` in
float32 and bf16 with the memory caches, ``loss_fn`` and the grads of
every leaf (the encoder's included), and the serving launcher. Tolerances
are stated per test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import random as jr
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.optim.grad_utils import value_and_grad

CROSS = ["seamless-m4t-medium", "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: its loops of small ops run many
    times slower when the test workers' thread pools oversubscribe the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):    # a copy: the caches change in place
        return x.detach().float().cpu().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _pair(arch, **changes):
    return (dataclasses.replace(jconfigs.smoke_config(arch), **changes),
            dataclasses.replace(tconfigs.smoke_config(arch), **changes))


def _params(jcfg, tcfg, seed=0):
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _memory(cfg, b, seed, zero=False):
    """``{"frames": ...}`` or ``{"patches": ...}`` [b, M, D] float32,
    normal(0, 1) from a numpy seed (or zeros)."""
    name = "frames" if cfg.enc_layers else "patches"
    m = cfg.num_audio_frames if cfg.enc_layers else cfg.num_image_tokens
    a = np.random.default_rng(seed).normal(size=(b, m, cfg.d_model))
    return {name: np.zeros_like(a, np.float32) if zero
            else a.astype(np.float32)}


# ------------------------------------------------------- attention --
@pytest.mark.parametrize("arch", CROSS)
def test_attn_train_cross_and_grads_match_jax(arch):
    """Cross attention for training (llama-vision's smoke config is GQA 4
    on 1, seamless's MHA): output 1e-5; grads of x, of the memory and of
    every weight 1e-4."""
    jcfg, tcfg = _pair(arch)
    jp = jattn.init_attn(jcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    mem = rng.normal(size=(2, 16, 64)).astype(np.float32)
    pos = jnp.arange(11)

    def jf(p, xx, mm):
        return jattn.attn_train(jcfg, p, xx, pos, memory=mm)
    want = jax.jit(jf)(jp, jnp.asarray(x), jnp.asarray(mem))
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) ** 2), (0, 1, 2)))(
        jp, jnp.asarray(x), jnp.asarray(mem))
    tp = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    tx, tm = _t(x).requires_grad_(True), _t(mem).requires_grad_(True)
    got = tattn.attn_train(tcfg, tp, tx, torch.arange(11), memory=tm)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    got.square().sum().backward()
    for name, g, w in (("x", tx.grad, jg[1]), ("memory", tm.grad, jg[2])):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    for k in tp:
        np.testing.assert_allclose(_np(tp[k].grad), np.asarray(jg[0][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", CROSS)
def test_memory_kv_and_cross_decode_match_jax(arch):
    """``memory_kv`` of a memory and ``cross_decode`` of one token and of
    a prompt over it: 1e-5."""
    jcfg, tcfg = _pair(arch)
    jp = jattn.init_attn(jcfg, jax.random.PRNGKey(7))
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(8)
    mem = rng.normal(size=(3, 16, 64)).astype(np.float32)
    jk, jv = jattn.memory_kv(jcfg, jp, jnp.asarray(mem))
    tk, tv = tattn.memory_kv(tcfg, tp, _t(mem))
    assert tuple(tk.shape) == jk.shape == (3, 16, tcfg.num_kv_heads, 16)
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    for s in (1, 9):
        x = rng.normal(size=(3, s, 64)).astype(np.float32)
        np.testing.assert_allclose(
            _np(tattn.cross_decode(tcfg, tp, _t(x), (tk, tv))),
            np.asarray(jattn.cross_decode(jcfg, jp, jnp.asarray(x),
                                          (jk, jv))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_encoder_flash_route_equals_plain_attend(window):
    """The encoder's inference route (q, k, v through ``flash_attention``
    with ``causal=False``: its plain version on the CPU) against the plain
    ``attend`` of ``attn_train(causal=False)`` in float32: 1e-5, one
    layer and the whole encoder stack; the stack also against JAX's
    ``stack_train(causal=False)``."""
    jcfg, tcfg = _pair("seamless-m4t-medium", window=window)
    jp, tp = _params(jcfg, tcfg, seed=3)
    ecfg = tmodel.encoder_config(tcfg)
    x = np.random.default_rng(9).normal(size=(2, 16, 64)).astype(
        np.float32)
    pos = torch.arange(16)
    a = {k: v[0] for k, v in tp["encoder"]["l0"]["attn"].items()}
    np.testing.assert_allclose(
        _np(tattn.attn_encode(ecfg, a, _t(x), pos)),
        _np(tattn.attn_train(ecfg, a, _t(x), pos, causal=False)),
        atol=1e-5, rtol=1e-5)
    got = ttf.stack_encode(ecfg, tp["encoder"], _t(x), pos)
    np.testing.assert_allclose(
        _np(got), _np(ttf.stack_train(ecfg, tp["encoder"], _t(x), pos,
                                      causal=False)), atol=1e-5, rtol=1e-5)
    want = jtf.stack_train(jmodel.encoder_config(jcfg), jp["encoder"],
                           jnp.asarray(x), jnp.arange(16), causal=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------- params --
@pytest.mark.parametrize("arch", CROSS)
def test_init_params_match_jax(arch):
    """The encoder's and the cross layers' leaves too (the third key of
    ``init_params`` and of ``init_layer``); values equal up to
    ``normal``'s 3 ulps, as tests/test_torch_lm.py holds the others."""
    jcfg, tcfg = _pair(arch)
    want = dict(_leaves(jax.tree.map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(0)))))
    got = dict(_leaves(tmodel.init_params(tcfg, jr.PRNGKey(0), "cpu")))
    assert set(got) == set(want)
    new = {"encoder/l0/attn/wq", "blocks/l0/xattn/wk", "blocks/l0/xnorm"} \
        if tcfg.enc_layers else {"blocks/l4/attn/wq"}
    assert new <= set(got)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and got[name].shape == w.shape
        np.testing.assert_allclose(_np(got[name]), w, atol=2e-7, rtol=1e-6,
                                   err_msg=name)


def test_lm_params_round_trip_with_encoder():
    """seamless's params, the ``encoder`` subtree included, convert bit
    for bit; a tree without it, or with the encoder stacked for another
    depth, is refused."""
    jcfg, tcfg = _pair("seamless-m4t-medium")
    jp, tp = _params(jcfg, tcfg, seed=4)
    host = jax.tree.map(np.asarray, jp)
    want = dict(_leaves(host))
    got = dict(_leaves(tp))
    assert set(got) == set(want) and any(k.startswith("encoder/")
                                         for k in got)
    for name, t in got.items():
        assert np.array_equal(_np(t), want[name]), name
    with pytest.raises(ValueError, match="encoder"):
        lm_params_from_numpy({k: v for k, v in host.items()
                              if k != "encoder"}, tcfg, "cpu")
    with pytest.raises(ValueError, match="encoder/.*superblocks"):
        lm_params_from_numpy(host, dataclasses.replace(tcfg, enc_layers=3),
                             "cpu")
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(host, tconfigs.smoke_config("yi-6b"), "cpu")


# ----------------------------------------------------------- model --
def _serve(cfg, params, model, tokens, memory, gen, jax_side, forced=None):
    """prefill + ``gen`` greedy steps; returns the logits, the tokens and
    the caches after prefill (copied) and after the last step.
    ``forced`` feeds these tokens instead of the model's own."""
    b, s = tokens.shape
    conv = (lambda a: jnp.asarray(a)) if jax_side else _t
    batch = {"tokens": conv(tokens), **{k: conv(v) for k, v in
                                        memory.items()}}
    logits, c = model.prefill(cfg, params, batch, max_len=s + gen)
    first = {k: _np(v) for k, v in _leaves(c)}
    outs, toks = [_np(logits)], []
    for i in range(gen):
        tok = np.argmax(outs[-1], -1).astype(np.int32) if forced is None \
            else forced[i]
        toks.append(tok)
        if jax_side:
            logits, c = model.serve_step(cfg, params, jnp.asarray(tok),
                                         jnp.asarray(s + i, jnp.int32), c)
        else:
            logits, c = model.serve_step(cfg, params, _t(tok), s + i, c)
        outs.append(_np(logits))
    last = {k: _np(v) for k, v in _leaves(c)}
    return np.stack(outs), np.stack(toks), first, last


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_and_serve_steps_match_jax_f32(arch):
    """float32, seeded memory: logits within 1e-4 at prefill and 8 decode
    steps, greedy tokens equal, every cache leaf (``mk``/``mv`` of the
    memory among them) within 1e-5 after prefill and after the steps;
    decode leaves ``mk``/``mv`` as prefill wrote them."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    mem = _memory(tcfg, 2, 10)
    jl, jt, jfirst, jlast = _serve(jcfg, jp, jmodel, tokens, mem, 8, True)
    tl, tt, tfirst, tlast = _serve(tcfg, tp, tmodel, tokens, mem, 8, False)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert np.array_equal(tt, jt)
    assert set(tfirst) == set(jfirst)
    names = [k for k in tfirst if k.endswith(("/mk", "/mv"))]
    assert names
    for got, want in ((tfirst, jfirst), (tlast, jlast)):
        for name in got:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    for name in names:
        assert np.array_equal(tfirst[name], tlast[name]), name
        assert np.abs(tfirst[name]).max() > 0, name


# The bf16 logits of both archs at smoke depth (seamless: 2 encoder and 2
# decoder layers; llama-vision: 10 layers, 2 of them cross) against JAX's
# bf16 logits, and JAX's own bf16 logits against its f32 ones, over three
# seeds (params, tokens and memory): seamless port max 0.041-0.046, mean
# 0.0069-0.0077, p99 0.024-0.027, JAX's spread max 0.033-0.046, mean
# 0.0064-0.0085, p99 0.022-0.029; llama-vision port max 0.067-0.090,
# mean 0.012-0.014, p99 0.042-0.052, JAX's spread max 0.079-0.106, mean
# 0.012-0.016, p99 0.042-0.063 (largest port / JAX ratios: 1.23 max,
# 1.18 p99, 1.15 mean at seamless; 1.03 at llama-vision). The prefill's
# flash route keeps P in float32 where JAX's ``attend`` rounds it to
# bf16, at every encoder and decoder self-attention layer, so both are
# held as jamba is in tests/test_torch_lm.py: to 1.5x JAX's own bf16
# spread (max, mean and p99).
BF16_SPREAD = 1.5


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_and_serve_steps_match_jax_bf16(arch):
    """bf16 compute with seeded memory, both sides fed the JAX side's
    greedy tokens: the logits at prefill and 8 decode steps within 1.5x
    JAX's own bf16-vs-f32 spread (max, mean, 99th percentile;
    ``BF16_SPREAD``), at least 3e-3 (mean) off the port's own f32 logits
    (measured 0.0063-0.0165), and the caches in JAX's dtypes and shapes.
    Cross attention keeps JAX's bf16 scores and P (the plain
    ``attend``)."""
    jcfg, tcfg = _pair(arch, dtype="bfloat16")
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(
        np.int32)
    mem = _memory(tcfg, 2, 11)
    jl, jt, _, _ = _serve(jcfg, jp, jmodel, tokens, mem, 8, True)
    tl, _, tcache, _ = _serve(tcfg, tp, tmodel, tokens, mem, 8, False,
                              forced=jt)
    jl32, _, _, _ = _serve(dataclasses.replace(jcfg, dtype="float32"), jp,
                           jmodel, tokens, mem, 8, True, forced=jt)
    port, bf16 = np.abs(tl - jl), np.abs(jl - jl32)
    f = BF16_SPREAD
    assert port.max() <= f * bf16.max() and port.mean() <= f * bf16.mean()
    assert np.percentile(port, 99) <= f * np.percentile(bf16, 99)
    tl32, _, _, _ = _serve(dataclasses.replace(tcfg, dtype="float32"), tp,
                           tmodel, tokens, mem, 8, False, forced=jt)
    assert np.abs(tl - tl32).mean() >= 3e-3
    _, caches = tmodel.prefill(tcfg, tp, {"tokens": _t(tokens),
                                          **{k: _t(v) for k, v in
                                             mem.items()}}, max_len=32)
    want = dict(_leaves(jtf.init_caches(jcfg, 2, 32, jnp.bfloat16)))
    got = dict(_leaves(caches))
    assert set(got) == set(want) == set(tcache)
    for name, leaf in got.items():
        assert leaf.dtype == torch.bfloat16, name
        assert tuple(leaf.shape) == want[name].shape, name


@pytest.mark.parametrize("arch", CROSS)
def test_loss_and_grads_match_jax(arch):
    """``forward_train`` logits 1e-4, ``loss_fn`` 1e-5 and every leaf's
    grad within 1e-4 of JAX's relative to the leaf's largest grad, the
    encoder's leaves included (each non-zero), with seeded memory and
    the JAX config's remat."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg, seed=1)
    toks = np.random.default_rng(4).integers(0, 512, (2, 18)).astype(
        np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **_memory(tcfg, 2, 12)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        _np(tmodel.forward_train(tcfg, tp, tb)),
        np.asarray(jax.jit(lambda p: jmodel.forward_train(jcfg, p, jb))(jp)),
        atol=1e-4, rtol=1e-4)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb)))(jp)
    tl, tg = value_and_grad(lambda p, b: tmodel.loss_fn(tcfg, p, b), tp, tb)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-5)
    want = dict(_leaves(jax.tree.map(np.asarray, jg)))
    got = dict(_leaves(tg))
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(_np(got[name]) / scale, w / scale,
                                   atol=1e-4, rtol=0, err_msg=name)
    if tcfg.enc_layers:
        assert any(k.startswith("encoder/") for k in got)


@pytest.mark.parametrize("arch", CROSS)
def test_seeded_and_zero_memory_give_different_logits(arch):
    """Zero frames encode to 0 and zero patches give zero k and v: with
    them the cross layers add nothing. Seeded memory must change the
    prefill logits (in both packages, by the same amount within 1e-4),
    which the launchers' zero memory cannot show."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(
        np.int32)
    out = {}
    for zero in (False, True):
        mem = _memory(tcfg, 2, 13, zero=zero)
        out[zero] = (_serve(tcfg, tp, tmodel, tokens, mem, 1, False)[0][0],
                     _serve(jcfg, jp, jmodel, tokens, mem, 1, True)[0][0])
    port, jax_side = (np.abs(out[False][i] - out[True][i]) for i in (0, 1))
    assert port.max() > 0.1
    np.testing.assert_allclose(port, jax_side, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", CROSS)
def test_serve_launcher_prints_the_jax_ids(arch, capsys, monkeypatch):
    """The launchers' zero memory: the same ids as the JAX launcher."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke"])
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    gen = tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert gen.shape == (4, 16)
    assert got[0] == want[0] and got[2] == want[2]

"""The port's LM serving slice against the JAX package on the CPU: the RNG
draws the initialisers and the sampler use, the layers, ``init_params``,
the attention cache paths (GQA and a sliding-window ring buffer),
``prefill`` + ``serve_step`` on smoke configs, the launcher, the configs
and the packing of walks into prompts. Tolerances are stated per test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.corpus import walks_to_lm_tokens as j_walks_to_lm_tokens
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import random as jr
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.corpus import walks_to_lm_tokens
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

ARCHS = ["yi-6b", "minitron-4b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype == \
            torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype ==
                      jnp.bfloat16 else x)


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
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


# ------------------------------------------------------------ RNG --
@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (64, 33), -3.5, 2.25), (7, (4096,), 1e-3, 7.0),
    (2 ** 31 + 5, (3, 5, 7), float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_range_bit_exact(seed, shape, lo, hi):
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo,
                              maxval=hi)
    got = jr.uniform(jr.PRNGKey(seed), shape, lo, hi)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed,shape", [(0, (64, 33)), (3, (1 << 16,)),
                                        (2 ** 31 + 5, (4, 4, 128))])
def test_normal_within_three_ulps(seed, shape):
    """The uniforms under ``normal`` are bit-exact; XLA's erf_inv polynomial
    rounds differently from float32 torch ops on ~1% of draws, by at most
    3 ulps (7.2e-7 abs over 2^20 draws)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = _np(jr.normal(jr.PRNGKey(seed), shape))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 3
    assert (got == want).mean() > 0.97
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,b,v,temp", [(0, 4, 512, 1.0), (5, 3, 64000, 0.7),
                                           (11, 1, 17, 2.0)])
def test_categorical_equals_jax(seed, b, v, temp):
    logits = np.random.default_rng(seed).normal(size=(b, v)).astype(
        np.float32) * 3
    want = jax.random.categorical(jax.random.PRNGKey(seed),
                                  jnp.asarray(logits) / temp)
    got = jr.categorical(jr.PRNGKey(seed), torch.from_numpy(logits) / temp)
    assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- layers --
def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    pos = np.arange(100, 109)
    for theta in (1e4, 5e6):
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                                   rtol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = tlayers.apply_rope(torch.tensor(_np(xb)).to(torch.bfloat16),
                             torch.from_numpy(pos), 1e4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jlayers.apply_rope(
        xb, jnp.asarray(pos), 1e4)), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("arch,act", [("yi-6b", "swiglu"),
                                      ("minitron-4b", "sq_relu"),
                                      ("seamless-m4t-medium", "gelu")])
def test_mlp_and_logits_match_jax(arch, act):
    jcfg, tcfg = _pair(arch)
    assert tcfg.mlp_act == act
    key = jax.random.PRNGKey(3)
    jp = jlayers.init_mlp(jcfg, key)
    tp = tlayers.init_mlp(tcfg, jr.PRNGKey(3))
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=2e-7,
                                   rtol=1e-6)
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    np.testing.assert_allclose(
        _np(tlayers.mlp_apply(tcfg, tp, torch.from_numpy(x))),
        np.asarray(jlayers.mlp_apply(jcfg, jp, jnp.asarray(x))), atol=1e-5,
        rtol=1e-5)
    je = jlayers.init_embed(jcfg, key)
    te = {k: torch.from_numpy(np.asarray(v)) for k, v in je.items()}
    np.testing.assert_allclose(
        _np(tlayers.logits_out(tcfg, te, torch.from_numpy(x))),
        np.asarray(jlayers.logits_out(jcfg, je, jnp.asarray(x))), atol=1e-5,
        rtol=1e-5)
    tok = np.array([[0, 5, 511], [7, 7, 1]])
    np.testing.assert_array_equal(
        _np(tlayers.embed_tokens(tcfg, te, torch.from_numpy(tok))),
        np.asarray(jlayers.embed_tokens(jcfg, je, jnp.asarray(tok))))


# --------------------------------------------------------- params --
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(arch):
    """Same key tree and shapes; values equal up to ``normal``'s 3 ulps."""
    jcfg, tcfg = _pair(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.init_params(tcfg, jr.PRNGKey(0), "cpu")
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(tp))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and got[name].shape == w.shape
        np.testing.assert_allclose(_np(got[name]), w, atol=2e-7, rtol=1e-6,
                                   err_msg=name)


def test_lm_params_round_trip():
    jcfg, tcfg = _pair("yi-6b")
    jp, tp = _params(jcfg, tcfg, seed=4)
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    for name, t in _leaves(tp):
        assert np.array_equal(_np(t), want[name]), name
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                             dataclasses.replace(tcfg, vocab=256), "cpu")
    with pytest.raises(ValueError, match="superblocks"):
        lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                             dataclasses.replace(tcfg, num_layers=4), "cpu")


# ------------------------------------------------------ attention --
@pytest.mark.parametrize("arch,window,s,max_len", [
    ("yi-6b", 0, 12, 20),             # GQA (4 heads on 1 KV head)
    ("minitron-4b", 0, 12, 20),       # GQA 4 on 2
    ("yi-6b", 8, 13, 20),             # ring buffer, prompt past the window
    ("yi-6b", 8, 5, 20)])             # ring buffer, prompt inside it
def test_attn_prefill_and_decode_match_jax(arch, window, s, max_len):
    jcfg, tcfg = _pair(arch, window=window)
    jp = jattn.init_attn(jcfg, jax.random.PRNGKey(2))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    jc = jattn.init_cache(jcfg, 2, max_len, jnp.float32)
    tc = tattn.init_cache(tcfg, 2, max_len, torch.float32)
    assert tuple(tc["k"].shape) == jc["k"].shape
    jo, jc = jattn.attn_prefill(jcfg, jp, jnp.asarray(x), jnp.arange(s), jc)
    to, tc = tattn.attn_prefill(tcfg, tp, torch.from_numpy(x),
                                torch.arange(s), tc)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), atol=1e-5,
                                   rtol=1e-5)
    for pos in range(s, max_len):     # the ring wraps when windowed
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, jc = jattn.attn_decode(jcfg, jp, jnp.asarray(xt),
                                   jnp.asarray(pos, jnp.int32), jc)
        to, tc = tattn.attn_decode(tcfg, tp, torch.from_numpy(xt), pos, tc)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------- model --
def _serve(cfg, params, model, tokens, gen, jax_side, forced=None):
    """prefill + ``gen`` greedy steps; returns the logits and tokens.
    ``forced`` feeds these tokens instead of the model's own."""
    b, s = tokens.shape
    if jax_side:
        logits, c = model.prefill(cfg, params, {"tokens": jnp.asarray(tokens)},
                                  max_len=s + gen)
    else:
        logits, c = model.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(tokens)},
                                  max_len=s + gen)
    outs, toks = [_np(logits)], []
    for i in range(gen):
        tok = np.argmax(outs[-1], -1).astype(np.int32) if forced is None \
            else forced[i]
        toks.append(tok)
        if jax_side:
            logits, c = model.serve_step(cfg, params, jnp.asarray(tok),
                                         jnp.asarray(s + i, jnp.int32), c)
        else:
            logits, c = model.serve_step(cfg, params, torch.from_numpy(tok),
                                         s + i, c)
        outs.append(_np(logits))
    return np.stack(outs), np.stack(toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_jax_f32(arch):
    """f32: logits within 1e-4 at prefill and 8 decode steps, greedy tokens
    equal."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    jl, jt = _serve(jcfg, jp, jmodel, tokens, 8, True)
    tl, tt = _serve(tcfg, tp, tmodel, tokens, 8, False)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert np.array_equal(tt, jt)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_jax_bf16(arch):
    """bf16 compute, both sides fed the JAX side's greedy tokens so that one
    flipped token does not compound. bf16 rounds at other places in the two
    packages (XLA keeps f32 inside its fusions; the JAX model's ``attend``
    rounds scores and probabilities to bf16 where the flash kernel keeps
    f32), so the port's bf16 logits are held to JAX's bf16 logits as
    closely as those sit to JAX's own f32 logits: measured max 0.050-0.054,
    99th percentile 0.027-0.031, mean 0.008-0.009 (logits of rms 1),
    against max 0.064-0.072 and mean 0.011-0.012 between JAX's bf16 and f32
    models. A port that computed in f32 would pass that comparison too, so
    the port's bf16 run must also keep bf16 caches and sit off the port's
    own f32 logits: measured mean 0.0096-0.0102, held to at least 3e-3."""
    jcfg, tcfg = _pair(arch, dtype="bfloat16")
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(
        np.int32)
    jl, jt = _serve(jcfg, jp, jmodel, tokens, 8, True)
    tl, _ = _serve(tcfg, tp, tmodel, tokens, 8, False, forced=jt)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jl32, _ = _serve(jcfg32, jp, jmodel, tokens, 8, True, forced=jt)
    port, bf16 = np.abs(tl - jl), np.abs(jl - jl32)
    assert port.max() <= bf16.max() and port.mean() <= bf16.mean()
    assert np.percentile(port, 99) < 3.5e-2
    tcfg32 = dataclasses.replace(tcfg, dtype="float32")
    tl32, _ = _serve(tcfg32, tp, tmodel, tokens, 8, False, forced=jt)
    assert np.abs(tl - tl32).mean() >= 3e-3
    _, caches = tmodel.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)},
                               max_len=32)
    assert {leaf.dtype for _, leaf in _leaves(caches)} == {torch.bfloat16}


def test_serve_launcher_prints_the_jax_ids(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "yi-6b", "--smoke"])
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    gen = tserve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert gen.shape == (4, 16) and gen.dtype == np.int32
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1].startswith("prefill: ")


def test_serve_launcher_temperature_sampling_matches_jax(capsys,
                                                         monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "minitron-4b",
                                     "--temperature", "0.8", "--gen", "6",
                                     "--seed", "3"])
    jserve.main()
    want = capsys.readouterr().out.splitlines()[2]
    tserve.main(["--arch", "minitron-4b", "--temperature", "0.8", "--gen",
                 "6", "--seed", "3", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[2] == want


@pytest.mark.parametrize("arch,what", [
    ("mamba2-370m", "mamba"), ("jamba-v0.1-52b", "mamba"),
    ("mixtral-8x22b", "MoE"), ("phi3.5-moe-42b-a6.6b", "MoE"),
    ("llama-3.2-vision-11b", "cross-attention"),
    ("seamless-m4t-medium", "encoder-decoder")])
def test_unported_layer_kinds_raise(arch, what):
    cfg = tconfigs.smoke_config(arch)
    with pytest.raises(NotImplementedError, match=what):
        tmodel.init_params(cfg, jr.PRNGKey(0), "cpu")


def test_logit_softcap_raises():
    _, tcfg = _pair("yi-6b", attn_logit_softcap=30.0)
    tp = tmodel.init_params(dataclasses.replace(tcfg, attn_logit_softcap=0.0),
                            jr.PRNGKey(0), "cpu")
    with pytest.raises(NotImplementedError, match="softcap"):
        tmodel.prefill(tcfg, tp, {"tokens": torch.zeros((1, 4), dtype=int)},
                       max_len=6)


def test_init_params_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(tconfigs.smoke_config("yi-6b"), jr.PRNGKey(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "yi-6b"])


# ------------------------------------------------ configs, corpus --
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_are_the_jax_packages(arch):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for get in ("get_config", "smoke_config"):
        t, j = getattr(tconfigs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.num_superblocks == j.num_superblocks
        assert [dataclasses.asdict(s) for s in t.superblock()] == \
            [dataclasses.asdict(s) for s in j.superblock()]
    assert tconfigs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("seq_len,bos", [(33, None), (4096, None), (7, 0)])
def test_walks_to_lm_tokens_equals_jax(seq_len, bos):
    walks = np.random.default_rng(0).integers(0, 1 << 20, (300, 80)).astype(
        np.int32)
    want = j_walks_to_lm_tokens(walks % 64000, seq_len, bos)
    got = walks_to_lm_tokens(walks % 64000, seq_len, bos)
    assert got.dtype == want.dtype and np.array_equal(got, want)

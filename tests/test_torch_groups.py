"""MoE routing groups through the port's model (``num_groups`` in
``forward_train``, ``loss_fn``, ``prefill`` and ``serve_step``) against
the JAX package's on the CPU: float32 loss and prefill / decode logits
within 1e-4, with every MoE call's experts and kept (token, expert) pairs
equal, at 2 and 4 groups."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro_torch.models import model as tmodel
from test_torch_lm import _np, _pair, _params, _record_routes

ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b", "jamba-v0.1-52b"]
B, S, GEN = 4, 16, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(cfg, params, model, tokens, groups, jax_side):
    if jax_side:
        def arr(x):
            return jnp.asarray(x)
    else:
        def arr(x):
            return torch.from_numpy(np.asarray(x))
    logits, c = model.prefill(cfg, params, {"tokens": arr(tokens)},
                              max_len=S + GEN, num_groups=groups)
    outs = [_np(logits)]
    for i in range(GEN):
        tok = np.argmax(outs[-1], -1).astype(np.int32)
        pos = jnp.asarray(S + i, jnp.int32) if jax_side else S + i
        logits, c = model.serve_step(cfg, params, arr(tok), pos, c,
                                     num_groups=groups)
        outs.append(_np(logits))
    return np.stack(outs)


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_groups_match_jax(monkeypatch, arch, groups):
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(groups)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    jseen, tseen = _record_routes(monkeypatch)
    want = float(jmodel.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)},
                                groups))
    got = float(tmodel.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tokens),
                                          "labels": torch.from_numpy(labels)},
                               groups))
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want))
    jl = _serve(jcfg, jp, jmodel, tokens, groups, True)
    tl = _serve(tcfg, tp, tmodel, tokens, groups, False)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    monkeypatch.undo()
    moe_layers = sum(s.ffn == "moe" for s in tcfg.superblock()) * \
        tcfg.num_superblocks
    assert len(jseen) == len(tseen) == moe_layers * (2 + GEN)
    for c, (a, b) in enumerate(zip(jseen, tseen)):
        assert a[0].shape[0] == groups, f"call {c}: groups"
        assert np.array_equal(a[0], b[0]), f"call {c}: experts"
        assert np.array_equal(a[1], b[1]), f"call {c}: kept pairs"


def test_one_group_is_the_default():
    """``num_groups=1`` is what the model ran before it took the argument:
    the same logits bit for bit."""
    _, tcfg = _pair("phi3.5-moe-42b-a6.6b")
    from repro_torch import random as jr
    tp = tmodel.init_params(tcfg, jr.PRNGKey(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (B, S)).astype(np.int32))
    a, _ = tmodel.prefill(tcfg, tp, {"tokens": tokens}, max_len=S)
    b, _ = tmodel.prefill(tcfg, tp, {"tokens": tokens}, max_len=S,
                          num_groups=1)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="num_groups"):
        tmodel.prefill(tcfg, tp, {"tokens": tokens[:, :5]}, max_len=S,
                       num_groups=8)

"""The port's LM training slice against the JAX package on the CPU:
``softmax_xent``, ``_mask_bias`` and ``attn_train`` (causal, window 8,
bidirectional), ``stack_train`` with and without remat, ``loss_fn`` and
the grads of every leaf against ``jax.value_and_grad`` at smoke widths,
AdamW + clipping steps from converted params and optimizer state, and the
launcher's ``--task lm`` against the JAX launcher's (losses, resume, the
checkpoint of ``--ckpt-every``). Float32 throughout; tolerances per test:
1e-5 on losses and 1e-4 on grads and logits, as tests/test_models.py and
the serving tests hold the JAX model."""
import dataclasses
import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jlaunch
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro.optim.grad_utils import clip_by_global_norm as j_clip
from repro.optim.optimizers import adamw as j_adamw
from repro.optim.optimizers import apply_updates as j_apply
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import adam_state_from_numpy, lm_params_from_numpy
from repro_torch.launch import train as launch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.optim.grad_utils import value_and_grad
from repro_torch.optim.optimizers import adamw

ARCHS = ["yi-6b", "minitron-4b", "mamba2-370m", "phi3.5-moe-42b-a6.6b",
         "mixtral-8x22b", "jamba-v0.1-52b"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: its loops of small ops run ~20x
    slower when the test workers' thread pools oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _pairs(jtree, ttree, prefix=""):
    """(path, jax leaf, port leaf) over two trees of one structure."""
    assert set(jtree) == set(ttree), prefix
    for k in sorted(jtree):
        if isinstance(jtree[k], dict):
            yield from _pairs(jtree[k], ttree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, jtree[k], ttree[k]


def _close_trees(jtree, ttree, tol):
    for path, a, b in _pairs(jtree, ttree):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=tol, rtol=tol,
                                   err_msg=path)


@functools.lru_cache(maxsize=None)
def _setup(arch, seed=0, window=None):
    """Both configs, JAX's params (``init_params`` jitted: one compile
    instead of one per op) and the port's, converted. Shared by the tests,
    which change neither."""
    changes = {} if window is None else {"window": window}
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **changes)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), **changes)
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _batch(vocab, b=2, s=17, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        batch["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


# ------------------------------------------------------------ layers --
@pytest.mark.parametrize("mask", [None, "float", "bool", "empty"])
def test_softmax_xent_matches_jax(mask):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    m = None
    if mask == "float":
        m = (rng.random((3, 5)) < 0.5).astype(np.float32)
    elif mask == "bool":
        m = rng.random((3, 5)) < 0.5
    elif mask == "empty":       # the denominator's max(sum, 1)
        m = np.zeros((3, 5), np.float32)
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
    got = tlayers.softmax_xent(_t(logits), _t(labels),
                               None if m is None else _t(m))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("sq,skv,causal,window,offset", [
    (9, 9, True, 0, 0), (9, 9, True, 4, 0), (7, 12, False, 3, 0),
    (5, 12, True, 0, 7), (5, 12, True, 6, 7), (6, 6, False, 0, 0)])
def test_mask_bias_equals_jax(sq, skv, causal, window, offset):
    want = jattn._mask_bias(sq, skv, causal, window, offset)
    got = tattn._mask_bias(sq, skv, causal, window, offset)
    assert got.dtype == torch.float32
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None), (False, 8)])
def test_attn_train_and_grads_match_jax(causal, window):
    """Window 8 overrides the config's 0; ``causal=False`` with no window
    is bidirectional. Output 1e-5, grads of x and every weight 1e-4."""
    jcfg, tcfg, jp, tp = _setup("yi-6b")
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"])
    ta = {k: v[0].clone() for k, v in tp["blocks"]["l0"]["attn"].items()}
    x = np.random.default_rng(2).normal(size=(2, 19, 64)).astype(np.float32)
    pos = np.arange(19)

    def jf(p, xx):
        return jattn.attn_train(jcfg, p, xx, jnp.asarray(pos), causal=causal,
                                window=window)
    want = jax.jit(jf)(ja, jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda p, xx: jnp.sum(jf(p, xx) ** 2), (0, 1)))(
        ja, jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in ta.items()}
    got = tattn.attn_train(tcfg, leaves, tx, _t(pos), causal=causal,
                           window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    got.square().sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg[1]), atol=1e-4,
                               rtol=1e-4)
    for k in ta:
        np.testing.assert_allclose(_np(leaves[k].grad), np.asarray(jg[0][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_training_refuses_what_is_not_ported():
    """Cross attention in training (item 11e), once refused, now runs as
    the JAX package's: ``stack_train(memory=)`` of both cross-attention
    archs over seeded memory with remat on (the memory an argument of each
    checkpointed superblock) within 1e-4 of JAX's, and the memory's grad
    within 1e-4 of JAX's; seamless's ``frames`` reach the encoder's
    leaves through ``loss_fn`` (non-zero grads), and remat on and off give
    ``torch.equal`` losses and grads."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    mem = rng.normal(size=(2, 16, 64)).astype(np.float32)
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-medium"):
        jcfg, tcfg, jp, tp = _setup(arch)
        jcfg = dataclasses.replace(jcfg, remat=True)
        tcfg = dataclasses.replace(tcfg, remat=True)

        def jf(m):
            return jtf.stack_train(jcfg, jp["blocks"], jnp.asarray(x),
                                   jnp.arange(9), memory=m)
        want, jvjp = jax.vjp(jf, jnp.asarray(mem))
        tm = _t(mem).requires_grad_(True)
        got = ttf.stack_train(tcfg, tp["blocks"], _t(x), torch.arange(9),
                              memory=tm)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=arch)
        got.backward(_t(np.asarray(want)))
        np.testing.assert_allclose(_np(tm.grad),
                                   np.asarray(jvjp(want)[0]), atol=1e-4,
                                   rtol=1e-4, err_msg=arch)
    batch = {k: _t(v) for k, v in _batch(tcfg.vocab).items()}
    batch["frames"] = _t(mem)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p, b: tmodel.loss_fn(cfg, p, b), tp, batch)
    assert torch.equal(out[False][0], out[True][0])
    enc = [(path, b) for path, a, b in _pairs(out[False][1], out[True][1])
           if path.startswith("encoder/")]
    assert enc and all(bool(b.abs().max() > 0) for _, b in enc)
    for path, a, b in _pairs(out[False][1], out[True][1]):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_train_remat_changes_nothing(arch):
    """``cfg.remat`` recomputes each superblock in the backward: the loss
    and every grad are ``torch.equal`` to the run without it."""
    _, tcfg, _, tp = _setup(arch)
    batch = {k: _t(v) for k, v in _batch(tcfg.vocab, seed=3).items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p, b: tmodel.loss_fn(cfg, p, b), tp, batch)
    assert torch.equal(out[False][0], out[True][0])
    for path, a, b in _pairs(out[False][1], out[True][1]):
        assert torch.equal(a, b), path


# ---------------------------------------------------- loss and grads --
@pytest.mark.parametrize("arch,mask", [("yi-6b", False),
                                       ("minitron-4b", False),
                                       ("yi-6b", True),
                                       ("mamba2-370m", False),
                                       ("phi3.5-moe-42b-a6.6b", False),
                                       ("mixtral-8x22b", True),
                                       ("jamba-v0.1-52b", False)])
def test_loss_and_grads_match_jax(arch, mask):
    """``forward_train`` logits 1e-4, ``loss_fn`` 1e-5 and the grad of every
    leaf 1e-4 against ``jax.value_and_grad``; the JAX config's remat and
    scan as they are. S = 17, where JAX's mamba grads are finite
    (tests/test_torch_mamba.py holds the port where they are not)."""
    jcfg, tcfg, jp, tp = _setup(arch, 1)
    batch = _batch(jcfg.vocab, seed=4, mask=mask)
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
    _close_trees(jg, tg, 1e-4)


def test_stack_train_matches_jax_at_window_and_bidirectional():
    """The stack with a sliding window (8 < S) and with ``causal=False``."""
    jcfg, tcfg, jp, tp = _setup("yi-6b", window=8)
    x = np.random.default_rng(5).normal(size=(2, 21, 64)).astype(np.float32)
    pos = np.arange(21)
    for causal in (True, False):
        want = jax.jit(lambda b, xx: jtf.stack_train(
            jcfg, b, xx, jnp.asarray(pos), causal=causal))(
            jp["blocks"], jnp.asarray(x))
        got = ttf.stack_train(tcfg, tp["blocks"], _t(x), _t(pos),
                              causal=causal)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


# ------------------------------------------------------------ AdamW --
def _host_state(state):
    return jax.tree.map(np.asarray, state._asdict())


def test_adamw_clip_steps_match_jax():
    """Five ``clip_by_global_norm(., 1.0)`` + AdamW steps at the launcher's
    lr (3e-4), started from JAX's params and from JAX's optimizer state
    after one JAX step (converted): losses 1e-4, grad norms 1e-4, params
    and moments 1e-4. (Adam turns an ulp-sized grad into a step of about
    lr on entries whose moments are near 0, so params are held to a
    fraction of lr.)"""
    jcfg, tcfg, jp, _ = _setup("yi-6b", 2)
    jopt, topt = j_adamw(3e-4), adamw(3e-4)
    batches = [_batch(jcfg.vocab, b=4, s=16, seed=10 + i) for i in range(6)]

    @jax.jit
    def jstep(p, st, b):
        loss, g = jax.value_and_grad(lambda q: jmodel.loss_fn(jcfg, q, b))(p)
        g, norm = j_clip(g, 1.0)
        upd, st = jopt.update(g, st, p)
        return j_apply(p, upd), st, loss, norm

    jst = jopt.init(jp)
    jp, jst, _, _ = jstep(jp, jst, {k: jnp.asarray(v)
                                    for k, v in batches[0].items()})
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tst = adam_state_from_numpy(_host_state(jst), "cpu")
    assert int(tst.count) == 1
    for b in batches[1:]:
        jp, jst, jl, jn = jstep(jp, jst, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        tp, tst, tl, tn = launch.lm_train_step(
            tcfg, topt, tp, tst, {k: _t(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tn), float(jn), atol=1e-4,
                                   rtol=1e-4)
    assert int(tst.count) == int(jst.count) == 6
    _close_trees(jp, tp, 1e-4)
    _close_trees(jst.mu, tst.mu, 1e-4)
    _close_trees(jst.nu, tst.nu, 1e-4)


# --------------------------------------------------------- launcher --
LM_ARGS = ["--task", "lm", "--arch", "yi-6b", "--smoke", "--log-every", "1"]
STEP = re.compile(r"^step\s+(\d+) loss (\S+) gnorm (\S+)", re.M)


def _jax_run(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    jlaunch.main()
    out = capsys.readouterr().out
    return out, [(int(s), float(l), float(g)) for s, l, g in
                 STEP.findall(out)]


def test_launcher_lm_matches_jax_and_resumes(tmp_path, monkeypatch, capsys):
    """``--smoke --steps 5 --ckpt-every 2``: the corpus line and each step's
    loss and grad norm against the JAX launcher's printed ones (1e-4
    beyond their 4 and 3 printed decimals); the checkpoint labelled step 2
    holds three updates in both launchers (the reference's labelling,
    kept); a second run to ``--steps 7`` on the same ``--ckpt-dir``
    restores ``(params, opt_state)`` ``torch.equal`` to the first run's
    and goes on as JAX's resumed run does (its batches drawn from the seed
    again); a third, at ``--steps 3``, runs no step and writes nothing."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    first = launch.main(LM_ARGS + ["--steps", "5", "--ckpt-every", "2",
                                   "--device", "cpu", "--ckpt-dir", port_dir])
    port_out = capsys.readouterr().out
    jax_out, jax_steps = _jax_run(LM_ARGS + ["--steps", "5", "--ckpt-every",
                                             "2", "--ckpt-dir", jax_dir],
                                  monkeypatch, capsys)
    for d in (port_dir, jax_dir):
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000002",
                                         "step_00000004", "step_00000005"]
        with np.load(os.path.join(d, "step_00000002", "arrays.npz")) as z:
            assert [int(z[k]) for k in z.files if z[k].ndim == 0] == [3], d
    _, tcfg, _, tp = _setup("yi-6b")
    (_, state), meta = Checkpointer(port_dir).restore(
        (tp, adamw(3e-4).init(tp)), step=2)
    assert meta["step"] == 2 and int(state.count) == 3
    assert re.search(r"corpus: .*", port_out).group() == \
        re.search(r"corpus: .*", jax_out).group()
    assert [s for s, _, _ in jax_steps] == list(range(5))
    np.testing.assert_allclose(first["losses"], [l for _, l, _ in jax_steps],
                               atol=1e-4 + 5e-5, rtol=0)
    np.testing.assert_allclose(first["gnorms"], [g for _, _, g in jax_steps],
                               atol=1e-4 + 5e-4, rtol=0)
    assert first["restored"] is None and first["start_step"] == 0

    again = launch.main(LM_ARGS + ["--steps", "7", "--device", "cpu",
                                   "--ckpt-dir", port_dir])
    assert "resumed from step 5" in capsys.readouterr().out
    assert again["start_step"] == 5
    params, state = again["restored"]
    for path, a, b in _pairs(first["params"], params):
        assert torch.equal(a, b), path
    assert torch.equal(first["opt_state"].count, state.count)
    for path, a, b in _pairs(first["opt_state"].mu, state.mu):
        assert torch.equal(a, b), path
    for path, a, b in _pairs(first["opt_state"].nu, state.nu):
        assert torch.equal(a, b), path
    _, jax_again = _jax_run(LM_ARGS + ["--steps", "7", "--ckpt-dir",
                                       jax_dir], monkeypatch, capsys)
    assert [s for s, _, _ in jax_again] == [5, 6]
    np.testing.assert_allclose(again["losses"], [l for _, l, _ in jax_again],
                               atol=1e-4 + 5e-5, rtol=0)

    steps = sorted(os.listdir(port_dir))
    last = launch.main(LM_ARGS + ["--steps", "3", "--device", "cpu",
                                  "--ckpt-dir", port_dir])
    out = capsys.readouterr().out
    assert "no step ran" in out and "done" not in out
    assert last["losses"] == [] and last["start_step"] == 7
    assert sorted(os.listdir(port_dir)) == steps


MAMBA_ARGS = ["--task", "lm", "--arch", "mamba2-370m", "--smoke",
              "--log-every", "1", "--steps", "5"]


def test_launcher_lm_mamba_matches_jax(tmp_path, monkeypatch, capsys):
    """``--arch mamba2-370m --smoke`` at ``--seq 32`` (one chunk, where
    JAX's grads are finite): the corpus line and every step's loss and
    grad norm within 1e-4 of the JAX launcher's printed ones (plus their
    printed rounding)."""
    argv = MAMBA_ARGS + ["--seq", "32"]
    got = launch.main(argv + ["--device", "cpu", "--ckpt-dir",
                              str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    jax_out, jax_steps = _jax_run(argv + ["--ckpt-dir", str(tmp_path /
                                                            "jax")],
                                  monkeypatch, capsys)
    assert re.search(r"corpus: .*", port_out).group() == \
        re.search(r"corpus: .*", jax_out).group()
    assert [s for s, _, _ in jax_steps] == list(range(5))
    np.testing.assert_allclose(got["losses"], [l for _, l, _ in jax_steps],
                               atol=1e-4 + 5e-5, rtol=0)
    np.testing.assert_allclose(got["gnorms"], [g for _, _, g in jax_steps],
                               atol=1e-4 + 5e-4, rtol=0)


def test_launcher_lm_mamba_stays_finite_where_jax_goes_nan(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """At the launcher's default ``--seq 128`` a chunk's summed decay
    passes 88 and JAX's grads are NaN from the first step, so its losses
    are NaN from step 1 on (src/repro/models/mamba.py:97's exp of the raw
    difference); the port's step 0 loss equals JAX's (1e-4) and every
    loss and grad norm stays finite."""
    got = launch.main(MAMBA_ARGS + ["--device", "cpu", "--ckpt-dir",
                                    str(tmp_path / "port")])
    capsys.readouterr()
    _, jax_steps = _jax_run(MAMBA_ARGS + ["--ckpt-dir",
                                          str(tmp_path / "jax")],
                            monkeypatch, capsys)
    assert np.isnan(jax_steps[0][2]) and all(
        np.isnan(l) for _, l, _ in jax_steps[1:])
    assert abs(got["losses"][0] - jax_steps[0][1]) <= 1e-4 + 5e-5
    assert np.isfinite(got["losses"]).all() and np.isfinite(
        got["gnorms"]).all()

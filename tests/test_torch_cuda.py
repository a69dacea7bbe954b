"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the fused backend on the card against the CPU.

They skip where no card is present. On a machine with a card (which has
no JAX, so this file imports none and the repository's conftest, which
does, is skipped)::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import PAD_ID
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.kernels import node2vec_step as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _step_inputs(rng, w, d, dp):
    """Sorted candidate rows, prev rows overlapping them, u in the row."""
    deg = rng.integers(1, d + 1, w)
    lane = np.arange(d)[None, :]
    cand = np.sort(rng.integers(0, 1 << 20, (w, d)), axis=1) + np.arange(d)
    cand = np.where(lane < deg[:, None], cand, PAD_ID).astype(np.int32)
    cw = np.where(lane < deg[:, None], rng.random((w, d)) + 0.1,
                  0.0).astype(np.float32)
    pick = cand[np.arange(w)[:, None],
                rng.integers(0, deg[:, None], (w, dp))]
    prev = np.where(rng.random((w, dp)) < 0.5, pick,
                    rng.integers(0, 1 << 20, (w, dp)))
    degp = rng.integers(1, dp + 1, w)
    prev = np.where(np.arange(dp)[None, :] < degp[:, None], prev, PAD_ID)
    prev = np.sort(prev, axis=1).astype(np.int32)
    u = cand[np.arange(w), rng.integers(0, deg)].astype(np.int32)
    return cand, cw, u, prev, rng.random(w).astype(np.float32)


@pytest.mark.parametrize("w,d,dp", [(7, 1, 1), (64, 130, 300),
                                    (4096, 793, 793), (16, 9000, 9000)])
def test_step_kernel_matches_plain(cuda, w, d, dp):
    """The last shape is too wide for shared memory: global scratch."""
    rng = np.random.default_rng(d)
    args = [torch.from_numpy(a).to(cuda) for a in _step_inputs(rng, w, d,
                                                                dp)]
    before = K.node2vec_step.launches
    got = K.node2vec_step(*args, 0.5, 2.0)
    assert K.node2vec_step.launches == before + 1
    assert torch.equal(got, K.node2vec_step_plain(*args, 0.5, 2.0))


@pytest.mark.parametrize("n,d,w,steps", [(64, 1, 7, 5), (2048, 147, 4096, 9),
                                         (30000, 12000, 8, 3)])
def test_walk_kernel_matches_plain(cuda, n, d, w, steps):
    rng = np.random.default_rng(n)
    deg = rng.integers(0, d + 1, n)
    lane = np.arange(d)[None, :]
    adj = np.sort(rng.integers(0, n - d, (n, d)), axis=1) + np.arange(d)
    adj = np.where(lane < deg[:, None], adj, PAD_ID).astype(np.int32)
    wgt = np.where(lane < deg[:, None], rng.random((n, d)) + 0.1,
                   0.0).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (
        adj, wgt, deg.astype(np.int32),
        rng.integers(0, n, w).astype(np.int32),
        rng.integers(0, n, w).astype(np.int32),
        rng.random((w, steps)).astype(np.float32))]
    before = K.node2vec_walk.launches
    got = K.node2vec_walk(*args, 0.5, 2.0)
    assert K.node2vec_walk.launches == before + 1
    assert torch.equal(got, K.node2vec_walk_plain(*args, 0.5, 2.0))


@pytest.mark.parametrize("mode,cap,pipeline", [("exact", 24, False),
                                               ("approx", 24, False),
                                               ("exact", None, True)])
def test_fused_walks_on_card_match_cpu(cuda, mode, cap, pipeline):
    kw = dict(p=0.5, q=2.0, length=8, mode=mode, approx_eps=5e-2, cap=cap,
              pipeline=pipeline)
    spec = "skew:s=4,k=9,deg=20,seed=3"
    cpu = WalkEngine.build(spec, WalkPlan(backend="reference", **kw),
                           device="cpu").run(seed=11).walks
    eng = WalkEngine.build(spec, WalkPlan(backend="fused", **kw))
    before = K.node2vec_step.launches + K.node2vec_walk.launches
    assert np.array_equal(eng.run(seed=11).walks, cpu)
    assert K.node2vec_step.launches + K.node2vec_walk.launches > before

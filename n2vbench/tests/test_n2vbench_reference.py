"""The plain reference: the port's results at a tiny size on the CPU, and
the faults and the lower precision it must catch."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from n2vbench import checks, graphs, reference
from n2vbench.tests import tiny

from repro_torch import random as jr  # noqa: E402  (after tiny's path)
from repro_torch.core.graph import CSRGraph
from repro_torch.engine import WalkEngine, WalkPlan


def test_threefry_known_answers():
    """Random123's threefry2x32-20 known answers, and the port's keys."""
    t = lambda *w: [torch.tensor(x, dtype=torch.int64) for x in w]  # noqa
    assert [int(x) for x in reference.threefry(*t(0, 0, 0, 0))] == \
        [0x6B200159, 0x99BA4EFE]
    m = 0xFFFFFFFF
    assert [int(x) for x in reference.threefry(*t(m, m, m, m))] == \
        [0x1CB996FC, 0xBB002BE7]
    key = reference.key_of(2 ** 31 + 99, "cpu")
    port = jr.PRNGKey(2 ** 31 + 99)
    assert torch.equal(reference.fold(key, 7), jr.fold_in(port, 7))
    assert torch.equal(reference.child(key, 1), jr.split(port)[1])
    assert torch.equal(reference.shuffle(key, 1000),
                       jr.permutation(port, 1000))
    assert torch.equal(reference.randint_below(key, 300, 1 << 20),
                       jr.randint(port, (300,), 0, 1 << 20).long())
    bits = reference.shaped(key, 50, reference.unit_float, torch.float32)
    assert torch.equal(bits, jr.uniform(port, (50,)))


def test_blocked_cumsum_order():
    """Blocks of 16, left to right, then the carries: on values where the
    order shows, the reference equals the port's sampler scan."""
    from repro_torch.engine.sampler import prefix_sum
    x = torch.rand(5, 300, generator=torch.Generator().manual_seed(1))
    x = (x * 1e4).to(torch.float32) ** 3
    assert torch.equal(reference.blocked_cumsum(x), prefix_sum(x))


def test_vose_matches_the_port():
    from repro_torch.core.alias import build_alias
    w = np.random.default_rng(2).random(500) ** 4
    for a, b in zip(reference.vose(w), build_alias(w)):
        assert np.array_equal(a, b)


def _graph(config: str, seed: int = 11):
    c = tiny.cell(config)
    return c.config, graphs.rmat_graph(c.config, seed, "cpu")


def _port_walks(cfg, g, seed, starts, **plan):
    rp, col, wgt = g.numpy()
    kw = dict(cfg["plan"], **plan)
    eng = WalkEngine.build(CSRGraph(g.n, rp, col, wgt), WalkPlan(**kw),
                           device="cpu")
    return eng.run(starts, seed=seed).walks


@pytest.mark.parametrize("name,pipeline", [
    ("er20-walk-rounds", False), ("er20-walk-whole", True),
    ("wec17-walk-fncache", False)])
def test_walks_equal_the_port(name, pipeline):
    cfg, g = _graph(name)
    starts = np.arange(g.n, dtype=np.int32)
    got = _port_walks(cfg, g, 2 ** 31 + 5, starts, pipeline=pipeline)
    sample = [(np.full(g.n, 2 ** 31 + 5, np.int64), starts.astype(np.int64),
               starts.astype(np.int64), got)]
    assert checks.walks_against_reference(g, cfg["plan"], sample) == \
        {"walk_mismatch": 0.0, "walks_wrong": 0}


def test_catches_a_wrong_walk_and_a_wrong_bias():
    cfg, g = _graph("er20-walk-rounds")
    starts = np.arange(g.n, dtype=np.int32)
    ids = starts.astype(np.int64)
    seeds = np.full(g.n, 9, np.int64)
    good = _port_walks(cfg, g, 9, starts)
    bad = good.copy()
    bad[3, 5] = (bad[3, 5] + 1) % g.n
    found = checks.walks_against_reference(g, cfg["plan"],
                                           [(seeds, ids, ids, bad)])
    assert found["walks_wrong"] == 1 and found["walk_mismatch"] > 0
    biased = _port_walks(cfg, g, 9, starts, q=1.0)      # p/q bias off
    found = checks.walks_against_reference(
        g, cfg["plan"], [(seeds, ids, ids, biased)])
    assert found["walk_mismatch"] > 0.01


def test_catches_walks_in_lower_precision():
    cfg, g = _graph("wec17-walk-fncache")
    ids = np.arange(g.n, dtype=np.int64)
    sample = [(np.full(g.n, 4, np.int64), ids, ids, None)]
    want = checks.sampled_walks(g, cfg["plan"], sample)
    low = checks.sampled_walks(g, cfg["plan"], sample, torch.bfloat16)
    assert checks.walk_gaps(low, want)["walk_mismatch"] > 0


def _train_readings(cfg, g, seed):
    """The port trainer's first round, read as a run reads it."""
    from n2vbench.traffic.train_stream import FirstSteps
    from repro_torch.train.stream import StreamingSGNSTrainer
    tr = StreamingSGNSTrainer(vocab=g.n, seed=seed, device="cpu",
                              **cfg["trainer"])
    walks = _port_walks(cfg, g, 3, np.arange(64, dtype=np.int32))
    rec = FirstSteps(tr, cfg["adam"]["b1"])
    tr.consume(walks)
    rec.remove()
    assert tr._opt is rec.opt
    init = reference.init_tables(seed, g.n, cfg["trainer"]["dim"], "cpu")
    got = {"losses": [float(x) for x in tr.loss_history()],
           "grads": rec.grads, "change": rec.change,
           "round_change": {n: float(torch.linalg.vector_norm(
               tr.tables()[n].double() - t0.double()))
               for n, t0 in zip(("emb_in", "emb_out"), init)}}
    return got, torch.from_numpy(walks.astype(np.int64))


def test_sgns_reference_follows_the_port():
    """float32 program, float64 reference: the gaps are round-off; the
    bfloat16 reference and the planted faults read far above them."""
    cfg, g = _graph("er20-train")
    got, walk0 = _train_readings(cfg, g, 2 ** 31 + 1)
    scfg = checks.sgns_config(g, cfg, cfg["trainer"])
    want = reference.sgns_steps(walk0, scfg, 2 ** 31 + 1)
    assert len(got["losses"]) == len(want["losses"]) > checks.FIRST
    gaps = checks.sgns_gaps(got, want)
    assert max(gaps.values()) < 1e-4, gaps
    limits = tiny.cell("er20-train").mix["limits"]
    for kw in (dict(dtype=torch.bfloat16), dict(fault="half_batch"),
               dict(fault="frozen")):
        low = reference.sgns_steps(walk0, scfg, 2 ** 31 + 1, **kw)
        bad = checks.sgns_gaps(checks.reference_readings(low), want)
        assert any(bad[k] > limits[k] for k in bad), (kw, bad)


def test_step_two_reads_the_center_rows_gradient():
    """emb_out starts at 0, so emb_in's first gradient is 0; the second
    step's is not, and a wrong one shows in ``grad_gap``."""
    cfg, g = _graph("er20-train")
    got, walk0 = _train_readings(cfg, g, 2 ** 31 + 2)
    assert got["grads"]["emb_in"][0] == 0 and got["grads"]["emb_in"][1] > 0
    want = reference.sgns_steps(walk0, checks.sgns_config(
        g, cfg, cfg["trainer"]), 2 ** 31 + 2)
    assert checks.sgns_gaps(got, want)["grad_gap"] < 1e-5
    got["grads"]["emb_in"][1] *= 1.01
    assert checks.sgns_gaps(got, want)["grad_gap"] > 1e-3

"""A whole run at a tiny size on the CPU (the harness's look for a chip
skipped): ``correct`` holds for the port as it is, and comes out false
with the timed path broken underneath, once for each fault a cell can
have. The four cells are one chip each, so none has an exchange between
chips to leave out; the training cell's answers that can be altered are
its walks, which the walk faults cover."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from n2vbench.tests import tiny

import repro_torch.engine.engine as engine_mod  # noqa: E402
import repro_torch.kernels.node2vec_step as step_mod  # noqa: E402
import repro_torch.train.stream as stream_mod  # noqa: E402


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    out = tiny.run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"]
                                   for m in tiny.cell(name).end_to_end}


@pytest.mark.parametrize("name", ["er20-walk-rounds", "er20-train"])
def test_traced_run(name):
    """A traced run is judged alike and reads its per-layer metrics (on
    the CPU only those that need no device events)."""
    out = tiny.run(name, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["layout.build_s"]["value"] > 0
    assert out["window_s"] > 0 and out["busy_s"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _stay(pg, u, v, rand, p, q):
    """A superstep that returns its state unchanged: every walker stays."""
    slot, _ = step_mod.node2vec_step_layout_plain(pg, u, v, rand, p, q)
    return slot, v


def _stay_walk(adj, wgt, deg, u0, v1, rand, p, q):
    return v1[:, None].expand(-1, rand.shape[1]).contiguous()


def _half_walkers(run):
    """Half of the batch of walkers left out: the second half walks
    nothing (stays at its start)."""
    def broken(pg, starts, walker_ids, key, sampler, length):
        walks = run(pg, starts, walker_ids, key, sampler, length)
        half = walks.shape[0] // 2
        walks[half:] = starts[half:, None]
        return walks
    return broken


def _altered(run):
    """An answer altered where it is produced: one vertex of one walk."""
    def broken(pg, starts, walker_ids, key, sampler, length):
        walks = run(pg, starts, walker_ids, key, sampler, length).clone()
        walks[:, -1] = (walks[:, -1] + 1) % pg.n
        return walks
    return broken


WALK_FAULTS = {
    "state_unchanged": lambda mp: (
        mp.setattr(step_mod, "node2vec_step_layout", _stay),
        mp.setattr(step_mod, "node2vec_walk", _stay_walk)),
    "half_batch": lambda mp: (
        mp.setattr(engine_mod, "run_reference",
                   _half_walkers(engine_mod.run_reference)),
        mp.setattr(engine_mod, "run_fused_persistent",
                   _half_walkers(engine_mod.run_fused_persistent))),
    "answer_altered": lambda mp: (
        mp.setattr(engine_mod, "run_reference",
                   _altered(engine_mod.run_reference)),
        mp.setattr(engine_mod, "run_fused_persistent",
                   _altered(engine_mod.run_fused_persistent))),
}


@pytest.mark.parametrize("fault", sorted(WALK_FAULTS))
@pytest.mark.parametrize("name", ["er20-walk-rounds", "wec17-walk-fncache",
                                  "er20-walk-whole", "er20-train"])
def test_walk_fault_is_caught(monkeypatch, name, fault):
    WALK_FAULTS[fault](monkeypatch)
    out = tiny.run(name)
    assert not out["correct"], out["checks"]


def _half_batch(grads):
    """Half of the SGNS batch left out, the mean taken over the rest."""
    def broken(params, batch, backend="jnp"):
        keep = torch.zeros_like(batch["valid"])
        keep[:keep.shape[0] // 2] = 1.0
        return grads(params, dict(batch, valid=batch["valid"] * keep),
                     backend)
    return broken


def _frozen(params, updates):
    """An optimizer step that returns its state unchanged."""
    return params


TRAIN_FAULTS = {
    "half_batch": lambda mp: mp.setattr(
        stream_mod, "sgns_grads", _half_batch(stream_mod.sgns_grads)),
    "state_unchanged": lambda mp: mp.setattr(stream_mod, "apply_updates",
                                             _frozen),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_training_fault_is_caught(monkeypatch, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    out = tiny.run("er20-train")
    assert not out["correct"], out["checks"]
    assert np.isfinite([c["value"] for c in out["checks"].values()]).all()

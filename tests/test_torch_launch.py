"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's (``repro.launch.train``, in process on one JAX device) on
the same tiny on-disk edge list: the written ``embeddings.npy`` within
2e-4, dense, ``--shard-tables`` and ``--concat``; resume from the
checkpointed rounds as JAX resumes; ``--task lm`` on an architecture
whose layers are not ported, and a missing card, refused (the LM task
itself: tests/test_torch_lm_train.py)."""
import argparse
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import repro.launch.train as jlaunch
from repro_torch.data.ingest import write_edgelist
from repro_torch.launch import train as launch

ARGS = ["--task", "node2vec", "--p", "1", "--q", "0.5", "--rounds", "2",
        "--walk-length", "8", "--dim", "16", "--window", "3",
        "--negatives", "3", "--sgns-batch", "64"]


@pytest.fixture(scope="module")
def edgelist(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 64, 400), rng.integers(0, 64, 400)
    wgt = ((np.minimum(src, dst) * 31 + np.maximum(src, dst)) % 97
           + 1).astype(np.float32)
    write_edgelist(str(d / "e.txt"), src, dst, wgt)
    return d


def _run(which, d, tag, extra, monkeypatch):
    """One launcher run; returns its embeddings.npy."""
    ckpt = str(d / f"ckpt_{which}_{tag}")
    argv = ARGS + ["--graph", f"edgelist:{d / 'e.txt'},relabel=degree",
                   "--graph-cache", str(d / f"cache_{which}"),
                   "--ckpt-dir", ckpt] + extra
    if which == "jax":
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        jlaunch.main()
    else:
        launch.main(argv + ["--device", "cpu"])
    return np.load(os.path.join(ckpt, "embeddings.npy"))


@pytest.mark.parametrize("extra", [[], ["--shard-tables"],
                                   ["--shard-tables", "--sgns-backend",
                                    "fused"], ["--concat"]],
                         ids=["dense", "shard", "shard-fused", "concat"])
def test_launcher_matches_jax(edgelist, extra, monkeypatch):
    tag = "-".join(extra) or "dense"
    got = _run("port", edgelist, tag, extra, monkeypatch)
    want = _run("jax", edgelist, tag, extra, monkeypatch)
    assert got.shape == want.shape == (64, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_resume_matches_jax(edgelist, monkeypatch, capsys):
    """A second run on the same --ckpt-dir walks nothing (every round is
    in the checkpoint) and writes the same embeddings, in both packages."""
    extra = ["--shard-tables"]
    out = {}
    for which in ("port", "jax"):
        first = _run(which, edgelist, "resume", extra, monkeypatch)
        ckpt = edgelist / f"ckpt_{which}_resume"
        steps = sorted(p for p in os.listdir(ckpt) if p.startswith("step_"))
        again = _run(which, edgelist, "resume", extra, monkeypatch)
        assert sorted(p for p in os.listdir(ckpt)
                      if p.startswith("step_")) == steps
        assert np.array_equal(first, again), which
        out[which] = (first, steps)
    assert out["port"][1] == out["jax"][1] == ["step_00000001",
                                               "step_00000002"]
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0,
                               atol=2e-4)
    printed = capsys.readouterr().out
    assert "train[jnp]: 2 rounds" in printed


def test_lm_task_is_not_ported(tmp_path):
    """``--task lm`` runs (item 11b); an architecture with layers the port
    does not run yet still raises, naming its item, before any step."""
    with pytest.raises(NotImplementedError, match="item 11d"):
        launch.main(["--task", "lm", "--arch", "mamba2-370m", "--smoke",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_launcher_needs_a_card_or_the_cpu(edgelist, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(ARGS + ["--graph", f"edgelist:{edgelist / 'e.txt'}",
                            "--ckpt-dir", str(edgelist / "nocard")])
    assert not os.path.exists(edgelist / "nocard" / "embeddings.npy")


def test_parser_keeps_the_jax_flags_and_defaults(monkeypatch):
    """The same flags and defaults as the JAX launcher's parser, the LM
    task's among them, besides --device and the port's own --ckpt-dir
    default under the temp dir."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        seen.update(vars(real(self, *a, **k)))
        raise SystemExit(0)
    monkeypatch.setattr(sys, "argv", ["train"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jlaunch.main()
    monkeypatch.undo()
    port = vars(launch.parser().parse_args([]))
    assert port.pop("device") is None
    assert port.pop("ckpt_dir") == os.path.join(tempfile.gettempdir(),
                                                "repro_torch_ckpt")
    assert seen.pop("ckpt_dir") == "/tmp/repro_ckpt"
    assert port == seen
    for flag in ("arch", "smoke", "steps", "batch", "seq", "lr", "ckpt_every",
                 "log_every"):     # the JAX parser's LM task flags
        assert flag in port

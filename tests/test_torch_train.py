"""The port's streamed SGNS trainer against the JAX package on the CPU:
device pairs, negatives and permutation grids (exact), the five contracts
of tests/test_train.py, checkpoint/resume of the round runner, and
train_streamed end to end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alias import build_alias as j_build_alias
from repro.core.node2vec import Node2VecConfig as JConfig
from repro.data import open_graph as j_open_graph
from repro.runtime.fault_tolerance import WalkRoundRunner as JRunner
from repro.train import StreamingSGNSTrainer as JTrainer
from repro.train import device_negatives as j_negatives
from repro.train import device_pairs as j_pairs
from repro.train import num_pairs as j_num_pairs
from repro.train import train_streamed as j_train_streamed
from repro.train.stream import _perm_batches as j_perm_batches
from repro_torch import random as jr
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.node2vec import Node2VecConfig
from repro_torch.data.corpus import sgns_pairs
from repro_torch.data.store import open_graph
from repro_torch.engine import WalkEngine, WalkPlan, round_seed
from repro_torch.kernels.sgns import sgns_fused
from repro_torch.runtime.fault_tolerance import (WalkRoundRunner,
                                                 elastic_restart)
from repro_torch.train.pairs import (device_negatives, device_pairs,
                                     num_pairs)
from repro_torch.train.stream import (StreamingSGNSTrainer, _perm_batches,
                                      train_streamed)

SPEC = "wec:k=7,deg=10,seed=1"      # 128 vertices


def _kw(**kw):
    base = dict(p=0.5, q=2.0, walk_length=10, num_walks=3, window=4,
                dim=16, negatives=3, batch_size=256, seed=0)
    base.update(kw)
    return base


def _cfg(**kw):
    return Node2VecConfig(**_kw(**kw))


@pytest.fixture(scope="module")
def graph():
    return open_graph(SPEC).graph


@pytest.fixture(scope="module")
def rounds(graph):
    return list(WalkRoundRunner(graph, _cfg(), device="cpu").rounds())


@pytest.fixture(scope="module")
def jax_streamed():
    """The JAX package's train_streamed on SPEC, both SGNS backends."""
    g = j_open_graph(SPEC).graph
    out = {}
    for backend in ("jnp", "fused"):
        emb, st = j_train_streamed(g, JConfig(**_kw(sgns_backend=backend,
                                                    epochs=2)))
        out[backend] = (np.asarray(emb), st)
    return out


# ------------------------------------------------- pairs and negatives --
@pytest.mark.parametrize("w,l,window,seed", [
    (1, 2, 1, 0), (4, 8, 3, 1), (16, 12, 5, 2), (7, 5, 10, 3), (3, 2, 4, 4),
])
def test_device_pairs_match_jax_and_host(w, l, window, seed):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, 50, (w, l)).astype(np.int32)
    walks[:, -1] = walks[:, -2]
    c, x, valid = (t.numpy() for t in device_pairs(torch.from_numpy(walks),
                                                   window))
    jc, jx, jv = (np.asarray(a) for a in j_pairs(jnp.asarray(walks), window))
    assert num_pairs(w, l, window) == j_num_pairs(w, l, window) == len(c)
    assert np.array_equal(c, jc) and np.array_equal(x, jx)
    assert np.array_equal(valid, jv)
    hc, hx = sgns_pairs(walks, window)
    assert np.array_equal(c[valid], hc) and np.array_equal(x[valid], hx)


@pytest.mark.parametrize("vocab,shape,seed", [(3, (40000,), 0),
                                              (400, (256, 5), 7),
                                              (131_071, (64, 3), 11)])
def test_device_negatives_match_jax(vocab, shape, seed):
    counts = np.random.default_rng(seed).random(vocab) * 100
    prob, alias = j_build_alias(counts ** 0.75)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(j_negatives(key, jnp.asarray(prob), jnp.asarray(alias),
                                  shape))
    got = device_negatives(jr.fold_in(jr.PRNGKey(seed), 3),
                           torch.from_numpy(prob), torch.from_numpy(alias),
                           shape)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,batch", [(1, 4), (70, 16), (7680, 256),
                                     (70_000, 1024)])
def test_perm_batches_match_jax(n, batch):
    steps = -(-n // batch)
    want = np.asarray(j_perm_batches(jax.random.PRNGKey(n), n, steps, batch))
    got = _perm_batches(jr.PRNGKey(n), n, steps, batch)
    assert got.shape == (steps, batch)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------- streamed == concat --
def test_streamed_matches_concat(graph):
    cfg = _cfg(epochs=2)
    streamed = StreamingSGNSTrainer.from_config(graph.n, cfg, device="cpu")
    emb_s, st_s = streamed.train(
        WalkRoundRunner(graph, cfg, device="cpu").rounds())
    rounds = list(WalkRoundRunner(graph, cfg, device="cpu").rounds())
    concat = StreamingSGNSTrainer.from_config(graph.n, cfg, device="cpu")
    emb_c, st_c = concat.train(iter(rounds))
    assert np.array_equal(emb_s, emb_c)
    assert np.array_equal(streamed.loss_history(), concat.loss_history())
    assert st_s.steps == st_c.steps and st_s.pairs == st_c.pairs


def test_fused_streamed_matches_jnp_streamed(graph, rounds):
    cfg = _cfg()
    emb, losses = {}, {}
    for backend in ("jnp", "fused"):
        tr = StreamingSGNSTrainer.from_config(graph.n, cfg, device="cpu",
                                              sgns_backend=backend)
        emb[backend], _ = tr.train(iter(rounds[:2]))
        losses[backend] = tr.loss_history()
    np.testing.assert_allclose(losses["jnp"], losses["fused"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(emb["jnp"], emb["fused"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_train_streamed_matches_jax(jax_streamed, backend):
    """Same walks, pairs, permutations, negatives and init as the JAX
    package; the tables differ only by float rounding."""
    before = sgns_fused.launches
    emb, st = train_streamed(SPEC, _cfg(sgns_backend=backend, epochs=2),
                             device="cpu")
    assert sgns_fused.launches == before
    want, jst = jax_streamed[backend]
    np.testing.assert_allclose(emb, want, rtol=2e-4, atol=2e-4)
    for f in ("backend", "rounds", "steps", "pairs", "tokens", "h2d_bytes",
              "h2d_bytes_concat", "shards", "collective_bytes"):
        assert getattr(st, f) == getattr(jst, f), f


def _round_curves(losses, rounds):
    """Per round, the mean loss over each 5% window of its steps."""
    per = len(losses) // rounds
    win = max(1, per // 20)
    return [[float(part[i:i + win].mean())
             for i in range(0, per - win + 1, win)]
            for part in np.asarray(losses).reshape(rounds, per)]


def test_loss_curve_at_path_c_widths_matches_jax():
    """chip_smoke.py path C's trainer (D=128, K=5, B=1024, window 10,
    dense Adam at lr 0.025, fused backend) on two rounds of its walks
    (every 128th vertex, p=1, q=0.5, length 80) on a wec graph cut to
    8,192 vertices. The port's per-step losses follow the JAX package's,
    and in both the loss falls within each round (to at most 0.9 of where
    the round began, path C's gate) and jumps where round 1 begins."""
    eng = WalkEngine.build("wec:k=13,deg=100,seed=0", WalkPlan(
        p=1.0, q=0.5, length=80, cap=128, backend="reference"),
        device="cpu")
    starts = np.arange(0, eng.pg.n, 128, dtype=np.int32)
    walks = [eng.run(starts=starts, seed=round_seed(0, r)).walks
             for r in range(2)]
    kw = dict(dim=128, window=10, negatives=5, batch_size=1024, lr=0.025,
              epochs=1, sgns_backend="fused")
    port = StreamingSGNSTrainer(eng.pg.n, device="cpu", **kw)
    port.train(iter(walks))
    ref = JTrainer(eng.pg.n, **kw)
    ref.train(iter(walks))
    got, want = port.loss_history(), np.asarray(ref.loss_history())
    assert got.shape == want.shape and len(got) % 2 == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for losses in (got, want):
        curves = _round_curves(losses, 2)
        for curve in curves:
            assert curve[-1] <= 0.9 * curve[0]
        assert curves[1][0] > curves[0][-1]


def test_train_stats_accounting(graph, rounds):
    cfg = _cfg(num_walks=2, epochs=2)
    trainer = StreamingSGNSTrainer.from_config(graph.n, cfg, device="cpu")
    _, st = trainer.train(iter(rounds[:2]))
    want_pairs = want_steps = want_h2d = want_concat = 0
    per_step = 4 * cfg.batch_size * (3 + cfg.negatives)
    for w in rounds[:2]:
        want_pairs += len(sgns_pairs(w, cfg.window)[0]) * cfg.epochs
        steps = -(-num_pairs(*w.shape, cfg.window) // cfg.batch_size)
        want_steps += steps * cfg.epochs
        want_h2d += w.astype(np.int32).nbytes + graph.n * 8
        want_concat += steps * cfg.epochs * per_step
    assert (st.pairs, st.steps, st.h2d_bytes, st.h2d_bytes_concat) == \
        (want_pairs, want_steps, want_h2d, want_concat)
    assert st.tokens == sum(w.size for w in rounds[:2])
    assert st.rounds == 2 and st.backend == "jnp" and st.shards == 1
    assert 0.0 <= st.overlap_efficiency <= 1.0
    assert st.pairs_per_sec > 0 and st.wall_seconds > 0
    # and equal to the JAX package's accounting of the same rounds
    jt = JTrainer.from_config(graph.n, JConfig(**_kw(num_walks=2, epochs=2)))
    _, jst = jt.train(iter(rounds[:2]))
    for f in ("rounds", "steps", "pairs", "tokens", "h2d_bytes",
              "h2d_bytes_concat"):
        assert getattr(st, f) == getattr(jst, f), f


def test_empty_round_is_counted(graph):
    tr = StreamingSGNSTrainer(graph.n, dim=8, window=3, negatives=2,
                              batch_size=16, device="cpu")
    tr.consume(np.zeros((5, 1), np.int32))      # length 1: no pairs
    emb, st = tr.finish()
    assert (st.rounds, st.steps, st.pairs, st.tokens) == (1, 0, 0, 5)
    assert emb.shape == (graph.n, 8) and len(tr.loss_history()) == 0


# ------------------------------------------------------ runner / resume --
def test_rounds_match_jax_runner(graph, rounds):
    want = list(JRunner(j_open_graph(SPEC).graph, JConfig(**_kw())).rounds())
    assert len(rounds) == len(want) == 3
    for a, b in zip(rounds, want):
        assert np.array_equal(a, b)


def test_rounds_resume_bit_identical(tmp_path, graph, rounds):
    cfg = _cfg()
    ck = Checkpointer(str(tmp_path))
    runner = WalkRoundRunner(graph, cfg, checkpointer=ck, device="cpu")
    it = runner.rounds()
    next(it), next(it)
    del it, runner      # crash after 2 rounds
    ck.wait()
    assert ck.latest_step() == 2
    resumed = elastic_restart(graph, cfg, Checkpointer(str(tmp_path)),
                              device="cpu")
    assert resumed.completed_rounds() == 2
    got = list(resumed.rounds())
    assert len(got) == cfg.num_walks
    for a, b in zip(got, rounds):
        assert np.array_equal(a, b)
    assert resumed.stats_summary()["dropped"] == 0
    assert np.array_equal(resumed.run_round(1), rounds[1])
    resumed.submit_update([])          # an empty queue drains to nothing
    resumed._drain_updates()
    assert resumed.update_reports == [] and resumed.engine.store.version == 0


def test_resumed_training_equals_uninterrupted(tmp_path, graph):
    cfg = _cfg(num_walks=2)
    emb_full, _ = train_streamed(graph, cfg, device="cpu")
    ck = Checkpointer(str(tmp_path))
    it = WalkRoundRunner(graph, cfg, checkpointer=ck, device="cpu").rounds()
    next(it)
    del it
    ck.wait()
    emb_resumed, st = train_streamed(graph, cfg, device="cpu",
                                     checkpointer=Checkpointer(str(tmp_path)))
    assert st.rounds == 2
    assert np.array_equal(emb_full, emb_resumed)


def test_checkpointer_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore((np.zeros(1),))
    tree = {"emb": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": (torch.tensor(3, dtype=torch.int32),
                    {"mu": np.ones((2, 2), np.float32)})}
    ck.save(1, tree, meta={"round": 1})
    ck.save(2, {"emb": tree["emb"] * 2, "opt": tree["opt"]},
            blocking=False)
    ck.wait()
    assert ck.latest_step() == 2
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    got, meta = ck.restore(tree)
    assert meta["step"] == 2 and meta["keys"] == ["emb", "opt/0", "opt/1/mu"]
    assert isinstance(got["emb"], torch.Tensor)
    assert torch.equal(got["emb"], tree["emb"] * 2)
    assert int(got["opt"][0]) == 3
    assert isinstance(got["opt"][1]["mu"], np.ndarray)
    old, meta = ck.restore(tree, step=1)
    assert torch.equal(old["emb"], tree["emb"]) and meta["round"] == 1


def test_shard_tables_not_ported(graph):
    with pytest.raises(NotImplementedError, match="item 9"):
        StreamingSGNSTrainer(graph.n, shard_tables=True, device="cpu")

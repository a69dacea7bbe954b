"""The port's sharded SGNS tables across a 2-process gloo world, on the
CPU: one epoch, the streamed trainer and the training launcher at world 2
give the tables and embeddings of world 1 bit for bit (DESIGN.md §16's
invariant, JAX's 2-device bit-identity tests), and stay within the JAX
package's 1-shard results by today's tolerances; unique buffers capped at
the table's rows change nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.alias import build_alias
from repro.core.skipgram import SGNSConfig as JSGNSConfig
from repro.core.skipgram import init_params as j_init_params
from repro.launch.mesh import make_table_mesh as j_table_mesh
from repro.optim.optimizers import adam_rows as j_adam_rows
from repro.train import StreamingSGNSTrainer as JTrainer
from repro.train import shard_opt_state as j_shard_opt_state
from repro.train import shard_params as j_shard_params
from repro.train import train_epoch_sharded as j_train_epoch_sharded
from repro_torch import random as jr
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import train as launch
from repro_torch.optim.optimizers import adam_rows
from repro_torch.train.shard import (pow2_bucket, table_rows,
                                     train_epoch_sharded, unique_rows)
from repro_torch.train.stream import StreamingSGNSTrainer

from torch_world import World

V, D, B, K, STEPS = 67, 8, 16, 3, 4
KW = dict(dim=16, window=3, negatives=3, batch_size=64)


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


def _epoch_inputs(batch=B):
    rng = np.random.default_rng(0)
    n = STEPS * batch - 5
    c = rng.integers(0, V, STEPS * batch).astype(np.int32)
    x = rng.integers(0, V, STEPS * batch).astype(np.int32)
    valid = rng.random(STEPS * batch) < 0.9
    perm2d = rng.permutation(STEPS * batch).astype(np.int32).reshape(
        STEPS, batch)
    prob, alias = build_alias(rng.random(V) + 0.1)
    params = {k: np.asarray(v) for k, v in j_init_params(
        JSGNSConfig(vocab=V, dim=D, negatives=K),
        jax.random.PRNGKey(0)).items()}
    return n, dict(c=c, x=x, valid=valid, perm2d=perm2d, prob=prob,
                   alias=alias), params


def _world_one_epoch(params, args, **kw):
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = adam_rows(0.025)
    a = {k: torch.from_numpy(v) for k, v in args.items()}
    return train_epoch_sharded(
        tp, opt.init(tp), a["c"], a["x"], a["valid"], a["perm2d"],
        a["prob"], a["alias"], jr.PRNGKey(3), opt=opt, **kw)


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_world_two_epoch_equals_world_one(world, backend):
    """Each rank's epoch on its row blocks, gathered: ``torch.equal`` to
    the world-1 epoch (tables, moments, losses), and within 2e-4 of JAX's
    1-shard epoch."""
    n, args, params = _epoch_inputs()
    kw = dict(negatives=K, backend=backend, n_pairs=n,
              u_in=pow2_bucket(B), u_out=pow2_bucket(B * (1 + K)))
    p1, s1, l1 = _world_one_epoch(params, args, **kw)
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    state = dict(count=0, mu=zeros, nu=zeros)
    a = dict(args, key=jr.PRNGKey(3).numpy())
    out = world.run("torch_world:epoch", params, state, a,
                    dict(kw, lr=0.025))
    for tabs, mu, nu, losses in out:
        assert np.array_equal(losses, l1.numpy())
        for k in params:
            assert tabs[k].shape == (table_rows(V, 2), D)
            assert np.array_equal(tabs[k][:V], p1[k].numpy())
            assert np.array_equal(mu[k][:V], s1.mu[k].numpy())
            assert np.array_equal(nu[k][:V], s1.nu[k].numpy())
            assert not tabs[k][V:].any()
    mesh = j_table_mesh(max_shards=1)
    jp = j_shard_params({k: jnp.asarray(v) for k, v in params.items()}, V,
                        mesh)
    jp2, _, jl = j_train_epoch_sharded(
        jp, j_shard_opt_state(jp, mesh), *map(jnp.asarray, (
            args["c"], args["x"], args["valid"], args["perm2d"],
            args["prob"], args["alias"])), jax.random.PRNGKey(3),
        mesh=mesh, opt=j_adam_rows(0.025), **kw)
    for k in params:
        np.testing.assert_allclose(out[0][0][k][:V], np.asarray(jp2[k]),
                                   rtol=0, atol=2e-4)
    np.testing.assert_allclose(out[0][3], np.asarray(jl), rtol=0, atol=1e-4)


@pytest.mark.parametrize("world_rows", [1, 2])
def test_capped_unique_buffers_equal_uncapped(world, world_rows):
    """Buffers capped at the padded table's rows (a set of distinct ids
    never holds more) give the uncapped buffers' tables exactly."""
    batch = 64                       # 64 centre and 256 context ids, V=67
    n, args, params = _epoch_inputs(batch)
    vp = table_rows(V, world_rows)
    capped = dict(u_in=unique_rows(batch, vp),
                  u_out=unique_rows(batch * (1 + K), vp))
    assert capped == dict(u_in=64, u_out=vp)
    runs = []
    for u in (capped, dict(u_in=pow2_bucket(batch),
                           u_out=pow2_bucket(batch * (1 + K)))):
        kw = dict(negatives=K, backend="jnp", n_pairs=n, **u)
        if world_rows == 1:
            p, s, l = _world_one_epoch(params, args, **kw)
            runs.append(({k: v.numpy() for k, v in p.items()}, l.numpy()))
        else:
            zeros = {k: np.zeros_like(v) for k, v in params.items()}
            tabs, _, _, l = world.run(
                "torch_world:epoch", params, dict(count=0, mu=zeros,
                                                  nu=zeros),
                dict(args, key=jr.PRNGKey(3).numpy()),
                dict(kw, lr=0.025))[0]
            runs.append((tabs, l))
    for k in params:
        assert np.array_equal(runs[0][0][k], runs[1][0][k])
    assert np.array_equal(runs[0][1], runs[1][1])


def _rounds(vocab, n=2, w=32, l=9, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (w, l)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_world_two_trainer_equals_world_one(world, backend):
    """The streamed sharded trainer at world 2: embeddings, whole tables
    and losses equal world 1's on every rank, ``world_shards()`` is 2, and
    the result is within 2e-4 of JAX's 1-shard trainer."""
    rounds = _rounds(129)
    kw = dict(KW, sgns_backend=backend)
    one = StreamingSGNSTrainer(129, shard_tables=True, device="cpu", **kw)
    assert one._u_out == 129 < pow2_bucket(64 * 4)     # capped at the rows
    emb1, st1 = one.train(iter(rounds))
    for emb, tables, losses, shards, world_size in world.run(
            "torch_world:trainer", 129, rounds, kw):
        assert (shards, world_size) == (2, 2)
        assert np.array_equal(emb, emb1)
        assert np.array_equal(losses, one.loss_history())
        for k in ("emb_in", "emb_out"):
            assert np.array_equal(tables[k][:129], one.params[k].numpy())
            assert not tables[k][129:].any()
    jt = JTrainer(129, mesh=j_table_mesh(max_shards=1), shard_tables=True,
                  **{k: v for k, v in KW.items()})
    jemb, _ = jt.train(iter(rounds))
    np.testing.assert_allclose(emb, np.asarray(jemb), rtol=0, atol=2e-4)
    assert st1.shards == 1


def test_table_mesh_prefix_leaves_other_ranks_out(world):
    """``make_table_mesh(max_shards=1)`` trains on rank 0 alone (a world
    of one inside the world of two); rank 1 holds no shard and refuses."""
    with pytest.raises(RuntimeError, match="holds no shard") as e:
        world.run("torch_world:trainer", 129, _rounds(129, n=1), KW, 1)
    assert "rank 1" in str(e.value) and "rank 0" not in str(e.value)


@pytest.mark.parametrize("extra", [["--shard-tables"],
                                   ["--shard-tables", "--sgns-backend",
                                    "fused"],
                                   []])
def test_launcher_world_two_equals_world_one(world, tmp_path, extra):
    """``launch.train.main`` in the world (the default group is the
    caller's): sharded walks and tables, rank 0 alone writing; the
    embeddings equal the same command's at world 1."""
    base = ["--task", "node2vec", "--device", "cpu", "--graph",
            "wec:k=7,deg=10,seed=2", "--rounds", "2", "--walk-length", "6",
            "--dim", "8", "--window", "2", "--negatives", "2",
            "--sgns-batch", "64", "--q", "0.5"] + extra
    two = tmp_path / "two"
    embs = world.run("torch_world:launcher",
                     base + ["--ckpt-dir", str(two)])
    one = launch.main(base + ["--ckpt-dir", str(tmp_path / "one")])
    saved = np.load(two / "embeddings.npy")
    assert np.array_equal(saved, np.load(tmp_path / "one" / "embeddings.npy"))
    for emb in embs:
        assert np.array_equal(emb, one)
    assert Checkpointer(str(two)).latest_step() == 2    # rank 0's rounds


def test_launcher_under_torchrun_equals_world_one(tmp_path):
    """Without a caller's group the launcher starts one from torchrun's
    environment (gloo for ``--device cpu``) and tears it down; its
    ``embeddings.npy`` equals the same command's at world 1."""
    import os
    import subprocess
    import sys
    base = ["--task", "node2vec", "--device", "cpu", "--graph",
            "wec:k=7,deg=10,seed=2", "--rounds", "2", "--walk-length", "6",
            "--dim", "8", "--window", "2", "--negatives", "2",
            "--sgns-batch", "64", "--shard-tables"]
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "repro_torch.launch.train", *base,
         "--ckpt-dir", str(tmp_path / "two")], capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=src,
                                         OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "shards: 2 table shards" in r.stdout
    one = launch.main(base + ["--ckpt-dir", str(tmp_path / "one")])
    assert np.array_equal(np.load(tmp_path / "two" / "embeddings.npy"), one)

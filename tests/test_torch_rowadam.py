"""The port's lazy row-Adam trainer (``StreamingSGNSTrainer(...,
shard_tables=True)``, ``repro_torch.train.shard``) held to a plain
float64 trainer of the same rule (``tests/plain_sgns_rows.py``) on the
CPU, at a size where a step names a minority of the rows: V=512, B=32,
K=3, D=8, two rounds. ``tests/test_torch_shard.py`` holds the same path
to the JAX package; this file holds it to the rule itself."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_sgns_rows as plain
from repro_torch.train.stream import StreamingSGNSTrainer

VOCAB, DIM, WINDOW, NEGS, BATCH, LR, SEED = 512, 8, 3, 3, 32, 0.025, 2 ** 31 + 9
# the port's float32 losses against float64 ones: each loss is a mean of
# B softplus terms of D-long dot products, a few float32 roundings
# (~6e-8 each) deep, and the tables feeding it drift by TABLE_TOL
LOSS_TOL = 1e-5
# the port's float32 tables against float64 ones, as the distance over
# the reference's change. The port takes Adam's bias corrections in
# float32: 1 - 0.999^t at t=1 is 0.00099998713, 1.3e-5 off, 6.4e-6 under
# the square root, which scales the early updates of every row alike
# (7.4e-6 read here); rounding adds ~1e-6 (a float32 plain trainer reads
# 1.3e-6). Four times the former; bfloat16 reads 4e-2.
TABLE_TOL = 3e-5


def _rounds(n=2):
    """Walks over the first 400 vertices, so rows 400..511 are never
    walked, never drawn as negatives and never named."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, 400, size=(8, 10)).astype(np.int32)
            for _ in range(n)]


def _port(rounds, backend):
    tr = StreamingSGNSTrainer(VOCAB, dim=DIM, window=WINDOW, negatives=NEGS,
                              batch_size=BATCH, lr=LR, seed=SEED,
                              sgns_backend=backend, shard_tables=True,
                              device="cpu")
    for walks in rounds:
        tr.consume(walks)
    return [float(x) for x in tr.loss_history()], tr.tables()


def _plain(rounds, **kw):
    return plain.train(rounds, VOCAB, DIM, WINDOW, NEGS, BATCH, LR, SEED,
                       **kw)


def _gaps(losses, tables, want) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
    init = dict(zip(plain.TABLES, plain.init_tables(SEED, VOCAB, DIM)))
    table = max(
        float((tables[n].double() - want["tables"][n].double()).norm()
              / (want["tables"][n].double() - init[n].double()).norm())
        for n in plain.TABLES)
    return {"loss": loss, "table": table}


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_port_follows_the_plain_trainer(backend):
    rounds = _rounds()
    losses, tables = _port(rounds, backend)
    want = _plain(rounds)
    assert len(losses) == len(want["losses"]) == 24
    for n in plain.TABLES:
        share = float(want["named"][n].float().mean())
        assert 0 < share < 0.8, (n, share)
    gaps = _gaps(losses, tables, want)
    assert gaps["loss"] < LOSS_TOL and gaps["table"] < TABLE_TOL, gaps


def test_unnamed_rows_keep_their_initial_bits():
    rounds = _rounds()
    _, tables = _port(rounds, "fused")
    want = _plain(rounds)
    init = dict(zip(plain.TABLES, plain.init_tables(SEED, VOCAB, DIM)))
    for n in plain.TABLES:
        quiet = ~want["named"][n]
        assert quiet[400:].all()
        assert torch.equal(tables[n][quiet].view(torch.int32),
                           init[n][quiet].view(torch.int32))
        assert not torch.equal(tables[n][~quiet], init[n][~quiet])


@pytest.mark.parametrize("fault", plain.FAULTS)
def test_faults_read_over_the_tolerances(fault):
    rounds = _rounds()
    want = _plain(rounds)
    bad = _plain(rounds, fault=fault)
    gaps = _gaps(bad["losses"], bad["tables"], want)
    assert gaps["loss"] > LOSS_TOL or gaps["table"] > TABLE_TOL, gaps


def test_lower_precision_reads_over_the_tolerances():
    rounds = _rounds()
    want = _plain(rounds)
    low = _plain(rounds, dtype=torch.float32)
    low16 = _plain(rounds, dtype=torch.bfloat16)
    assert max(_gaps(low["losses"], low["tables"], want).values()) < \
        TABLE_TOL
    gaps = _gaps(low16["losses"], low16["tables"], want)
    assert gaps["loss"] > LOSS_TOL and gaps["table"] > TABLE_TOL, gaps


def test_plain_trainer_imports_nothing_of_the_program():
    path = Path(__file__).resolve().parent / "plain_sgns_rows.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "n2vbench"}
    assert roots <= {"__future__", "numpy", "torch"}

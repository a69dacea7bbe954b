"""A cell of more than one chip: four ranks on the CPU over gloo, each a
process of its own, drive the port's sharded backend through the same
harness and files; rank 0 reports, and its walks equal the reference's."""
from __future__ import annotations

import time

import pytest

from n2vbench import harness
from n2vbench.tests import tiny


def sharded(name: str) -> harness.Cell:
    c = tiny.cell(name)
    c.chips = 4
    c.config["plan"]["backend"] = "sharded"
    c.mix["start_order"] = "repeat"      # starts grouped by their shard
    return c


@pytest.mark.parametrize("name", ["er20-walk-rounds", "wec17-walk-fncache"])
def test_four_ranks_on_the_cpu(name):
    out = harness.run_world(sharded(name), 2 ** 31 + 41, 0.5, False, "cpu",
                            time.perf_counter(), log=lambda *_: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   tiny.cell(name).end_to_end}

"""The benchmark's files: found by name, and within the contract's
limits."""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

from n2vbench import harness, units
from n2vbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_DIR = Path(harness.__file__).resolve().parent
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
PER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    b = tiny.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["n2vbench"]
    assert b["command"][1] == "n2vbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert len(tiny.ROOT.joinpath("BENCHMARK.json").read_bytes()) < 65536


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_found_by_name(name):
    """Each cell's configuration, mix and per-layer readers are found."""
    b = tiny.bench()
    c = harness.cell_of(b, name)
    work = {w["name"]: w for w in b["workloads"]}[name]
    assert c.config["name"] == work["config"]
    assert issubclass(harness.traffic_kind(c.mix["kind"]), units.Units)
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_names_and_units():
    b = tiny.bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for what in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in b[what]]
        assert len(seen) == len(set(seen)), what


def test_entries_have_the_contract_keys():
    b = tiny.bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == PER_KEYS | {"workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(tiny.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_is_named_from_name_characters():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(BENCH_DIR.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: p.name)
def test_no_jax_imported(path):
    """No harness module imports JAX or the JAX package, compared by the
    whole top-level name (``repro_torch`` is not ``repro``)."""
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", ["reference.py", "checks.py",
                                  "graphs.py", "control.py"])
def test_reference_imports_nothing_of_the_program(name):
    roots = set(_imports(BENCH_DIR / name))
    assert not roots & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
    assert roots <= {"__future__", "argparse", "bisect", "dataclasses",
                     "json", "math", "numpy", "pathlib", "statistics",
                     "sys", "time", "torch", "n2vbench"}


def test_run_loads_no_jax_in_a_fresh_process():
    """A run's process holds no JAX module: the harness, the reference and
    the port imported together."""
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import n2vbench.harness, n2vbench.control, repro_torch.engine,"
            " repro_torch.train.stream\n"
            "from n2vbench.harness import forbidden_modules\n"
            "print(forbidden_modules())" % (str(tiny.ROOT),
                                              str(tiny.ROOT / "src")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"

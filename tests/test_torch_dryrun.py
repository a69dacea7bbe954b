"""The port's dry-run (``repro_torch.launch.dryrun``, ``dryrun_walk``)
against the JAX package's on the CPU.

The JAX dry-run modules set ``XLA_FLAGS`` to 512 devices when imported, so
they run in a subprocess here, on a one-device mesh whose axes are
``AxisType.Auto`` (jax 0.9's ``jax.make_mesh`` makes ``Explicit`` axes, on
which the JAX model's sharding constraints raise). There ``lower_cell``
compiles the smoke configs cut to one superblock, unrolled
(``scan_layers=False``: XLA's ``cost_analysis`` counts a scanned body
once), and prints XLA's
``memory_analysis`` and FLOPs. The port's byte counts must equal XLA's
exactly; its counted FLOPs (matrix products and the flash kernel's
visible pairs) stand at a stated ratio to XLA's, which also count
elementwise work and every (query, key) pair of the plain attention."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.engine import WalkEngine as JEngine
from repro.engine import WalkPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.engine import WalkEngine, WalkPlan
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as D
from repro_torch.launch import dryrun_walk as DW
from repro_torch.launch.mesh import make_test_mesh

ROOT = Path(__file__).resolve().parents[1]
XLA_ARCHS = ["yi-6b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
             "seamless-m4t-medium"]
KINDS = ["train", "prefill", "decode"]
SEQ, BATCH = 64, 2
# counted / XLA FLOPs at these cells: train and prefill lose XLA's
# elementwise work and the masked half of the plain attention's pairs
# (0.87-0.94 measured); a smoke decode step has more elementwise work
# than products (0.68-0.74 measured)
FLOP_RATIO = {"train": (0.8, 1.0), "prefill": (0.8, 1.0),
              "decode": (0.6, 0.8)}

JAX_SCRIPT = """
import dataclasses, json
from repro.launch import dryrun as D
from repro.launch import dryrun_walk as DW
import jax
from repro import configs
from repro.roofline.analysis import cost_dict
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {"cells": {}, "walk": {k: getattr(DW, k) for k in
       ("N", "MAX_DEG", "SHARDS", "ROUNDS", "W_LOCAL", "HOT_K")}}
out["walk"]["CELLS"] = {k: list(v) for k, v in DW.CELLS.items()}
for arch in ARCHS:
    cfg = configs.smoke_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.superblock()),
                              enc_layers=min(cfg.enc_layers, 1),
                              scan_layers=False)
    for kind in ("train", "prefill", "decode"):
        comp, _, _ = D.lower_cell(cfg, kind, SEQ, BATCH, mesh, 1)
        m = comp.memory_analysis()
        out["cells"][arch + "/" + kind] = {
            "argument_bytes": m.argument_size_in_bytes,
            "output_bytes": m.output_size_in_bytes,
            "flops": cost_dict(comp.cost_analysis()).get("flops")}
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla():
    code = JAX_SCRIPT.replace("ARCHS", repr(XLA_ARCHS)).replace(
        "SEQ", str(SEQ)).replace("BATCH", str(BATCH))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [s for s in r.stdout.splitlines() if s.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def port():
    """The same cells: each smoke config at one superblock (and one
    encoder layer)."""
    mesh = make_test_mesh(1, 1)
    return {f"{arch}/{kind}": D.lower_cell(
        D.depth_cut(tconfigs.smoke_config(arch), 1), kind, SEQ, BATCH, mesh,
        1) for arch in XLA_ARCHS for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", XLA_ARCHS)
def test_memory_bytes_equal_xla_memory_analysis(xla, port, arch, kind):
    """Arguments: the bytes of the inputs the step reads (XLA's decode
    drops seamless's encoder and the cross layers' k/v weights). Outputs:
    every output leaf, the donated caches and state included, plus 8 bytes
    a leaf of the output tuple's pointer table."""
    want, got = xla["cells"][f"{arch}/{kind}"], port[f"{arch}/{kind}"]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["output_bytes"] == want["output_bytes"]
    assert got["resident_bytes"] == \
        want["argument_bytes"] + want["output_bytes"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", XLA_ARCHS)
def test_counted_flops_stand_at_a_stated_ratio_to_xla(xla, port, arch, kind):
    ratio = port[f"{arch}/{kind}"]["flops"] / xla["cells"][
        f"{arch}/{kind}"]["flops"]
    lo, hi = FLOP_RATIO[kind]
    assert lo <= ratio <= hi, ratio


def test_dense_prefill_flops_equal_the_closed_form():
    """yi-6b smoke prefill: 2 x tokens x the GEMM params of every layer,
    the unembed at the last token only, and the flash kernel's 4·dh a
    visible (query, key) pair; nothing else is counted."""
    cfg = tconfigs.smoke_config("yi-6b")
    d, h, kv, dh, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    gemm = d * h * dh * 2 + d * kv * dh * 2 + 3 * d * f
    want = 2 * BATCH * SEQ * gemm * cfg.num_layers \
        + 2 * BATCH * d * cfg.vocab \
        + FA.flash_flops(BATCH, SEQ, h, dh) * cfg.num_layers
    got = D.lower_cell(cfg, "prefill", SEQ, BATCH, make_test_mesh(1, 1), 1)
    assert got["flops"] == want
    assert got["by_op"]["repro_torch.flash_attention_meta"] == \
        FA.flash_flops(BATCH, SEQ, h, dh) * cfg.num_layers


def test_flash_flop_formula_counts_visible_pairs():
    s = 300
    for window in (0, 7, 64, 299, 300, 512):
        for causal in (True, False):
            mask = FA.visible(s, window, causal)
            assert FA.visible_pairs(s, window, causal) == int(mask.sum())


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_full_depth_equals_extrapolation(arch):
    """Every smoke arch at 3 superblocks, train, prefill and decode: the
    count at full depth equals ``extrapolate`` of 1 and 2 superblocks
    (JAX's homogeneity assumption, which ``run_cell`` asserts)."""
    smoke = tconfigs.smoke_config(arch)
    cfg = dataclasses.replace(
        smoke, num_layers=3 * len(smoke.superblock()),
        enc_layers=3 if smoke.enc_layers else 0)
    mesh = make_test_mesh(1, 1)
    for kind in KINDS:
        full, counts, extrap = D.extrapolation_check(cfg, kind, 32, 2, mesh,
                                                     1)
        assert full["flops"] == extrap and counts[0] < counts[1] < extrap


def test_run_cell_writes_jax_artifact_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ART_DIR", tmp_path)
    cfg = tconfigs.smoke_config("phi3.5-moe-42b-a6.6b")
    art = D.run_cell("phi3.5-moe-42b-a6.6b", "decode_32k", False,
                     cfg_override=cfg)
    keys = {"status", "kind", "seq", "global_batch", "compile_seconds",
            "total_seconds", "memory", "hlo_bytes_raw", "traffic_breakdown",
            "collective_counts_nsb2", "arch", "shape", "mesh", "chips",
            "hlo_flops", "hlo_bytes", "coll_bytes", "coll_by_op",
            "model_flops", "t_compute", "t_memory", "t_collective",
            "bottleneck", "useful_ratio", "roofline_fraction",
            "per_device_mem"}
    assert keys <= set(art)
    assert art["status"] == "ok" and art["mesh"] == "pod16x16"
    assert art["num_groups"] == 16 and art["chips"] == 256
    assert art["t_collective"] is None and art["bottleneck"] in (
        "compute", "memory")
    saved = json.loads((tmp_path / "phi3.5-moe-42b-a6.6b__decode_32k__"
                        "pod16x16.json").read_text())
    assert saved["memory"] == art["memory"]
    skipped = D.run_cell("yi-6b", "long_500k", False, save=False)
    assert skipped["status"] == "skipped"


def test_walk_dryrun_constants_equal_jax(xla):
    want = xla["walk"]
    for k in ("N", "MAX_DEG", "SHARDS", "ROUNDS", "W_LOCAL", "HOT_K"):
        assert getattr(DW, k) == want[k], k
    assert {k: list(v) for k, v in DW.CELLS.items()} == want["CELLS"]


@pytest.mark.parametrize("mode,pipeline", [("exact", False),
                                           ("approx_always", True)])
def test_walk_analysis_shared_keys_equal_jax(mode, pipeline):
    """``WalkEngine.analyze`` at one shard on the same graph and plan as
    JAX's: every key JAX does not read from the compiled program."""
    spec = "wec:k=8,deg=12,seed=1"
    kw = dict(length=6, cap=16, mode=mode, backend="sharded",
              pipeline=pipeline)
    want = JEngine.build(spec, JPlan(**kw)).analyze()
    got = WalkEngine.build(spec, WalkPlan(**kw), device="cpu").analyze()
    shared = ("backend", "mode", "pipeline", "overlap_total_bytes",
              "overlap_exposed_bytes", "overlap_efficiency", "cap",
              "hot_cap", "capacity", "shards", "n", "walkers_per_shard",
              "analytic_coll_bytes_per_dev", "graph_bytes_per_dev")
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert set(want) == set(got)
    assert got["compile_seconds"] is None
    with pytest.raises(ValueError, match="analyze"):
        WalkEngine.build(spec, WalkPlan(length=4), device="cpu").analyze()


def test_walk_cells_run_on_meta_at_512_shards():
    for name in DW.CELLS:
        art = DW.run_cell(name, save=False)
        assert art["shards"] == 512 and art["n"] == DW.N
        assert art["bottleneck"] in ("compute", "collective")
    g = DW.abstract_graph(128, DW.MAX_DEG)
    assert g.adj.is_meta and g.n_local == DW.N // DW.SHARDS
    bf16 = DW.run_cell("fn_approx_bf16", save=False)
    f32 = DW.run_cell("fn_approx_visitcap", save=False)
    assert bf16["coll_bytes_per_step_per_dev"] < \
        f32["coll_bytes_per_step_per_dev"]
    np.testing.assert_equal(f32["walkers_per_shard"], DW.W_LOCAL)

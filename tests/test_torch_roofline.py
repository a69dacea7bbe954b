"""The port's roofline and sharding analysis against the JAX package on the
CPU: the traffic model's LM half float for float, ``Roofline``'s keys,
``model_flops_for``, ``extrapolate``, the sharding rules' specs on the
full archs' abstract trees, ``input_specs`` and the meta ``init_params``
tree. Everything here is exact: no tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro.roofline import analysis as jroof
from repro.roofline import traffic as jtraffic
from repro_torch import configs as tconfigs
from repro_torch import random as jr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import dtype_of
from repro_torch.roofline import analysis as troof
from repro_torch.roofline import traffic as ttraffic

ARCHS = jconfigs.list_archs()
MESHES = [{"data": 1, "model": 1}, {"data": 1, "model": 8},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
SPEC_MESHES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2, 2), ("pod", "data", "model"))]
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree, paths as the port's key tuples."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jshd._path_names(kp): leaf for kp, leaf in flat}


def _port_leaves(tree):
    return dict(tshd.leaves_with_path(tree))


def test_port_lists_the_same_archs_and_shapes():
    assert tconfigs.list_archs() == ARCHS
    assert tconfigs.SHAPE_NAMES == jconfigs.SHAPE_NAMES
    for arch in ARCHS:
        for shape in tconfigs.SHAPE_NAMES:
            assert tconfigs.applicable(tconfigs.get_config(arch), shape) == \
                jconfigs.applicable(jconfigs.get_config(arch), shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_lm_half_equals_jax(arch):
    """``param_bytes_per_device``, ``_attn_layers``, ``_cache_bytes_global``
    and ``analytic_bytes`` float for float: 3 shapes x 4 meshes x with and
    without the flash term."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert ttraffic._attn_layers(tcfg) == jtraffic._attn_layers(jcfg)
    for mesh in MESHES:
        assert ttraffic._shards(mesh) == jtraffic._shards(mesh)
        assert ttraffic.param_bytes_per_device(tcfg, mesh) == \
            jtraffic.param_bytes_per_device(jcfg, mesh)
        for shape in SHAPES:
            info = jconfigs.SHAPES[shape]
            seq, b = info["seq"], info["batch"]
            assert ttraffic._cache_bytes_global(tcfg, seq, b) == \
                jtraffic._cache_bytes_global(jcfg, seq, b)
            for flash in (False, True):
                got = ttraffic.analytic_bytes(tcfg, info["kind"], seq, b,
                                              mesh, flash_attention=flash)
                want = jtraffic.analytic_bytes(jcfg, info["kind"], seq, b,
                                               mesh, flash_attention=flash)
                assert got == want, (mesh, shape, flash)


def test_h100_constants_live_in_traffic():
    assert ttraffic.H100_BF16_FLOPS == 989e12
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        ttraffic.H100_BF16_FLOPS, ttraffic.H100_HBM_BW,
        ttraffic.H100_NVLINK_BW)


def test_roofline_keys_equal_jax_and_collective_term_is_absent():
    kw = dict(arch="x", shape="train_4k", mesh="m", chips=4,
              hlo_flops=989e12, hlo_bytes=3.35e12 / 2, coll_by_op={},
              model_flops=989e12 * 2)
    want = jroof.Roofline(coll_bytes=1.0, **kw).to_dict()
    got = troof.Roofline(coll_bytes=None, **kw)
    assert list(got.to_dict()) == list(want)
    assert got.t_collective is None
    assert abs(got.t_compute - 1.0) < 1e-12 and abs(got.t_memory - 0.5) < 1e-12
    assert got.bottleneck == "compute"
    assert abs(got.useful_ratio - 0.5) < 1e-12
    assert abs(got.roofline_fraction - 0.5) < 1e-12
    with_link = troof.Roofline(coll_bytes=450e9 * 3, **kw)
    assert with_link.bottleneck == "collective"


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_equals_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape, info in jconfigs.SHAPES.items():
        assert troof.model_flops_for(tcfg, info["kind"], info["seq"],
                                     info["batch"]) == \
            jroof.model_flops_for(jcfg, info["kind"], info["seq"],
                                  info["batch"])


def test_extrapolate_linear():
    """tests/test_dryrun.py::test_extrapolate_linear's case."""
    c1 = {"flops": 10.0, "bytes": 100.0, "nested": {"x": 1.0}}
    c2 = {"flops": 16.0, "bytes": 130.0, "nested": {"x": 3.0}}
    c8 = troof.extrapolate(c1, c2, 8)
    assert c8 == jroof.extrapolate(c1, c2, 8)
    assert c8["flops"] == 10 + 7 * 6
    assert c8["bytes"] == 100 + 7 * 30
    assert c8["nested"]["x"] == 1 + 7 * 2


def test_count_flops_reads_matrix_products():
    a, b = torch.empty(32, 64, device="meta"), torch.empty(64, 16,
                                                           device="meta")
    out = troof.count_flops(lambda x, y: torch.relu(x @ y), a, b)
    assert out["flops"] == 2 * 32 * 64 * 16
    assert out["by_op"] == {"aten.mm": 2 * 32 * 64 * 16}
    assert out["out"].shape == (32, 16) and out["out"].is_meta


def test_production_meshes_are_shapes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert (pod.size, pod.name) == (512, "pod2x16x16")
    assert tmesh.make_test_mesh(2, 2).shape == {"data": 2, "model": 2}
    assert tmesh.make_test_mesh(2, 4, pod=2).axis_names == \
        ("pod", "data", "model")


@pytest.fixture(scope="module")
def jax_trees():
    """jax.eval_shape trees of every full arch: train params (f32),
    serve params (bf16) and a decode_32k-sized cache at B=8."""
    out = {}
    for arch in ARCHS:
        cfg = jconfigs.get_config(arch)
        srv = dataclasses.replace(cfg, param_dtype="bfloat16")
        key = jax.random.PRNGKey(0)
        out[arch] = (
            jax.eval_shape(lambda: jmodel.init_params(cfg, key)),
            jax.eval_shape(lambda: jmodel.init_params(srv, key)),
            jax.eval_shape(lambda: jtf.init_caches(cfg, 8, 1024,
                                                   jnp.dtype(cfg.dtype))))
    return out


@pytest.mark.parametrize("shape,names", SPEC_MESHES)
def test_specs_equal_jax_partition_specs(jax_trees, shape, names):
    """``param_specs`` (train and serve mode) and ``cache_specs`` on the
    full archs' eval_shape trees, ``batch_specs`` and ``logits_spec``:
    each spec equals the tuple of JAX's ``PartitionSpec`` (JAX's rules
    read only ``mesh.shape``, so an ``AbstractMesh`` serves)."""
    jm = AbstractMesh(shape, names)
    tm = tmesh.MeshShape(names, shape)
    for arch in ARCHS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        params, serve, caches = jax_trees[arch]
        for tree, mode in ((params, False), (serve, True)):
            want = _jax_leaves(jshd.param_specs(tree, jm, jcfg,
                                                serve_mode=mode))
            got = _port_leaves(tshd.param_specs(tree, tm, tcfg,
                                                serve_mode=mode))
            assert got == {k: tuple(v) for k, v in want.items()}, arch
        want = _jax_leaves(jshd.cache_specs(caches, jm, jcfg))
        got = _port_leaves(tshd.cache_specs(caches, tm, tcfg))
        assert got == {k: tuple(v) for k, v in want.items()}, arch
        for b in (1, 8, 32, 128):
            assert tshd.logits_spec(tcfg, tm, b) == \
                tuple(jshd.logits_spec(jcfg, jm, b))
        for sh in SHAPES + ["long_500k"]:
            for b in (None, 1, 6):
                jin = jconfigs.input_specs(jcfg, sh, batch=b, seq=64)
                tin = tconfigs.input_specs(tcfg, sh, batch=b, seq=64)
                want = jshd.batch_specs(jin["batch"], jm)
                got = tshd.batch_specs(tin["batch"], tm)
                assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """Shapes and dtypes of every input stand-in (JAX's weak-typed ``pos``
    is a plain int32 scalar in torch)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for sh in jconfigs.SHAPE_NAMES:
        jin = jconfigs.input_specs(jcfg, sh)
        tin = tconfigs.input_specs(tcfg, sh)
        assert {k: v for k, v in tin.items() if k != "batch"} == \
            {k: v for k, v in jin.items() if k != "batch"}
        assert list(tin["batch"]) == list(jin["batch"])
        for k, v in tin["batch"].items():
            assert v.is_meta
            assert tuple(v.shape) == jin["batch"][k].shape
            assert str(v.dtype).removeprefix("torch.") == \
                str(jin["batch"][k].dtype)


def _tree_signature(leaves: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in leaves.items()}


@pytest.mark.parametrize("arch,full", [(a, False) for a in ARCHS] + [
    ("jamba-v0.1-52b", True), ("llama-3.2-vision-11b", True)])
def test_meta_init_params_tree_equals_jax_eval_shape(arch, full):
    """The port's ``init_params`` on ``meta`` has the paths, shapes and
    dtypes of JAX's ``eval_shape``: every smoke arch, and jamba and
    llama-vision at published widths; so do the caches."""
    jcfg = jconfigs.get_config(arch) if full else jconfigs.smoke_config(arch)
    tcfg = tconfigs.get_config(arch) if full else tconfigs.smoke_config(arch)
    want = jax.eval_shape(lambda: jmodel.init_params(
        jcfg, jax.random.PRNGKey(0)))
    got = tmodel.init_params(tcfg, jr.PRNGKey(0, device="meta"), "meta")
    got_leaves = _port_leaves(got)
    assert all(v.is_meta for v in got_leaves.values())
    assert _tree_signature(got_leaves) == _tree_signature(_jax_leaves(want))
    want = jax.eval_shape(lambda: jtf.init_caches(jcfg, 2, 64,
                                                  jnp.dtype(jcfg.dtype)))
    got = ttf.init_caches(tcfg, 2, 64, dtype_of(tcfg), "meta")
    assert _tree_signature(_port_leaves(got)) == \
        _tree_signature(_jax_leaves(want))


def test_per_device_bytes_divides_by_the_named_axes():
    mesh = tmesh.make_test_mesh(4, 2, pod=2)
    tree = {"a": torch.empty(8, 6, device="meta"),
            "b": {"c": torch.empty(5, dtype=torch.bfloat16, device="meta")}}
    specs = {"a": (("pod", "data"), "model"), "b": {"c": (None,)}}
    assert tshd.shard_factor(specs["a"], mesh) == 16
    assert tshd.per_device_bytes(tree, specs, mesh) == 8 * 6 * 4 // 16 + 10
    assert tshd.per_device_bytes(tree, (), mesh) == 8 * 6 * 4 + 10
    np.testing.assert_equal(tshd.axis_size(mesh, ("pod", "model")), 4)

"""Dry-run: every (arch x shape x mesh) cell's per-device memory and
roofline terms, with no card and no values — port of
``repro.launch.dryrun``.

Per cell, the step (a train step: ``loss_fn``, its grads, clipping and
AdamW; a prefill; or one decode step) runs once on ``meta`` tensors under
``torch.utils.flop_counter.FlopCounterMode`` (``roofline.count_flops``):
params and optimizer state are made abstractly (``init_params`` on
``meta`` costs about one op a leaf), so nothing is allocated or computed.
Where the JAX package lowers and compiles for XLA, this reads:

* ``argument_bytes`` / ``output_bytes``: the step's inputs and outputs per
  device under ``launch.sharding``'s rules, by the definitions of XLA's
  ``memory_analysis()``: arguments are the bytes of the input leaves the
  step reads (``jit`` drops unused ones: a decode step reads no encoder);
  outputs are the output leaves' bytes, donated (aliased) buffers
  included, plus 8 bytes a leaf for the output tuple's table of buffer
  pointers (held exactly against XLA at mesh 1x1 in
  tests/test_torch_dryrun.py).
  ``resident_bytes`` is their sum, a floor of the step's footprint;
  ``temp_bytes_upper`` and ``peak_bytes`` are None (no compiler plans the
  temporaries here);
* ``hlo_flops``: the counted FLOPs of the global step over the mesh's
  devices — matrix products and the flash kernel's own formula, no
  elementwise work (XLA's ``cost_analysis`` counts that too);
* the memory term from ``roofline.traffic.analytic_bytes``, as JAX's.

The step is counted at full depth (a Python loop over superblocks: there
is no ``while`` loop whose body a counter would see once) and at 1 and 2
superblocks, and ``run_cell`` asserts that ``extrapolate`` of the two
reproduces the full count: JAX's homogeneity assumption, checked. The
collective term is not carried (``roofline.analysis``).

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage (no card needed; nothing touches a device):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \
      [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim.grad_utils import clip_by_global_norm, value_and_grad
from repro_torch.optim.optimizers import adamw, apply_updates
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import traffic

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
TUPLE_ENTRY_BYTES = 8       # XLA's output tuple: one pointer a leaf


def _art_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> Path:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return ART_DIR / f"{arch}__{shape}__{mesh_name}{suffix}.json"


# ---------------- step functions ----------------

def make_train_fn(cfg: ModelConfig, num_groups: int):
    """AdamW (lr 3e-4) and one train step: ``loss_fn``'s grads (through
    ``torch.utils.checkpoint`` where ``cfg.remat``), clipped to global norm
    1, then the update. The step returns (params, opt_state, metrics)."""
    opt = adamw(lr=3e-4)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p, b: M.loss_fn(cfg, p, b, num_groups), params, batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return opt, train_step


def _shape_for(kind: str) -> str:
    return {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]


def _leaf_count(tree) -> int:
    return sum(1 for _ in shd.leaves_with_path(tree))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Reads(TorchDispatchMode):
    """The storages that the step's ops read: every tensor argument of an
    op that is not a view (a view only renames a buffer)."""

    def __init__(self):
        super().__init__()
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not func.is_view:
            for t in pytree.tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    self.read.add(_storage(t))
        return func(*args, **kwargs)


def _read_bytes(tree, specs, mesh, read: set) -> int:
    """Per-device bytes of the leaves of ``tree`` that the step read: JAX's
    ``jit`` drops the arguments a program never uses (a decode step reads
    neither an encoder nor the cross layers' k/v weights), so XLA's
    argument bytes leave them out."""
    kept = {path: leaf for path, leaf in shd.leaves_with_path(tree)
            if _storage(leaf) in read}
    spec_of = dict(shd.leaves_with_path(specs))
    return sum(shd.leaf_bytes(leaf) // shd.shard_factor(spec_of[path], mesh)
               for path, leaf in kept.items())


def lower_cell(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh,
               num_groups: int) -> Dict[str, Any]:
    """Run one cell's step abstractly on ``meta`` under the FLOP counter;
    returns its counted FLOPs (``flops``, ``by_op``) and per-device
    ``argument_bytes``, ``output_bytes`` and ``resident_bytes`` on
    ``mesh`` (see the module docstring), and the host ``seconds``."""
    t0 = time.perf_counter()
    key = jr.PRNGKey(0, device="meta")
    ispec = configs.input_specs(cfg, _shape_for(kind), batch=batch, seq=seq)
    inputs = ispec["batch"]
    ins = [(inputs, shd.batch_specs(inputs, mesh))]
    if kind == "decode":
        # serve-mode params, bf16 and TP-only, as JAX's dry-run (inference
        # keeps no optimizer state); the caches are donated and written in
        # place. ``pos`` is JAX's int32 scalar input, passed as the last
        # position.
        cfg_run = dataclasses.replace(cfg, param_dtype="bfloat16")
        params = M.init_params(cfg_run, key, "meta")
        pspecs = shd.param_specs(params, mesh, cfg_run, serve_mode=True)
    else:
        cfg_run = cfg
        params = M.init_params(cfg, key, "meta")
        pspecs = shd.param_specs(params, mesh, cfg)
    ins.append((params, pspecs))
    reads = _Reads()
    if kind == "train":
        opt, train_step = make_train_fn(cfg, num_groups)
        opt_state = opt.init(params)
        ins += [({"count": opt_state.count}, {"count": ()}),
                (opt_state.mu, pspecs), (opt_state.nu, pspecs)]
        with reads:
            counted = roof.count_flops(train_step, params, opt_state, inputs)
        new_params, new_state, metrics = counted["out"]
        outs = [(new_params, pspecs), ({"count": new_state.count},
                                       {"count": ()}),
                (new_state.mu, pspecs), (new_state.nu, pspecs),
                (metrics, {k: () for k in metrics})]
    else:
        if kind == "prefill":
            with reads:
                counted = roof.count_flops(M.prefill, cfg, params, inputs,
                                           seq, num_groups)
        else:
            caches = tf.init_caches(cfg, batch, seq, dtype_of(cfg), "meta")
            ins.append((caches, shd.cache_specs(caches, mesh, cfg)))
            with reads:
                counted = roof.count_flops(M.serve_step, cfg_run, params,
                                           inputs["token"], seq - 1, caches,
                                           num_groups)
            reads.read.add(_storage(inputs["pos"]))
        logits, caches = counted["out"]
        outs = [({"logits": logits},
                 {"logits": shd.logits_spec(cfg, mesh, batch)}),
                (caches, shd.cache_specs(caches, mesh, cfg))]
    arg = sum(_read_bytes(tree, specs, mesh, reads.read)
              for tree, specs in ins)
    out = sum(shd.per_device_bytes(tree, specs, mesh) for tree, specs in outs)
    out += TUPLE_ENTRY_BYTES * sum(_leaf_count(tree) for tree, _ in outs)
    return {"flops": int(counted["flops"]), "by_op": counted["by_op"],
            "argument_bytes": int(arg), "output_bytes": int(out),
            "resident_bytes": int(arg + out),
            "seconds": time.perf_counter() - t0}


# ---------------- per-cell analysis ----------------

def _mesh_for(multi_pod: bool, mesh_shape=None) -> MeshShape:
    """The production mesh, or the same chips split ``(data, model)``."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    d, m = mesh_shape
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, d, m))
    return MeshShape(("data", "model"), (d, m))


def depth_cut(cfg: ModelConfig, nsb: int) -> ModelConfig:
    """``cfg`` at ``nsb`` superblocks (and as many encoder layers, up to
    its own): the pair ``run_cell`` extrapolates from."""
    pattern = len(cfg.superblock())
    return dataclasses.replace(
        cfg, num_layers=pattern * nsb, scan_layers=False,
        enc_layers=min(cfg.enc_layers, nsb) if cfg.enc_layers else 0)


def extrapolation_check(cfg: ModelConfig, kind: str, seq: int, batch: int,
                        mesh, num_groups: int):
    """(``lower_cell`` at full depth, the FLOPs counted at 1 and 2
    superblocks, their ``extrapolate`` to ``cfg``'s depth)."""
    full = lower_cell(cfg, kind, seq, batch, mesh, num_groups)
    counts = [lower_cell(depth_cut(cfg, nsb), kind, seq, batch, mesh,
                         num_groups)["flops"] for nsb in (1, 2)]
    extrap = roof.extrapolate({"flops": counts[0]}, {"flops": counts[1]},
                              cfg.num_superblocks)["flops"]
    return full, counts, extrap


def run_cell(arch: str, shape: str, multi_pod: bool, save: bool = True,
             tag: str = "", cfg_override=None,
             mesh_shape=None) -> Dict[str, Any]:
    """One cell on the production mesh (``mesh_shape=(data, model)``
    splits the same chips otherwise); writes its artifact when ``save``."""
    mesh = _mesh_for(multi_pod, mesh_shape)
    cfg = cfg_override or configs.get_config(arch)
    ok, why = configs.applicable(cfg, shape)
    if not ok:
        art = {"arch": arch, "shape": shape, "mesh": mesh.name,
               "status": "skipped", "reason": why}
        if save:
            _art_path(arch, shape, mesh.name, tag).write_text(
                json.dumps(art, indent=1))
        return art

    info = configs.SHAPES[shape]
    kind, seq, batch = info["kind"], info["seq"], info["batch"]
    num_groups = shd.axis_size(mesh, shd.batch_axes(mesh))
    if batch % num_groups != 0:
        num_groups = 1

    t_all = time.perf_counter()
    full, counts, extrap = extrapolation_check(cfg, kind, seq, batch, mesh,
                                               num_groups)
    mem_info = {"argument_bytes": full["argument_bytes"],
                "output_bytes": full["output_bytes"],
                "temp_bytes_upper": None, "peak_bytes": None,
                "resident_bytes": full["resident_bytes"]}
    if extrap != full["flops"]:
        raise AssertionError(
            f"{arch} {shape}: {full['flops']} FLOPs at full depth, "
            f"{extrap} extrapolated from 1 and 2 superblocks "
            f"({counts}): the stack is not homogeneous")

    traffic_model = traffic.analytic_bytes(cfg, kind, seq, batch,
                                           mesh.shape)
    rl = roof.Roofline(
        arch=arch, shape=shape, mesh=mesh.name, chips=mesh.size,
        hlo_flops=full["flops"] / mesh.size,
        hlo_bytes=traffic_model["total"], coll_bytes=None, coll_by_op=None,
        model_flops=roof.model_flops_for(cfg, kind, seq, batch),
        per_device_mem=mem_info["resident_bytes"])
    art = {"status": "ok", "kind": kind, "seq": seq, "global_batch": batch,
           "num_groups": num_groups,
           "compile_seconds": None,
           "total_seconds": time.perf_counter() - t_all,
           "memory": mem_info,
           "hlo_bytes_raw": None,
           "traffic_breakdown": traffic_model,
           "collective_counts_nsb2": None,
           "flops_global": full["flops"], "flops_by_op": full["by_op"],
           "flops_nsb1_nsb2": counts,
           **rl.to_dict()}
    if save:
        _art_path(arch, shape, mesh.name, tag).write_text(
            json.dumps(art, indent=1))
    return art


# ---------------- CLI ----------------

def _run_all(multi_pod: bool, skip_existing: bool, tag: str = "") -> int:
    mesh_name = _mesh_for(multi_pod).name
    results = []
    for arch in configs.list_archs():
        for shape in configs.SHAPE_NAMES:
            if skip_existing and _art_path(arch, shape, mesh_name,
                                           tag).exists():
                print(f"[skip existing] {arch} {shape}")
                continue
            print(f"[run] {arch} {shape} {mesh_name}", flush=True)
            try:
                art = run_cell(arch, shape, multi_pod, tag=tag)
                results.append((arch, shape, art["status"], art))
            except Exception:
                traceback.print_exc()
                results.append((arch, shape, "FAIL", None))
    print("\n=== dry-run summary ===")
    for a, s, st, art in results:
        line = f"{a:26s} {s:12s} {st}"
        if st == "ok":
            line += (f"  resident {art['memory']['resident_bytes'] / 1e9:.3f}"
                     f" GB/card  bottleneck {art['bottleneck']}")
        print(line)
    return sum(st == "FAIL" for _, _, st, _ in results)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=configs.SHAPE_NAMES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.all:
        return 1 if _run_all(args.multi_pod, args.skip_existing,
                             args.tag) else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    art = run_cell(args.arch, args.shape, args.multi_pod, tag=args.tag)
    if art["status"] == "skipped":
        print(f"SKIPPED: {art['reason']}")
        return 0
    print(json.dumps({k: v for k, v in art.items()
                      if k not in ("coll_by_op", "flops_by_op")}, indent=1,
                     default=str))
    print(f"resident per device: "
          f"{art['memory']['resident_bytes'] / 2**30:.2f} GiB")
    print(f"t_compute={art['t_compute']:.4e}s t_memory={art['t_memory']:.4e}s"
          f" t_collective={art['t_collective']} ->"
          f" bottleneck={art['bottleneck']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

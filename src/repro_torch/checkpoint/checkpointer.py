"""Atomic, async, resumable checkpointing — port of
``repro.checkpoint.checkpointer`` for one device (no shardings).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``<dir>/step_<n>/meta.json``,
committed by atomically renaming a ``.tmp`` staging directory, then updating
``<dir>/LATEST``. A half-written checkpoint can never be picked up on
restart.

* ``save(..., blocking=False)`` hands the host copy to a writer thread, so
  writing overlaps training (the device -> host copy is the only
  synchronous part).
* A tree is a tuple, list or dict (nested freely) of numpy arrays or
  tensors, flattened to ``/``-joined key paths (dict keys, sequence
  indices) as the JAX package names them; ``restore`` rebuilds the
  template's structure, with a tensor wherever the template holds one
  (on that tensor's device) and a numpy array elsewhere.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in a fixed order: dict keys sorted, as
    ``jax.tree_util`` flattens dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(template, arrays, prefix=()):
    if isinstance(template, dict):
        return {k: _rebuild(v, arrays, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        out = [_rebuild(v, arrays, prefix + (str(i),))
               for i, v in enumerate(template)]
        return type(template)(out) if not hasattr(template, "_fields") \
            else type(template)(*out)
    arr = arrays["/".join(prefix)]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(template.device)
    return arr


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------------- save ----------------

    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()  # at most one in-flight async save
        flat = {path: _host(leaf) for path, leaf in _leaves(tree)}
        meta = dict(meta or {})
        meta["step"] = int(step)
        meta["keys"] = sorted(flat.keys())
        meta["time"] = time.time()

        def write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            latest_tmp = os.path.join(self.directory, "LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(os.path.basename(final))
            os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------- restore ----------------

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.directory, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.directory, name)):
            return None
        return int(name.split("_")[-1])

    def restore(self, template: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (latest step by
        default). Returns (tree, meta)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            tree = _rebuild(template, {k: arrays[k] for k in arrays.files})
        return tree, meta

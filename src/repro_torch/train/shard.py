"""Sharded SGNS: range-partitioned embedding tables with lazy row-Adam —
port of ``repro.train.shard``.

``emb_in``/``emb_out`` and their Adam moments are partitioned by vertex
range over the ranks of a table mesh (``launch.mesh.make_table_mesh``):
rank *r* owns rows ``[r·n_loc, (r+1)·n_loc)``, where JAX's ``shard_map``
gives them to device *r*. The epoch is a Python loop over the fixed
``[steps, batch]`` grid, as the dense trainer's, and every rank runs the
batch math (pairs, negatives, dedup, row grads, the deduped scatter) on
the same inputs, so every float sum has the same grouping at any world
size: a world of P gives the tables of a world of one bit for bit. Each
step:

* **dedup** — the batch's sorted unique centre rows and context/negative
  rows, padded to the power-of-two buffers ``u_in``/``u_out`` with the
  fill id ``vp`` (past every row, so it sorts last and the real ids'
  positions equal ``jnp.unique(size=, fill_value=)``'s), with
  ``searchsorted`` inverses; made on the device without a host sync;
* **owner gather** — the buffers' rows from the tables, ``+0.0`` for rows
  this rank does not own (and the fill rows), summed over the mesh by
  :func:`psum` (an all-reduce: one owner a row, so the sum is exact in any
  order);
* **row grads** — :func:`~repro_torch.kernels.sgns.sgns_row_grads` (the
  fused kernel's row entry, or its closed form);
* **deduped scatter** — ``index_add_`` of ``g / denom`` onto the unique
  buffers in batch order, deterministic on the card;
* **lazy row-Adam** — :func:`~repro_torch.optim.optimizers.adam_rows` on
  the owned rows only; untouched rows keep their moments. O(rows·D) table
  work a step, against dense Adam's O(V·D).

While a profiler runs, the negatives and each of the step's stages are
spans (``repro_torch.tracing``): ``train.negatives``,
``train.rows.dedup``, ``train.rows.gather`` (owner gather and inverse
gathers), ``train.rows.scatter`` and ``train.rows.adam`` (the update and
the write-backs; it counts the buffers' ``rows``). The row grads run
in no span: the device trace times their kernel.

The unique buffers never hold more rows than the padded table
(:func:`unique_rows`): a set of distinct ids cannot outgrow it.

Tables and moments handed in are never written: the epoch copies them
once, with one scratch row at ``n_loc`` that takes the fill rows' writes
(JAX's ``mode="drop"`` redirect), updates its copies in place with
``index_copy_`` and returns them without the scratch row.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import random as jr
from repro_torch.device import deterministic
from repro_torch.kernels.sgns import sgns_row_grads
from repro_torch.optim.optimizers import AdamState
from repro_torch.tracing import span
from repro_torch.train.pairs import device_negatives

TABLES = ("emb_in", "emb_out")


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: the unique-row buffers' sizes snap to a
    small family of shapes."""
    return 1 << max(int(n) - 1, 0).bit_length()


def table_rows(vocab: int, shards: int) -> int:
    """Padded global row count: vocab rounded up to a shard multiple, so
    ``owner(v) = v // (rows / shards)`` is exact. Pad rows are zero and
    never touched."""
    return shards * math.ceil(vocab / max(shards, 1))


def unique_rows(n: int, rows: int) -> int:
    """A unique buffer's size for ``n`` ids of a ``rows``-row table: the
    power-of-two bucket, never past the table (a unique set holds at most
    ``rows`` ids)."""
    return min(pow2_bucket(n), rows)


def world_shards() -> int:
    """The ``torch.distributed`` world's size, 1 outside one."""
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def shard_params(params: dict, vocab: int, shards: int = 1,
                 rank: int = 0) -> dict:
    """Pad the [V, D] tables with zero rows to ``table_rows(vocab,
    shards)`` and keep rank ``rank``'s row block (at one shard the tables
    come back as they are)."""
    vp = table_rows(vocab, shards)
    n_loc = vp // shards

    def block(t):
        if t.shape[0] < vp:
            t = torch.cat([t, t.new_zeros(vp - t.shape[0], t.shape[1])])
        return t if shards == 1 else t[rank * n_loc:(rank + 1) * n_loc]
    return {k: block(t) for k, t in params.items()}


def psum(rows: torch.Tensor, mesh=None) -> torch.Tensor:
    """The owner gather's sum over the table mesh (each rank adds its own
    rows, +0.0 elsewhere): an all-reduce on the mesh's group, the identity
    without one."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(rows, group=mesh.group)
    return rows


def gather_tables(params: dict, mesh=None) -> dict:
    """Every rank's row blocks concatenated: the padded [rows, D] tables,
    on every rank of the mesh."""
    if mesh is None or mesh.group is None:
        return params
    out = {}
    for k, t in params.items():
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
        out[k] = torch.cat(parts)
    return out


def unique_padded(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.unique(x, size=size, fill_value=fill)`` for ``size >=
    x.numel()``: the sorted distinct values of ``x``, then ``fill``. Fixed
    shape, so the device never waits for the host."""
    s = torch.sort(x).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    out = torch.full((size,), fill, dtype=x.dtype, device=x.device)
    # every copy of a value lands on its value's slot: one value a slot
    return out.scatter_(0, torch.cumsum(first, 0) - 1, s)


def _owned(u: torch.Tensor, row0: int, n_loc: int):
    """(local row of each id, the scratch row ``n_loc`` where this process
    does not own it; the ownership mask as a column)."""
    loc = u.long() - row0
    mine = (loc >= 0) & (loc < n_loc)
    return torch.where(mine, loc, n_loc), mine[:, None]


def _with_scratch(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros(1, t.shape[1])])


def _drop_scratch(tables: dict, n_loc: int) -> dict:
    return {k: t[:n_loc] for k, t in tables.items()}


def train_epoch_sharded(params, opt_state, c, x, valid, perm2d, prob, alias,
                        key, *, opt, negatives, backend, n_pairs, u_in,
                        u_out, mesh=None):
    """One epoch over one round on this rank's row blocks (``params`` and
    the moments: [n_loc, D]; all rows without a ``mesh``): per row of the
    ``[steps, batch]`` permutation grid, the dedup, owner gather, row
    grads, deduped scatter and lazy row-Adam of the module docstring. Same
    (round, epoch, step) keying as the dense ``_train_epoch``. Every rank
    of the mesh calls it on the same inputs. Returns (params, opt_state,
    per-step losses [steps]); the inputs are not written."""
    n_loc = params["emb_in"].shape[0]
    shards, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    vp, row0 = n_loc * shards, rank * n_loc
    steps, batch_size = perm2d.shape
    if u_in < min(batch_size, vp) or \
            u_out < min(batch_size * (1 + negatives), vp):
        raise ValueError(f"unique buffers {u_in}, {u_out} are smaller than "
                         f"the batch's {batch_size} centre and "
                         f"{batch_size * (1 + negatives)} context rows")
    dev = perm2d.device
    lane = torch.arange(batch_size, device=dev)
    tab = {k: _with_scratch(params[k]) for k in TABLES}
    mu = {k: _with_scratch(opt_state.mu[k]) for k in TABLES}
    nu = {k: _with_scratch(opt_state.nu[k]) for k in TABLES}
    count = opt_state.count
    losses = []
    for s in range(steps):
        idx = perm2d[s]
        in_bounds = (s * batch_size + lane) < n_pairs
        center, pos = c[idx], x[idx]
        with span("train.negatives", dev):
            neg = device_negatives(jr.fold_in(key, s), prob, alias,
                                   (batch_size, negatives)).reshape(-1)
        v = (valid[idx] & in_bounds).to(torch.float32)

        with span("train.rows.dedup", dev):
            uc = unique_padded(center, u_in, vp)
            uo = unique_padded(torch.cat([pos, neg]), u_out, vp)
            inv_c = torch.searchsorted(uc, center)
            inv_p = torch.searchsorted(uo, pos)
            inv_n = torch.searchsorted(uo, neg)
        with span("train.rows.gather", dev):
            owned = {"emb_in": _owned(uc, row0, n_loc),
                     "emb_out": _owned(uo, row0, n_loc)}
            rows = {k: psum(torch.where(keep, tab[k][li], 0.0), mesh)
                    for k, (li, keep) in owned.items()}
            ci = rows["emb_in"][inv_c]
            po = rows["emb_out"][inv_p]
            no = rows["emb_out"][inv_n].reshape(batch_size, negatives, -1)
        loss_sum, g_ci, g_po, g_no = sgns_row_grads(ci, po, no, v, backend)
        denom = torch.clamp(v.sum(), min=1.0)
        with span("train.rows.scatter", dev), deterministic(dev):
            grads = {
                "emb_in": torch.zeros_like(rows["emb_in"]).index_add_(
                    0, inv_c, g_ci / denom),
                "emb_out": torch.zeros_like(rows["emb_out"])
                .index_add_(0, inv_p, g_po / denom)
                .index_add_(0, inv_n,
                            g_no.reshape(batch_size * negatives, -1) / denom)}

        with span("train.rows.adam", dev, rows=u_in + u_out):
            count = count + 1
            for k, (li, keep) in owned.items():
                mu_r = torch.where(keep, mu[k][li], 0.0)
                nu_r = torch.where(keep, nu[k][li], 0.0)
                upd, mu_n, nu_n = opt.update(grads[k], (mu_r, nu_r), count)
                tab[k].index_copy_(0, li, rows[k] + upd)
                mu[k].index_copy_(0, li, mu_n)
                nu[k].index_copy_(0, li, nu_n)
        losses.append(loss_sum / denom)
    return (_drop_scratch(tab, n_loc), AdamState(
        count, _drop_scratch(mu, n_loc), _drop_scratch(nu, n_loc)),
        torch.stack(losses))

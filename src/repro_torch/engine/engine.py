"""WalkEngine — port of ``repro.engine.engine``: one entry point over the
reference, fused and sharded backends.

    engine = WalkEngine.build(graph, plan, mesh=None)   # on the card
    result = engine.run(starts=None, seed=0)        # WalkResult(walks, stats)
    for r in engine.rounds(10, seed=0): ...         # FN-Multi rounds

``build`` accepts what :func:`~repro_torch.data.store.open_graph` accepts
(a spec string, a CSRGraph, a Dataset, a GraphStore), a prebuilt
:class:`PaddedGraph`, or on the sharded backend this rank's
:class:`ShardedGraph`. ``device=None`` means the card; the tests pass
``device="cpu"``. Walker ids default to the start vertex ids, so the same
plan and seed give the same walks on every backend and in the JAX package.

The sharded backend runs one program per rank of a ``torch.distributed``
world (``mesh``, default: every rank of the default group; a world of one
without one): every rank calls ``build`` and ``run`` with the same
arguments, walks the walkers that start on its row block, and gets the
whole ``[W, L]`` walks back (an all-gather), with the drops summed over
the world.

``engine.update(deltas)`` applies edge deltas through the engine's
GraphStore and splices only the affected rows into a new device layout
(``repro_torch.engine.update``); runs already enqueued keep the old one.

``engine.analyze(num_walkers)`` (sharded backend) and
:func:`analyze_sharded` (any ``ShardedGraph``, its arrays possibly on
``meta``, up to hundreds of shards, no world needed) give a sharded walk's
roofline terms per superstep and device, analytically.
"""
from __future__ import annotations

import warnings
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as jr
from repro_torch.core.graph import PaddedGraph
from repro_torch.core.walk import run_fused_persistent, run_reference
from repro_torch.core.walk_distributed import ShardedGraph, distributed_walk
from repro_torch.data.store import open_graph
from repro_torch.device import resolve_device
from repro_torch.engine.plan import WalkPlan, WalkResult, WalkStats
from repro_torch.engine.update import (UpdateReport, patch_padded,
                                       patch_sharded)
from repro_torch.launch.mesh import RwMesh, make_rw_mesh
from repro_torch.roofline.traffic import (H100_F32_FLOPS, H100_NVLINK_BW,
                                          walk_auto_capacity,
                                          walk_collective_bytes,
                                          walk_exchange_bytes,
                                          walk_overlap_model,
                                          walk_step_flops)
from repro_torch.tracing import span


def round_seed(seed: int, r: int) -> int:
    """Per-round seed for FN-Multi rounds (as in the JAX package)."""
    return seed * 1000003 + r


def _ready(walks: torch.Tensor) -> Optional[torch.cuda.Event]:
    """An event on the current stream after the walks' last kernel, which
    the copy to the host waits for; None off the card."""
    if walks.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(walks.device))
    return event


def _overlap(g: ShardedGraph, plan: WalkPlan, capacity: int,
             walkers: int) -> dict:
    """Analytic total and exposed exchange bytes of a run of ``walkers``
    walkers (``roofline.traffic.walk_overlap_model``)."""
    width = g.cap if plan.sampler().mode == "approx_always" else g.hot_cap
    return walk_overlap_model(
        g.num_shards, capacity, g.cap, plan.length,
        walkers_per_shard=max(walkers // g.num_shards, 1),
        pipeline=plan.pipeline and plan.length >= 2,
        w_bytes=g.wgt.element_size(), width=width)


def _collective_estimate(g: ShardedGraph, plan: WalkPlan,
                         capacity: int) -> int:
    """Per-device exchange bytes of one barrier-mode run of ``plan``."""
    return walk_collective_bytes(g.num_shards, capacity, g.cap, plan.length,
                                 w_bytes=g.wgt.element_size())


def analyze_sharded(g: ShardedGraph, plan: WalkPlan, capacity: int,
                    num_walkers: Optional[int] = None) -> dict:
    """Roofline terms of the sharded walk of ``plan`` on ``g``, per
    superstep and device, from shapes alone: ``g``'s arrays may be
    ``meta`` tensors and ``g.num_shards`` any size (no world is needed).
    ``capacity`` is the exchange's request slots per destination, as
    ``WalkEngine.build`` settles it.

    The keys are those of the JAX package's ``WalkEngine.analyze``. There,
    ``flops_per_step_per_dev`` and ``coll_bytes_per_step_per_dev`` are read
    from the compiled program (``cost_analysis`` and the optimized HLO's
    collectives); here they are ``traffic.walk_step_flops`` of a shard's
    walkers at the draw's width and one superstep's
    ``traffic.walk_exchange_bytes``. ``graph_bytes_per_dev``,
    ``analytic_coll_bytes_per_dev``, ``capacity``, ``walkers_per_shard``
    and ``overlap_*`` are computed as JAX computes them. Nothing compiles:
    ``compile_seconds`` and ``argument_bytes_per_dev`` are None. The times
    divide by one H100's float32 rate and NVLink rate
    (``roofline.traffic``)."""
    if num_walkers is None:
        num_walkers = g.n
    mode = plan.sampler().mode
    width = g.cap if mode == "approx_always" else g.hot_cap
    w_bytes = g.wgt.element_size()
    walkers_per_shard = num_walkers // g.num_shards
    flops_step = walk_step_flops(walkers_per_shard, width)
    coll = float(walk_exchange_bytes(g.num_shards, capacity, g.cap, w_bytes))
    graph_bytes = sum(t.numel() * t.element_size() for t in (
        g.adj, g.wgt, g.alias_p, g.alias_i, g.hot_ids, g.hot_adj, g.hot_wgt,
        g.hot_alias_p, g.hot_alias_i, g.hot_deg, g.hot_wmin, g.hot_wmax))
    overlap = _overlap(g, plan, capacity, num_walkers)
    return {
        "backend": plan.backend, "mode": plan.mode,
        "pipeline": plan.pipeline,
        "overlap_total_bytes": overlap["total_bytes"],
        "overlap_exposed_bytes": overlap["exposed_bytes"],
        "overlap_efficiency": overlap["efficiency"],
        "cap": g.cap, "hot_cap": g.hot_cap, "capacity": capacity,
        "shards": g.num_shards, "n": g.n,
        "walkers_per_shard": walkers_per_shard,
        "compile_seconds": None,
        "flops_per_step_per_dev": flops_step,
        "coll_bytes_per_step_per_dev": coll,
        "coll_by_op_per_step": {"all-to-all": coll},
        "coll_counts": None,
        "t_compute": flops_step / H100_F32_FLOPS,
        "t_collective": coll / H100_NVLINK_BW,
        "analytic_coll_bytes_per_dev": _collective_estimate(g, plan,
                                                            capacity),
        "graph_bytes_per_dev": int(graph_bytes),
        "argument_bytes_per_dev": None,
    }


class WalkEngine:
    """Executable walk workload: a plan bound to a device layout (and, on
    the sharded backend, to this rank of a mesh)."""

    def __init__(self, plan: WalkPlan, pg: Optional[PaddedGraph] = None,
                 store=None, sg: Optional[ShardedGraph] = None,
                 mesh: Optional[RwMesh] = None,
                 capacity: Optional[int] = None):
        self.plan = plan
        self.pg = pg
        self.sg = sg
        self.mesh = mesh
        self.capacity = capacity
        self.store = store              # GraphStore (update()'s source)
        self._sampler = plan.sampler()
        self._no_hot = pg is not None and int(pg.hot_pos.max()) < 0
        self._delta_edges = 0           # cumulative churn via update()
        self._last_invalidated_fraction = 0.0
        self._copy_stream = None        # made on the first copy from a card
        self.pageable_copies = 0        # card copies without pinned memory

    @classmethod
    def build(cls, graph, plan: WalkPlan, mesh: Optional[RwMesh] = None,
              device=None) -> "WalkEngine":
        """Bind ``plan`` to ``graph`` on ``device`` (default: the mesh's
        device, a prebuilt layout's own, or the card). ``mesh`` is read by
        the sharded backend alone."""
        if isinstance(graph, ShardedGraph) and plan.backend != "sharded":
            raise ValueError(
                f"ShardedGraph input requires backend='sharded', "
                f"got {plan.backend!r}")
        if device is None and mesh is not None:
            device = mesh.device
        if isinstance(graph, (PaddedGraph, ShardedGraph)):
            if device is not None and \
                    torch.device(device) != graph.device:
                raise ValueError(f"the layout lives on {graph.device}, "
                                 f"not {device}")
            device, store = graph.device, None
        else:
            device = resolve_device(device)
            store = open_graph(graph)
            graph = store.graph
        if plan.backend != "sharded":
            pg = graph if isinstance(graph, PaddedGraph) else \
                PaddedGraph.build(graph, cap=plan.cap, hot_cap=plan.hot_cap,
                                  device=device)
            return cls(plan, pg, store)

        rw = make_rw_mesh(mesh, device)
        pg = None
        if isinstance(graph, ShardedGraph):
            sg, deg = graph, None
            if (sg.num_shards, sg.rank) != (rw.size, rw.rank):
                raise ValueError(
                    f"ShardedGraph built for shard {sg.rank} of "
                    f"{sg.num_shards} but this is rank {rw.rank} of a "
                    f"world of {rw.size}")
        elif isinstance(graph, PaddedGraph):
            pg = graph
            sg, deg = ShardedGraph.build(pg, rw.size, rw.rank), pg.deg.cpu()
        else:
            # this rank's rows straight from the CSR, no dense whole-graph
            # PaddedGraph
            sg = ShardedGraph.from_csr(graph, rw.size, cap=plan.cap,
                                       hot_cap=plan.hot_cap, rank=rw.rank,
                                       device=rw.device)
            deg = graph.deg
        # capacity default: a whole walker block per destination, zero
        # drops at any skew; pipelined exchanges carry one cohort (half a
        # block) each
        per_cohort = (sg.n_local + 1) // 2 if plan.pipeline else sg.n_local
        if plan.capacity == "auto":
            # hot vertices are replicated and never take slots, so the
            # demand follows the cold degree mass
            if deg is None:
                raise ValueError(
                    "capacity='auto' needs every vertex's degree: build the "
                    "engine from a graph or a PaddedGraph, or pass an int")
            capacity = walk_auto_capacity(
                np.asarray(deg)[:sg.n_orig], cap=sg.cap,
                num_shards=sg.num_shards, walkers_per_shard=per_cohort)
        elif plan.capacity is not None:
            capacity = int(plan.capacity)
        else:
            capacity = per_cohort
        return cls(plan, pg, store, sg=sg, mesh=rw, capacity=capacity)

    @property
    def n(self) -> int:
        """Number of real (unpadded) vertices."""
        return self.sg.n_orig if self.sg is not None else self.pg.n

    @property
    def device(self) -> torch.device:
        return self.sg.device if self.sg is not None else self.pg.device

    def _fused_persistent(self) -> bool:
        """The whole-walk kernel runs when the layout lets it: fused +
        pipeline, exact sampling, FN-Base (no hot set), length >= 2.
        Otherwise the per-step kernel runs; walks are identical."""
        return (self.plan.backend == "fused" and self.plan.pipeline
                and self._sampler.mode == "exact" and self.plan.length >= 2
                and self._no_hot)

    def _update_meta(self):
        """(graph_version, delta_edges, invalidated fraction), taken when a
        run is enqueued, so streamed rounds report the graph they walked."""
        gv = self.store.version if self.store is not None else 0
        return (gv, self._delta_edges, self._last_invalidated_fraction)

    def _dispatch(self, starts, seed: int, walker_ids):
        """Enqueue one run; returns (walks tensor on the device, the drops
        or None, the row count to keep or None, the update snapshot, the
        walks' :func:`_ready` event)."""
        with span("walk.dispatch", supersteps=self.plan.length):
            dev = self.device
            key = jr.PRNGKey(seed, device=dev)
            if self.sg is not None:
                return self._dispatch_sharded(starts, key, walker_ids)
            if starts is None:
                starts = np.arange(self.pg.n, dtype=np.int32)
            starts = torch.as_tensor(np.asarray(starts, np.int32),
                                     device=dev)
            walker_ids = starts if walker_ids is None else torch.as_tensor(
                np.asarray(walker_ids, np.int32), device=dev)
            run = run_fused_persistent if self._fused_persistent() \
                else run_reference
            walks = run(self.pg, starts, walker_ids.long(), key,
                        self._sampler, self.plan.length)
            return walks, None, None, self._update_meta(), _ready(walks)

    def _dispatch_sharded(self, starts, key, walker_ids):
        """This rank walks its block of ``starts`` (which every rank is
        given whole); the blocks are all-gathered and the drops summed."""
        g, mesh = self.sg, self.mesh
        slice_to = None
        if starts is None:
            starts = np.arange(g.n, dtype=np.int32)
            slice_to = g.n_orig       # padding vertices walk self-loops
        starts = np.asarray(starts, np.int32)
        if starts.shape[0] % g.num_shards:
            raise ValueError(
                f"walker count {starts.shape[0]} must divide evenly over "
                f"{g.num_shards} shards")
        # walker block s starts on shard s and reads its start rows
        # locally, so each start must live on the shard of its position
        w_local = starts.shape[0] // g.num_shards
        owner = starts // g.n_local
        placed = np.arange(starts.shape[0]) // max(w_local, 1)
        if not np.array_equal(owner, placed):
            bad = int(np.nonzero(owner != placed)[0][0])
            raise ValueError(
                f"starts must be grouped by owning shard (vertex id // "
                f"{g.n_local}): starts[{bad}]={int(starts[bad])} belongs "
                f"to shard {int(owner[bad])} but is placed on shard "
                f"{int(placed[bad])}")
        walker_ids = starts if walker_ids is None else \
            np.asarray(walker_ids, np.int32)
        block = slice(mesh.rank * w_local, (mesh.rank + 1) * w_local)
        walks, drops = distributed_walk(
            g, mesh.group, self._sampler, self.capacity, self.plan.length,
            torch.from_numpy(starts[block]).to(g.device),
            torch.from_numpy(walker_ids[block]).to(g.device), key,
            pipeline=self.plan.pipeline)
        if mesh.group is not None:
            parts = [torch.empty_like(walks) for _ in range(mesh.size)]
            dist.all_gather(parts, walks, group=mesh.group)
            walks = torch.cat(parts)
            dist.all_reduce(drops, group=mesh.group)
        return walks, drops, slice_to, self._update_meta(), _ready(walks)

    def _finalize(self, dispatched) -> WalkResult:
        walks, drops, slice_to, (gv, delta_edges, inv_frac), ready = \
            dispatched
        walks = self._to_host(walks, ready)
        if slice_to is not None:
            walks = walks[:slice_to]
        dropped = int(drops) if drops is not None else 0
        if dropped:
            msg = (f"{dropped} NEIG requests dropped (capacity="
                   f"{self.capacity}); affected walkers stayed put for those"
                   f" steps — raise WalkPlan.capacity or walk fewer vertices"
                   f" per round (FN-Multi)")
            if self.plan.strict_drops:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        overlap = self._overlap_estimate(int(walks.shape[0]))
        stats = WalkStats(backend=self.plan.backend,
                          walkers=int(walks.shape[0]),
                          supersteps=self.plan.length, dropped=dropped,
                          collective_bytes=overlap["total_bytes"],
                          exposed_collective_bytes=overlap["exposed_bytes"],
                          overlap_efficiency=overlap["efficiency"],
                          graph_version=gv, delta_edges=delta_edges,
                          invalidated_shard_fraction=inv_frac)
        return WalkResult(walks=walks, stats=stats)

    def _to_host(self, walks: torch.Tensor, ready) -> np.ndarray:
        """``walks`` as a numpy array. From a card they are copied on the
        engine's copy stream, once ``ready`` has passed, into page-locked
        memory from PyTorch's caching host allocator: the copy runs beside
        whatever the compute stream has been given since (the next round's
        kernels), at the host link's rate. The array holds its pinned block
        until the caller drops it. Where no pinned block can be had, the
        walks take ``walks.cpu()`` (counted in ``pageable_copies``)."""
        if ready is None:
            with span("walk.copy", walks.device):
                return walks.cpu().numpy()
        try:
            host = torch.empty(walks.shape, dtype=walks.dtype,
                               pin_memory=True)
        except RuntimeError as e:
            self.pageable_copies += 1
            warnings.warn(f"no page-locked memory for the walks ({e}); "
                          f"copied to pageable memory", RuntimeWarning,
                          stacklevel=4)
            with span("walk.copy", walks.device, pinned=0):
                return walks.cpu().numpy()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(walks.device)
        side = self._copy_stream
        side.wait_event(ready)
        with torch.cuda.stream(side):
            with span("walk.copy", walks.device, pinned=1):
                host.copy_(walks, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        walks.record_stream(side)
        done.synchronize()
        return host.numpy()

    def _overlap_estimate(self, walkers: int) -> dict:
        """Analytic total and exposed exchange bytes of a run of
        ``walkers`` walkers (``roofline.traffic.walk_overlap_model``)."""
        if self.sg is None:
            return {"total_bytes": 0, "exposed_bytes": 0, "efficiency": 0.0}
        return _overlap(self.sg, self.plan, self.capacity, walkers)

    def analyze(self, num_walkers: Optional[int] = None) -> dict:
        """:func:`analyze_sharded` of this engine's layout, plan and
        capacity; the sharded backend only, as JAX's."""
        if self.sg is None:
            raise ValueError("analyze() requires the sharded backend")
        return analyze_sharded(self.sg, self.plan, self.capacity,
                               num_walkers)

    def run(self, starts=None, seed: int = 0, walker_ids=None) -> WalkResult:
        """Walk ``starts`` (default: every vertex) with the bound plan."""
        return self._finalize(self._dispatch(starts, seed, walker_ids))

    def rounds(self, num_rounds: int, seed: int = 0,
               start: int = 0) -> Iterator[WalkResult]:
        """FN-Multi rounds: round ``k+1`` is enqueued on the device before
        round ``k`` is copied to the host and yielded, so on a card round
        ``k``'s copy runs beside round ``k+1``'s kernels. A yielded array
        walked on a card holds page-locked host memory for as long as it
        is held; drop the rounds already consumed."""
        if num_rounds <= start:
            return
        pending = self._dispatch(None, round_seed(seed, start), None)
        for r in range(start, num_rounds):
            nxt = self._dispatch(None, round_seed(seed, r + 1), None) \
                if r + 1 < num_rounds else None
            yield self._finalize(pending)
            pending = nxt

    def update(self, deltas) -> UpdateReport:
        """Apply edge deltas to the resident graph without a whole-graph
        rebuild: the store patches the host CSR shard-locally, then only
        the affected rows' adjacency, alias tables and FN-Cache hot entries
        are spliced into a new layout (a full relayout only when the
        layout's shapes can no longer hold the new graph). Walks after
        ``update()`` equal those of an engine built from scratch at the
        same store version."""
        if self.store is None:
            raise ValueError(
                "update() needs the engine's GraphStore — build the engine "
                "from a spec string, CSRGraph, Dataset, or GraphStore (a "
                "prebuilt PaddedGraph carries no host CSR to patch)")
        patch = self.store.apply(deltas)
        g, aff = self.store.graph, patch.affected
        if self.sg is None:
            self.pg, relayout, hot_rows = patch_padded(
                self.pg, g, aff, self.plan.cap, self.plan.hot_cap)
            if relayout:
                self._no_hot = int(self.pg.hot_pos.max()) < 0
            device_shards = patch.num_shards
            invalidated = device_shards if relayout \
                else int(len(patch.affected_shards))
        else:
            # the capacity stays as built, so the exchange's shapes hold
            self.sg, relayout, inv_shards, hot_rows = patch_sharded(
                self.sg, g, aff, self.plan.cap, self.plan.hot_cap)
            device_shards = self.sg.num_shards
            invalidated = int(len(inv_shards))
        self._delta_edges += patch.delta_edges
        self._last_invalidated_fraction = invalidated / max(device_shards, 1)
        return UpdateReport(
            patch=patch, version=self.store.version, relayout=relayout,
            device_shards=device_shards,
            invalidated_device_shards=invalidated,
            hot_rows_updated=hot_rows)


"""One run of one cell: set-up, the measured (or traced) window, then the
check against the plain reference.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix ``mixes/<traffic>.json``, the mix's
kind ``traffic/<kind>.py`` (see ``units.py``), and for each per-layer
metric the reader ``metrics/<name>.py``. The configuration's ``plan`` and
``trainer``, each updated by the mix's own, go to ``WalkPlan`` and
``StreamingSGNSTrainer`` as they stand. A cell of more than one chip runs
one process a chip, each a rank of one ``torch.distributed`` world (see
:func:`run_world`). Adding a cell, a mix, a kind or a metric adds files
and entries; it edits none of this.

The port is driven through its public API: ``WalkEngine.build``,
``WalkEngine.rounds``, ``WalkEngine.run``, ``StreamingSGNSTrainer.consume``,
``loss_history`` and ``tables`` (and, to read the first optimizer steps,
the trainer's optimizer: ``traffic/train_stream.py``). The program is
imported here and in ``traffic/``, never in ``reference.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from n2vbench import graphs, peaks, profiling, units

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# seconds a rank may take to end after rank 0's window has closed
RANK_GRACE_S = 120


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict              # the configuration's file, plan and trainer
    mix: dict                 # updated by the mix's own
    chips: int
    end_to_end: list          # metric entries of BENCHMARK.json
    per_layer: list

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


def cell_of(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark, its files read. Every per-layer
    metric lists the cells that report it under ``workloads``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    mix = load_json(BENCH / "mixes" / f"{w['traffic']}.json")
    for part in ("plan", "trainer"):
        config[part] = dict(config.get(part, {}), **mix.get(part, {}))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", (name,))]
    per = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, config, mix, int(w["chips"]), e2e, per)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.name!r}")
    spec = importlib.util.spec_from_file_location(
        f"n2vbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def traffic_kind(kind: str):
    """The ``Traffic`` class of ``traffic/<kind>.py``."""
    return _module("traffic", kind).Traffic


def sub_seeds(seed: int) -> dict:
    """The run's seeds, all from ``--seed``: the graph's, the walks', the
    trainer's and the check sample's."""
    rng = np.random.default_rng(int(seed))
    g, w, t, s = (int(x) for x in rng.integers(0, 2 ** 31, 4))
    return {"graph": g, "walk": w, "train": t, "sample": s}


# -------------------------------------------------------------- world --

def _world() -> tuple:
    """(rank, size) of this process's ``torch.distributed`` world."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _agree(flag: bool, device) -> bool:
    """Rank 0's ``flag`` on every rank (each decides the same way)."""
    if _world()[1] == 1:
        return flag
    import torch.distributed as dist
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def _reduce(value: float, device, op: str) -> float:
    if _world()[1] == 1:
        return value
    import torch.distributed as dist
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op={"max": dist.ReduceOp.MAX,
                           "sum": dist.ReduceOp.SUM}[op])
    return float(t.item())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_world(init: str, rank: int, size: int, device) -> None:
    import torch.distributed as dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, world_size=size,
                            rank=rank)


def leave_world() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def device_of(kind: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if kind == "cuda" \
        else torch.device("cpu")


def run_world(cell: Cell, seed: int, seconds: float, trace: bool,
              kind: str, t_start: float, log=print):
    """:func:`run` on ``cell.chips`` devices: this process is rank 0 and
    starts ranks 1.. as ``rank.py`` processes, each on its own chip (on
    the CPU, ``kind == "cpu"``, over gloo), then waits for them. Returns
    rank 0's result."""
    if cell.chips == 1:
        return run(cell, seed, seconds, trace, device_of(kind, 0), t_start,
                   log)
    init = f"tcp://127.0.0.1:{_free_port()}"
    spec = {"cell": cell.as_json(), "seed": int(seed),
            "seconds": float(seconds), "trace": bool(trace), "kind": kind,
            "init": init, "size": cell.chips}
    procs = [subprocess.Popen(
        [sys.executable, str(BENCH / "rank.py"),
         json.dumps(dict(spec, rank=r))], stdout=subprocess.DEVNULL)
        for r in range(1, cell.chips)]
    try:
        device = device_of(kind, 0)
        join_world(init, 0, cell.chips, device)
        out = run(cell, seed, seconds, trace, device, t_start, log)
        for p in procs:
            p.wait(timeout=RANK_GRACE_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"a rank ended with {bad}")
    return out


# ---------------------------------------------------------------- run --

@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    trace: object = None
    layout_build_s: float = 0.0
    peaks: dict = None
    deg: np.ndarray = None
    walk_units: list = None      # (starts, walks) of the traced units
    supersteps: int = 0          # walk supersteps dispatched while traced
    train_steps: int = 0         # optimizer steps taken while traced
    sgns: dict = None            # vocab, dim, batch, k of the trainer


@contextlib.contextmanager
def kernel_build_clock(found: dict):
    """Seconds of each of the port's kernel loads (``kernels/build.py``)
    that compiled its source, by source name into ``found``."""
    from repro_torch.kernels import build
    load = build.load

    def timed(name):
        t0 = time.perf_counter()
        try:
            return load(name)
        finally:
            if name not in found and build.report(name):
                found[name] = time.perf_counter() - t0
    build.load = timed
    try:
        yield
    finally:
        build.load = load


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print):
    """One run of ``cell`` on this rank; returns, on rank 0, the result
    line's fields and the checks (None on other ranks). ``t_start`` is
    the process's start on the host clock."""
    from repro_torch.core.graph import CSRGraph
    from repro_torch.engine import WalkEngine, WalkPlan

    rank, _ = _world()
    if rank:
        log = lambda *_: None  # noqa: E731
    cfg, mix = cell.config, cell.mix
    device = torch.device(device)
    seeds = sub_seeds(seed)
    g = graphs.rmat_graph(cfg, seeds["graph"], device)
    row_ptr, col, wgt = g.numpy()
    log(f"graph {cfg['name']}: {graphs.degree_summary(g)}, "
        f"hot {graphs.hot_count(g, cfg['plan'].get('cap'))}")
    built = {}
    with kernel_build_clock(built):
        t0 = time.perf_counter()
        engine = WalkEngine.build(
            CSRGraph(n=g.n, row_ptr=row_ptr, col=col, wgt=wgt),
            WalkPlan(**cfg["plan"]), device=device)
        units.sync(device)
        layout_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        env = units.Env(engine=engine, g=g, config=cfg, plan=cfg["plan"],
                        trainer=cfg["trainer"], mix=mix, seeds=seeds,
                        device=device)
        traffic = traffic_kind(mix["kind"])(env)
        traffic.warm_up()
        units.sync(device)
    t2 = time.perf_counter()
    setup_s = t2 - t_start
    log(f"set-up {setup_s:.3f} s: to the layout {t0 - t_start:.3f} s, "
        f"layout {layout_s:.3f} s, warm-up {t2 - t1:.3f} s")
    log(f"kernel build (nvcc, inside set-up): {sum(built.values()):.3f} s"
        f" {sorted(built)}")

    traffic.open_window()
    result = {}
    ctx = Context(layout_build_s=layout_s,
                  peaks=peaks.of(_device_name(device)),
                  deg=(row_ptr[1:] - row_ptr[:-1]))
    if trace:
        traffic.keep_all = True
        traffic.prepare()
        n_units = int(mix["trace_units"])
        t0 = time.perf_counter()

        def window():
            for _ in range(n_units):
                traffic.unit()
        _, tr = profiling.traced(window, device)
        ctx.trace = tr
        traffic.trace_context(ctx, n_units)
        traffic.keep_all = False
        traffic.prepare()
        _, named = profiling.traced(traffic.unit, device, host=True)
        log(f"traces read {time.perf_counter() - t0:.3f} s after the "
            f"window opened: {len(tr.device)} device events, then "
            f"{len(named.device)} device and {len(named.host)} host events")
        window_s = tr.window_s
        busy_s = _reduce(profiling.busy_seconds(tr), device, "sum") \
            / _world()[1]
    else:
        t0 = time.perf_counter()
        ends = []
        while True:
            traffic.unit()
            ends.append(time.perf_counter())
            if _agree(ends[-1] - t0 >= seconds, device):
                break
        traffic.close_window()
        window_s = time.perf_counter() - t0
        took = np.diff([t0] + ends)
        log(f"unit seconds: min {took.min():.4f} median "
            f"{np.median(took):.4f} max {took.max():.4f}")
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                result[m["name"]] = traffic.rate(m["name"], window_s)
        missing = sorted(k for k, v in result.items() if v is None)
        if missing:
            raise RuntimeError(f"traffic kind {mix['kind']!r} counts no "
                               f"{missing}")
        result["setup_s"] = setup_s
    attempted = traffic.attempted()
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    memory_peak = int(_reduce(memory_peak, device, "max"))
    log(f"window {window_s:.3f} s, {traffic.units} units, peak "
        f"{memory_peak} bytes")
    metrics = {}
    if trace and rank == 0:
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    traffic.release()
    del engine, env
    ctx = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    leave_world()
    if rank:
        return None

    t0 = time.perf_counter()
    found = traffic.check()
    log(f"reference {time.perf_counter() - t0:.3f} s")
    limits = dict(mix["limits"])
    missing = sorted(set(limits) - set(found))
    if missing:
        raise RuntimeError(f"checks {missing} were not computed")
    compared = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": traffic.failed(found), "memory_peak": memory_peak,
           "checks": compared}
    if trace:
        out["metrics"] = metrics
        out["busy_s"] = busy_s
        out["window_s"] = window_s
        out["breakdown"] = {"device_ops": profiling.top_ops(tr),
                            "idle_gaps": profiling.idle_gaps(named)}
    else:
        out["metrics"] = {m["name"]: {"value": float(result[m["name"]]),
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    return out


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in sys.modules if m.split(".")[0] in bad)


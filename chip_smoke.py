#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of the walk engine on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``. It
builds the kernels of ``src/repro_torch/kernels/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, on
   inputs made from a numpy seed (slots and walks must be ``torch.equal``);
2. main path A — the per-step ``node2vec_step`` kernel on the FN-Cache
   layout: ``WalkEngine.build("wec:k=17,deg=100,seed=0", WalkPlan(
   backend="fused", cap=128, ...))``, two FN-Multi rounds in exact and in
   approx mode, every vertex a walker; walks must equal the reference
   backend's and the kernel must launch once per superstep;
3. main path B — the whole-walk ``node2vec_walk`` kernel on the FN-Base
   layout (``er:k=18,deg=100,seed=0``, ``pipeline=True``, one round); walks
   must equal the reference backend's, one launch;
4. times each kernel and its plain version with CUDA events at the main
   path's inputs, beside the least time the card could take for them: the
   bytes the draws need (live lanes only, not the PAD lanes that pad each
   row to the widest) over 3.35 TB/s, or float32 operations over
   67 TFLOP/s, whichever is larger;
5. profiles one more round of each path with ``torch.profiler``: the
   round's wall seconds, the share of it the device was busy, and the
   kernels with the most device time.

It prints the card's name and power limit, the build seconds, walker-steps
per second for each phase, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/node2vec_step.cu"
LENGTH = 80
TOP = 8                         # kernels listed per profiled round


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_err(got, want) -> int:
    """Largest |got - want| of two integer tensors of one shape."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def walks_err(np, a, b) -> int:
    """Largest |a - b| over two lists of walk arrays of equal shapes."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError("walk lists differ in length or shape")
    return max(int(np.abs(x.astype(np.int64) - y).max())
               for x, y in zip(a, b))


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_round(torch, engine, label: str) -> None:
    """Profile one warm round of ``engine``: its wall seconds (host clock,
    ending in a synchronize), the share of that window the device was busy
    (the summed time of the device's own events), and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                    key=device_us, reverse=True)
    busy = sum(map(device_us, events)) / 1e6
    log(f"profile {label}: round {wall:.4f} s under the profiler, device "
        f"busy {busy:.4f} s = {busy / wall:.3f} of the window"
        + ("" if events else " (the trace holds no device time)"))
    for e in events[:TOP]:
        log(f"  {device_us(e) / 1e3:10.3f} ms {e.count:7d} calls "
            f"{device_us(e) / 1e6 / busy:6.3f}  {e.key[:80]}")


# ------------------------------------------------------- seeded inputs --

def step_inputs(np, rng, w: int, d: int, dp: int, pad: int):
    """Sorted candidate rows, overlapping sorted prev rows, u in N(v)."""
    deg = rng.integers(1, d + 1, w)
    cand = np.sort(rng.integers(0, 1 << 20, (w, d)), axis=1) + np.arange(d)
    lane = np.arange(d)[None, :]
    cand = np.where(lane < deg[:, None], cand, pad).astype(np.int32)
    cw = np.where(lane < deg[:, None],
                  rng.random((w, d)) + 0.1, 0.0).astype(np.float32)
    # prev rows mix candidates (membership hits) with other ids
    pick = cand[np.arange(w)[:, None],
                rng.integers(0, deg[:, None], (w, dp))]
    other = rng.integers(0, (1 << 20) + d, (w, dp))
    prev = np.where(rng.random((w, dp)) < 0.5, pick, other)
    degp = rng.integers(1, dp + 1, w)
    prev = np.where(np.arange(dp)[None, :] < degp[:, None], prev, pad)
    prev = np.sort(prev, axis=1).astype(np.int32)
    u = cand[np.arange(w), rng.integers(0, deg)].astype(np.int32)
    r = rng.random(w).astype(np.float32)
    return cand, cw, u, prev, r


def walk_inputs(np, rng, n: int, d: int, w: int, steps: int, pad: int):
    """A padded random graph (some dead ends) and walkers on it."""
    deg = rng.integers(0, d + 1, n)
    deg[rng.random(n) < 0.05] = 0
    lane = np.arange(d)[None, :]
    adj = np.sort(rng.integers(0, n - d, (n, d)), axis=1) + np.arange(d)
    adj = np.where(lane < deg[:, None], adj, pad).astype(np.int32)
    wgt = np.where(lane < deg[:, None],
                   rng.random((n, d)) + 0.1, 0.0).astype(np.float32)
    u0 = rng.integers(0, n, w).astype(np.int32)
    v1 = rng.integers(0, n, w).astype(np.int32)
    rand = rng.random((w, steps)).astype(np.float32)
    return adj, wgt, deg.astype(np.int32), u0, v1, rand


# --------------------------------------------------------------- phases --

def check_kernels(np, torch, K, pad):
    """Phase 1: each kernel equals its plain version on the card. Returns
    the largest |kernel - plain| of each kernel (slots, vertex ids)."""
    dev = torch.device("cuda")
    step_err = walk_err = 0
    rng = np.random.default_rng(0)
    cases = [(7, 1, 1), (7, 130, 300), (7, 793, 130), (4096, 1, 793),
             (4096, 300, 300), (4096, 793, 793), (65536, 130, 130),
             (65536, 793, 793), (64, 20000, 20000)]   # the last: scratch path
    for w, d, dp in cases:
        args = [torch.from_numpy(a).to(dev)
                for a in step_inputs(np, rng, w, d, dp, pad)]
        for p, q in ((0.5, 2.0), (2.0, 0.5), (1.0, 1.0)):
            got = K.node2vec_step(*args, p, q)
            want = K.node2vec_step_plain(*args, p, q)
            torch.cuda.synchronize()
            step_err = max(step_err, int_err(got, want))
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"node2vec_step W={w} D={d} DP={dp} "
                                     f"p={p} q={q}: {bad} slots differ")
    log(f"node2vec_step == plain on {len(cases)} shapes x 3 (p, q)")
    for n, d, w, steps in [(64, 1, 7, 5), (4096, 130, 4096, 12),
                           (8192, 300, 65536, 6), (2048, 793, 7, 9),
                           (40000, 20000, 8, 3)]:
        args = [torch.from_numpy(a).to(dev)
                for a in walk_inputs(np, rng, n, d, w, steps, pad)]
        got = K.node2vec_walk(*args, 0.5, 2.0)
        want = K.node2vec_walk_plain(*args, 0.5, 2.0)
        torch.cuda.synchronize()
        walk_err = max(walk_err, int_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"node2vec_walk n={n} D={d} W={w}: "
                                 f"{int((got != want).sum())} differ")
    log("node2vec_walk == plain on 5 shapes")
    return step_err, walk_err


def drive(torch, engine, rounds: int):
    """Run ``rounds`` FN-Multi rounds; returns (walks list, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walks = [r.walks for r in engine.rounds(rounds, seed=0)]
    torch.cuda.synchronize()
    return walks, time.perf_counter() - t0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import random as jr
    from repro_torch.core.graph import PAD_ID
    from repro_torch.core.walk import step_uniforms, unified_row
    from repro_torch.engine import WalkEngine, WalkPlan
    from repro_torch.kernels import build
    from repro_torch.kernels import node2vec_step as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load("node2vec_step")
    log(f"kernel build: {time.perf_counter() - t0:.2f} s host")

    step_err, walk_err = check_kernels(np, torch, K, PAD_ID)

    # ---- main path A: per-step kernel, FN-Cache ------------------------
    spec_a = "wec:k=17,deg=100,seed=0"
    t0 = time.perf_counter()
    first = WalkEngine.build(spec_a, WalkPlan(
        p=1.0, q=0.5, length=LENGTH, cap=128, backend="fused"))
    pg_a = first.pg
    log(f"A: {spec_a}: n={pg_a.n} m={first.store.graph.m} "
        f"max_deg={pg_a.hot_cap} hot={pg_a.num_hot} layout built in "
        f"{time.perf_counter() - t0:.2f} s host")
    step_launches = {}
    for mode in ("exact", "approx"):
        kw = dict(p=1.0, q=0.5, length=LENGTH, cap=128, mode=mode)
        fused = WalkEngine.build(pg_a, WalkPlan(backend="fused", **kw))
        ref = WalkEngine.build(pg_a, WalkPlan(backend="reference", **kw))
        K.node2vec_step.launches = 0
        K.node2vec_walk.launches = 0
        walks, secs = drive(torch, fused, 2)
        step_launches[mode] = K.node2vec_step.launches
        if (K.node2vec_step.launches, K.node2vec_walk.launches) != \
                (2 * (LENGTH - 1), 0):
            raise AssertionError(
                f"A/{mode}: launches step={K.node2vec_step.launches} "
                f"walk={K.node2vec_walk.launches}, want {2 * (LENGTH - 1)}"
                f" and 0")
        ref_walks, ref_secs = drive(torch, ref, 2)
        err = walks_err(np, walks, ref_walks)
        step_err = max(step_err, err)
        if err:
            raise AssertionError(f"A/{mode}: fused walks differ from the "
                                 f"reference backend")
        w = walks[0]
        if w.shape != (pg_a.n, LENGTH) or w.min() < 0 or w.max() >= pg_a.n:
            raise AssertionError(f"A/{mode}: bad walks {w.shape}")
        steps = 2 * pg_a.n * LENGTH
        log(f"A/{mode}: fused {steps / secs:.4g} walker-steps/s "
            f"({secs:.3f} s), reference {steps / ref_secs:.4g} "
            f"walker-steps/s; == reference; node2vec_step launches "
            f"{step_launches[mode]}")
        profile_round(torch, fused, f"A/{mode} fused")

    # superstep s of path A's round 0 (seed 0), for timing the step kernel:
    # walks[:, k] is the vertex after step k, so u = walks[:, s - 2] and
    # v = walks[:, s - 1]
    starts = torch.arange(pg_a.n, dtype=torch.int32, device="cuda")
    walk_a = torch.from_numpy(ref_walks[0]).cuda()
    s = LENGTH // 2
    u_s = walk_a[:, s - 2].contiguous()
    v_s = walk_a[:, s - 1].contiguous()
    cand, cw, _ = unified_row(pg_a, v_s, ("adj", "wgt"))
    prev, _ = unified_row(pg_a, u_s, ("adj",))
    rand = step_uniforms(jr.PRNGKey(0, device="cuda"), starts.long(),
                         s + 1)[:, s - 1].contiguous()
    step_args = (cand, cw, u_s, prev, rand, 1.0, 0.5)
    got = K.node2vec_step(*step_args)
    want = K.node2vec_step_plain(*step_args)
    step_err = max(step_err, int_err(got, want))
    if not torch.equal(got, want):
        raise AssertionError("node2vec_step differs on path A's inputs")
    step_ms = cuda_ms(torch, lambda: K.node2vec_step(*step_args), 20)
    step_plain_ms = cuda_ms(torch, lambda: K.node2vec_step_plain(
        *step_args), 5)
    wk, d = cand.shape
    dp = prev.shape[1]
    # what the draws need: v's ids up to and including the PAD edge, its
    # live weights, u's live prev ids, and u, r and the slot of each walker
    live_v = (cand != PAD_ID).sum(1)
    live_u = (prev != PAD_ID).sum(1)
    step_bound = bound_ms(
        int((4 * live_v.add(1).clamp(max=d) + 4 * live_v + 4 * live_u).sum())
        + 12 * wk, 3 * int(live_v.sum()))
    padded_ms = wk * (4 * d + 4 * d + 4 * dp + 12) / HBM_BYTES_PER_S * 1e3
    log(f"node2vec_step W={wk} D={d} DP={dp} (mean live lanes "
        f"{float(live_v.double().mean()):.2f} of v, "
        f"{float(live_u.double().mean()):.2f} of u): {step_ms:.4f} ms, plain "
        f"{step_plain_ms:.4f} ms, bound {step_bound[0]:.4f} ms "
        f"({step_bound[1]}; {padded_ms:.4f} ms over the padded rows)")
    del first, fused, ref, walks, ref_walks, cand, cw, prev

    # ---- main path B: whole-walk kernel, FN-Base -----------------------
    spec_b = "er:k=18,deg=100,seed=0"
    kw = dict(p=1.0, q=0.5, length=LENGTH, pipeline=True)
    t0 = time.perf_counter()
    fused = WalkEngine.build(spec_b, WalkPlan(backend="fused", **kw))
    pg_b = fused.pg
    mbytes = sum(getattr(pg_b, f).numel() * getattr(pg_b, f).element_size()
                 for f in ("adj", "wgt", "deg", "alias_p", "alias_i"))
    log(f"B: {spec_b}: n={pg_b.n} m={fused.store.graph.m} "
        f"max_deg={pg_b.cap} layout {mbytes / 1e6:.1f} MB, built in "
        f"{time.perf_counter() - t0:.2f} s host")
    if not fused._fused_persistent():
        raise AssertionError("B: the whole-walk kernel path is not live")
    ref = WalkEngine.build(pg_b, WalkPlan(backend="reference", **kw))
    K.node2vec_step.launches = 0
    K.node2vec_walk.launches = 0
    walks, secs = drive(torch, fused, 1)
    walk_launches = K.node2vec_walk.launches
    if (K.node2vec_walk.launches, K.node2vec_step.launches) != (1, 0):
        raise AssertionError(
            f"B: launches walk={K.node2vec_walk.launches} "
            f"step={K.node2vec_step.launches}, want 1 and 0")
    ref_walks, ref_secs = drive(torch, ref, 1)
    walk_err = max(walk_err, walks_err(np, walks, ref_walks))
    if walk_err:
        raise AssertionError("B: fused walks differ from the reference")
    steps = pg_b.n * LENGTH
    log(f"B: fused {steps / secs:.4g} walker-steps/s ({secs:.3f} s), "
        f"reference {steps / ref_secs:.4g} walker-steps/s; == reference; "
        f"node2vec_walk launches {walk_launches}")
    profile_round(torch, fused, "B fused+pipeline")

    starts = torch.arange(pg_b.n, dtype=torch.int32, device="cuda")
    v1 = torch.from_numpy(walks[0][:, 0].copy()).cuda()
    rand = step_uniforms(jr.PRNGKey(0, device="cuda"), starts.long(),
                         LENGTH)
    walk_args = (pg_b.adj, pg_b.wgt, pg_b.deg, starts, v1, rand, 1.0, 0.5)
    tail = K.node2vec_walk(*walk_args)
    want = K.node2vec_walk_plain(*walk_args)
    walk_err = max(walk_err, int_err(tail, want),
                   walks_err(np, [tail.cpu().numpy()], [walks[0][:, 1:]]))
    if not torch.equal(tail, want) or \
            not np.array_equal(tail.cpu().numpy(), walks[0][:, 1:]):
        raise AssertionError("node2vec_walk differs on path B's inputs")
    walk_ms = cuda_ms(torch, lambda: K.node2vec_walk(*walk_args), 3)
    walk_plain_ms = cuda_ms(torch, lambda: K.node2vec_walk_plain(
        *walk_args), 1)
    n, d = pg_b.adj.shape
    wk, st = rand.shape
    # what the walk needs: u0's live row once, then per step v's ids up to
    # and including the PAD edge and its live weights (v = walks[:, s]),
    # one uniform in and one vertex out; u0 and v1 in per walker
    deg_v = pg_b.deg[torch.from_numpy(
        np.ascontiguousarray(walks[0][:, :st])).cuda().long()].long()
    walk_bound = bound_ms(
        int((4 * deg_v.add(1).clamp(max=d) + 4 * deg_v).sum())
        + 8 * deg_v.numel() + 4 * int(pg_b.deg[starts.long()].long().sum())
        + 8 * wk, 3 * int(deg_v.sum()))
    padded_ms = wk * (st * (8 * d + 12) + 4 * d + 8) / HBM_BYTES_PER_S * 1e3
    log(f"node2vec_walk W={wk} steps={st} D={d} (mean live lanes "
        f"{float(deg_v.double().mean()):.2f} of v): {walk_ms:.4f} ms, plain "
        f"{walk_plain_ms:.4f} ms, bound {walk_bound[0]:.4f} ms "
        f"({walk_bound[1]}; {padded_ms:.4f} ms over the padded rows)")

    kernels = [
        {"name": "node2vec_step", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/node2vec_step.py:92",
         "launches": step_launches["exact"], "max_abs_err": step_err,
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None},
        {"name": "node2vec_walk", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/node2vec_step.py:192",
         "launches": walk_launches, "max_abs_err": walk_err,
         "ms": walk_ms, "plain_ms": walk_plain_ms, "bound_ms": walk_bound[0],
         "bound_by": walk_bound[1], "library_ms": None},
    ]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

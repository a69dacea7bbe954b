#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (walks, SGNS training, LM serving and
embedding serving under graph churn) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``. It
builds the kernels of ``src/repro_torch/kernels/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, on
   inputs made from a numpy seed (slots and walks must be ``torch.equal``):
   ``node2vec_step``'s row entry at nine shapes up to D=20,000, and both
   entries (row and layout) at widths 1 to 20,000 with the live lengths of
   v's and u's rows at block and level edges and rand near 1, the layout
   entry also equal to the row entry on the unified rows;
   ``node2vec_walk`` on four random shapes, at widths 1 to 20,000 with
   live lengths at block and level edges, dead ends, rand at 0 and
   1 - 2^-24, W = 4k + 3, 37 steps and walkers from PAD_ID or with u0
   past n, and on the hub graph whose walkers draw PAD_ID and must stay
   there;
   1b. ``sgns_fused``'s row and table entries against their plain versions
   at nine shapes up to B=65,536, K=40 and D=1,024 (``atol=rtol=3e-4``,
   masked rows exactly 0, two launches on one input ``torch.equal``), the
   table entry ``torch.equal`` to the old composition (torch gathers, the
   row entry, torch divisions);
   1c. ``flash_attention`` against its plain version at the shapes of
   tests/test_flash_attention.py (GQA, MHA, MQA with window 64, ragged
   S=96, dh=128, bf16), S=1, a ragged dh=100, window 50 at dh=128 and
   S=130 at dh=256, causal and not (``atol=rtol=3e-3`` in float32, 3e-2
   in bf16; two launches on one input ``torch.equal``): both routes, the
   bf16 tensor-core kernel (bf16, dh a multiple of 16) and the float32
   SIMT kernel (float32, and bf16 at dh=100);
2. main path A — the per-step ``node2vec_step`` kernel on the FN-Cache
   layout: ``WalkEngine.build("wec:k=17,deg=100,seed=0", WalkPlan(
   backend="fused", cap=128, ...))``, two FN-Multi rounds in exact and in
   approx mode, every vertex a walker; walks must equal the reference
   backend's, the kernel (its layout entry) must launch once per
   superstep, and in exact mode no superstep may build full-width rows
   (``unified_row`` runs once a round, for step 0's first-order draw). At
   superstep 40 both entries and the row assembly the layout entry removes
   are timed;
   path C — streamed SGNS on path A's layout: ``StreamingSGNSTrainer(
   vocab=131_072, dim=128, window=10, negatives=5, batch_size=1024,
   sgns_backend="fused")`` ``.train()``s over 2 FN-Multi rounds of 1,024
   walkers (every 128th vertex) of fused-backend walks of length 80; the
   kernel must launch once per optimizer step, the loss must be finite and
   fall within each round (its last 5% window at most 0.9 of its first;
   it jumps where a round begins, in the JAX package as here at a cut
   vocabulary: tests/test_torch_train.py::
   test_loss_curve_at_path_c_widths_matches_jax), and a concat replay of
   round 0 into a fresh trainer must equal the streamed run's tables after
   round 0 exactly; then ~200 steps of a fresh trainer on the fused
   backend, on the old composition (patched into ``core.skipgram``: its
   tables must equal the fused trainer's) and on the autograd backend give
   their steps per second; the table entry is timed device-only (a CUDA
   graph of launches) and host-inclusive beside the old composition at
   B=1,024 and B=65,536;
3. main path B — the whole-walk ``node2vec_walk`` kernel on the FN-Base
   layout (``er:k=18,deg=100,seed=0``, ``pipeline=True``, one round); walks
   must equal the reference backend's, one launch; then the same on path
   A's graph through FN-Base (rows 913 wide, the kernel's draw for rows
   wider than 256), the kernel timed there too;
4. times each kernel and its plain version with CUDA events at the main
   path's inputs, beside the least time the card could take for them: the
   bytes the draws need (live lanes only, not the PAD lanes that pad each
   row to the widest) over 3.35 TB/s, or float32 operations over
   67 TFLOP/s, whichever is larger;
5. profiles one more round of each walk path and ~200 steps of path C
   with ``torch.profiler``: the window's wall seconds, the share of it the
   device was busy, and the kernels with the most device time;
6. path D — the entry point ``train_streamed`` end to end on the card and
   on the CPU (``sbm:n=400,c=4,pin=0.06,pout=0.004,seed=1`` with
   bench_accuracy's weights, fused walks and fused SGNS): the two
   micro-F1s must agree within 0.05;
7. path E — LM serving at yi-6b's full width (d_model 4,096, 32 heads on 4
   KV heads, head_dim 128, d_ff 11,008, vocab 64,000, bf16 compute, f32
   params) cut to 4 layers: ``init_params(cfg, PRNGKey(0))`` on the card,
   ``prefill`` of 4 prompts of 4,096 tokens packed from path A's round-0
   walks (``walks_to_lm_tokens(walks % vocab, 4096)``), then 32 greedy
   ``serve_step``s; ``flash_attention`` must launch once per layer at
   prefill, every launch on the tensor-core route, and never at decode,
   logits must be finite and tokens in range, and layer 0's kernel output
   within (atol 2e-3, rtol 1e-2) of the plain version's. The kernel, its
   plain version, the SIMT route on the same bf16 inputs and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick, never on the path) are
   timed at layer 0's inputs, and the kernel, the SIMT route and SDPA
   again at B=1, S=32,768 (checked, and the plain version timed, on two
   heads); beside them the kernel with P rounded to bf16 once (built from
   the same source without its lo product, never on the path: what the
   split costs, and how many outputs one rounding moves past the check).
   Last, the
   same params in float32 on the card and on the CPU (B=1, S=512, 8
   greedy tokens): the logits within ``atol=rtol=1e-3``, tokens equal;
8. path F — embedding serving with graph churn: ``EmbeddingService`` over
   path A's graph store and path C's trained serving table (131,072 x
   128) with ``WalkPlan(p=1, q=0.5, backend="fused", cap=128)`` and the
   JAX launcher's ``--full`` settings (cache 512, linger 0.2 ms, margin 1
   ms); every bucket (8, 32, 128) warmed for ``embed`` at window 10 and
   ``rank_neighbors`` at k=10; ``synthetic_trace(n, 20_000, alpha=1.2,
   rank_share=0.5, qps=20_000, deadline_s=0.05, seed=0)`` replayed against
   the real clock with window 10 and k 10, and between its halves
   ``zipf_churn(g, 4, 1024, seed=7)`` then one ``weight_churn`` batch of
   1,024 events through ``refresh``. ``node2vec_step`` must launch once
   per superstep of every walk window (9 a window), every request must be
   answered or expired, and served values finite; every served walk-window
   embedding (the warm-up's and the replay's cache misses) within 1e-6 of
   the reference backend's walks on the layout it was served from,
   averaged as the service does. Gates: (a) walkers of every bucket's
   width (8, 32, 128: the second half's embed nodes) and 4,096 more
   through the spliced layout, fused == reference backend; (b) on
   ``wec:k=13,deg=100,seed=0`` each refresh's layout == a fresh
   ``PaddedGraph.build`` field by field and walk-window embeddings == a
   freshly built service's; (c) there, on FN-Base with ``pipeline=True``
   after a weight-churn ``update``, ``node2vec_walk`` == its plain
   version == the engine's walks == the reference backend's.

It prints the card's name and power limit, the build seconds, the
registers and spills of the walk kernels and the tensor-core kernel,
walker-steps per second for each walk phase, prefill tokens/s and decode
ms/token, path F's latency quantiles, QPS, hit rate, occupancy, refresh
host ms and device-busy share, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.

    python3 chip_smoke.py --walks

runs phase 3 alone and prints its kernel times as one JSON line: copied
into a checkout of another commit, it times that commit's walk kernel on
the same inputs.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 dense tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/node2vec_step.cu"
SGNS_SOURCE = "src/repro_torch/kernels/csrc/sgns.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
FLASH_SIMT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
KERNEL_LIBS = ("node2vec_step", "sgns", "flash_attention",
               "flash_attention_sm90")
A_SPEC = "wec:k=17,deg=100,seed=0"
B_SPEC = "er:k=18,deg=100,seed=0"
WIDE = "B on A's graph"         # path B's kernel at rows 913 wide
LENGTH = 80
TOP = 8                         # kernels listed per profiled round
SGNS_TOL = 3e-4                 # the JAX package's kernel tolerance
SGNS_SHAPES = [(8, 1, 16), (64, 5, 32), (100, 8, 128), (512, 5, 200),
               (3, 12, 300), (256, 40, 64), (256, 5, 1024), (1024, 5, 128),
               (65536, 5, 128)]
STEP_EDGE_WIDTHS = (1, 16, 17, 147, 256, 257, 913, 4100, 20000)
# the walk kernel's widths: both draws (small rows up to 256, live-lane
# chunks past it) at their block and chunk edges, the hub graph's 914, and
# two widths whose prev rows do not fit the shared budget (u's row searched
# in place)
WALK_EDGE_WIDTHS = (1, 16, 17, 147, 256, 257, 300, 512, 513, 793, 914,
                    12000, 20000)
WALK_EDGE_STEPS = 37            # L - 1, not a multiple of 16 or 32
C_EVERY = 128                   # path C walks every 128th vertex
C_ROUNDS = 2
C_PROFILE_WALKERS = 137         # ~200 optimizer steps at length 80
C_FALL = 0.9                    # each round's loss ends at most 0.9 x start
D_SPEC = "sbm:n=400,c=4,pin=0.06,pout=0.004,seed=1"
D_F1_GAP = 0.05
FLASH_TOL = {"float32": 3e-3, "bfloat16": 3e-2}   # the JAX package's tests
# (atol, rtol) at path E's inputs, whose outputs are ~0.01-0.04 past the
# first rows. In bf16 the tensor-core kernel feeds the float32 weights P
# to the P.V product as bf16 hi and lo parts, within ~2^-16 of P (one bf16
# rounding of P, up to 2^-9 of the weighted sum of |v|, moves outputs past
# this check), and rounds o once (one ulp, at most 2^-7 of a value); the
# plain version keeps P in float32. In float32 (the SIMT kernel) the two
# differ by the order of the sums
E_FLASH_TOL = {"bfloat16": (2e-3, 1e-2), "float32": (1e-4, 1e-4)}
FLASH_SHAPES = [(2, 128, 4, 2, 32, 0), (1, 256, 2, 2, 64, 0),
                (2, 256, 4, 1, 32, 64), (1, 96, 3, 3, 16, 0),
                (1, 128, 2, 2, 128, 0), (1, 1, 4, 2, 128, 0),
                (2, 300, 8, 2, 100, 50), (2, 300, 8, 2, 128, 50),
                (1, 130, 2, 1, 256, 0)]
E_ARCH, E_LAYERS = "yi-6b", 4   # published widths, depth cut 32 -> 4
E_BATCH, E_SEQ, E_GEN = 4, 4096, 32
E_LONG = 32768                  # prefill_32k's length, a second reading
E_CPU_SEQ, E_CPU_GEN, E_CPU_TOL = 512, 8, 1e-3
F_REQUESTS = 20_000             # serve_graph --full replays 50,000
F_WINDOW, F_K = 10, 10
F_PROFILED = 2_000              # requests of path F traced for busy share
F_SAMPLE = 4_096                # gate (a)'s walkers beside the buckets
F_EMBED_TOL = 1e-6              # served embed vs plain: reductions only
F_SMALL_SPEC = "wec:k=13,deg=100,seed=0"


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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def profiled(torch, run, cpu: bool = True):
    """Run ``run`` once under ``torch.profiler``: returns (wall seconds on
    the host clock, ending in a synchronize; device-busy seconds, the summed
    time of the device's own events; those events by device time). With
    ``cpu=False`` only the device is traced, which costs the host less."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                    key=device_us, reverse=True)
    return wall, sum(map(device_us, events)) / 1e6, events


def log_profile(label: str, what: str, wall: float, busy: float,
                events) -> None:
    log(f"profile {label}: {what} {wall:.4f} s under the profiler, device "
        f"busy {busy:.4f} s = {busy / wall:.3f} of the window"
        + ("" if events else " (the trace holds no device time)"))
    for e in events[:TOP]:
        log(f"  {device_us(e) / 1e3:10.3f} ms {e.count:7d} calls "
            f"{device_us(e) / 1e6 / busy:6.3f}  {e.key[:80]}")


def profile_round(torch, run, label: str, what: str = "round") -> None:
    """Profile one warm call of ``run``: its wall seconds, the share of
    that window the device was busy, and the top kernels."""
    log_profile(label, what, *profiled(torch, run))


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


def edge_lives(d: int):
    """Live lengths at the block (16) and level (256, 4096) edges of d."""
    edges = {0, 1, 2, 15, 16, 17, 31, 32, 33, 255, 256, 257, 271, 272, 273,
             511, 512, 513, 4095, 4096, 4097, d // 2, d - 1, d}
    return sorted(x for x in edges if 0 <= x <= d)


def edge_rand(np, rng, w: int):
    """Uniforms with every third at 1 - 2^-24 and some at 0."""
    r = rng.random(w).astype(np.float32)
    r[::3] = np.float32(1 - 2.0 ** -24)
    r[1::7] = 0.0
    return r


def edge_rows(np, rng, w: int, d: int, pad: int):
    """[W, D] sorted rows whose live lengths cycle through the edges."""
    live = np.resize(edge_lives(d), w)
    rng.shuffle(live)
    lane = np.arange(d)[None, :]
    cand = np.sort(rng.integers(0, 1 << 20, (w, d)), axis=1) + np.arange(d)
    return np.where(lane < live[:, None], cand, pad).astype(np.int32), live


def edge_layout(np, torch, rng, d: int, cap: int, pad: int):
    """A layout on the card of padded width hot_cap = d whose rows' live
    lengths are the edges of d (each twice): cold up to cap, hot past it;
    alias fields zero (the step reads none). Returns (layout, rows)."""
    from repro_torch.core.graph import PaddedGraph
    lives = edge_lives(d) * 2
    n = max(2 * d + 2, 2 * len(lives))
    deg = np.zeros(n, np.int32)
    deg[:len(lives)] = lives
    rows = [np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
            for k in deg[:len(lives)]]
    adj = np.full((n, cap), pad, np.int32)
    wgt = np.zeros((n, cap), np.float32)
    hot = np.nonzero(deg > cap)[0]
    hot_adj = np.full((max(len(hot), 1), d), pad, np.int32)
    hot_wgt = np.zeros((max(len(hot), 1), d), np.float32)
    hot_pos = np.full(n, -1, np.int32)
    hot_pos[hot] = np.arange(len(hot))
    for v, ids in enumerate(rows):
        ws = (rng.random(len(ids)) + 0.1).astype(np.float32)
        adj[v, :min(len(ids), cap)] = ids[:cap]
        wgt[v, :min(len(ids), cap)] = ws[:cap]
        if hot_pos[v] >= 0:
            hot_adj[hot_pos[v], :len(ids)] = ids
            hot_wgt[hot_pos[v], :len(ids)] = ws
    hot_ids = hot.astype(np.int32) if len(hot) else np.full(1, pad, np.int32)
    fields = dict(adj=adj, wgt=wgt, deg=deg, alias_p=np.zeros_like(wgt),
                  alias_i=np.zeros_like(adj), w_min=np.ones(n, np.float32),
                  w_max=np.ones(n, np.float32), hot_pos=hot_pos,
                  hot_ids=hot_ids, hot_adj=hot_adj, hot_wgt=hot_wgt,
                  hot_alias_p=np.zeros_like(hot_wgt),
                  hot_alias_i=np.zeros_like(hot_adj))
    return PaddedGraph.from_numpy(fields, n, torch.device(DEV)), rows


def walk_edge_inputs(np, rng, d: int, pad: int):
    """A layout of row width d whose vertices' live lengths cycle through
    the edges of d (0: dead ends), on at most 2,048 vertices (a longer row
    draws its sorted ids with repeats), 4k + 3 walkers (not a multiple of a
    block's 4), one of them from PAD_ID and one with u0 past n, and
    uniforms with every eleventh at 1 - 2^-24 and some at 0; about 1% of
    the vertices are dead ends. Returns numpy (adj, wgt, deg, u0, v1, rand)."""
    lives = edge_lives(d)
    n = max(4 * len(lives), min(d + 1, 2048))
    deg = np.resize([k for k in lives if k], n).astype(np.int32)
    rng.shuffle(deg)
    deg[rng.random(n) < 0.01] = 0
    deg[rng.integers(0, n)] = 0
    adj = np.full((n, d), pad, np.int32)
    wgt = np.zeros((n, d), np.float32)
    for v, k in enumerate(deg):
        ids = rng.choice(n, k, replace=False) if k <= n else \
            rng.integers(0, n, k)
        adj[v, :k] = np.sort(ids)
        wgt[v, :k] = rng.random(k) + 0.1
    w = 4 * len(lives) + 3
    u0 = rng.integers(0, n, w).astype(np.int32)
    v1 = rng.integers(0, n, w).astype(np.int32)
    v1[0], u0[1] = pad, n + 5
    rand = rng.random((w, WALK_EDGE_STEPS)).astype(np.float32)
    rand.flat[::11] = np.float32(1 - 2.0 ** -24)
    rand.flat[5::13] = 0.0
    return adj, wgt, deg, u0, v1, rand


def pad_hub(np, torch):
    """The hub graph of tests/test_torch_sampler.py's PAD_ID tests: a hub of
    600 live lanes at width 914 whose padded total passes cum[L - 1], so
    rand = 1 - 2^-24 draws slot == L -> PAD_ID. Returns numpy (adj, wgt,
    deg, u0, v1, rand) of its FN-Base layout and 11 walkers, the first
    three stepping from the hub to PAD_ID."""
    from repro_torch.core.graph import CSRGraph, layout_arrays
    from repro_torch.engine.sampler import prefix_sum
    n, live = 1000, 600
    src = np.concatenate([np.zeros(live), np.ones(913)])
    dst = np.concatenate([np.arange(1, live + 1), np.arange(87, 1000)])
    r = np.float32(1 - 2.0 ** -24)
    for seed in range(400):
        g = CSRGraph.from_edges(n, src, dst, np.random.default_rng(
            seed).random(src.size).astype(np.float32) + np.float32(0.25))
        row = np.zeros((1, g.max_degree), np.float32)
        row[0, :live] = g.weights(0)
        cum = prefix_sum(torch.from_numpy(row))[0]
        if cum[-1] > cum[live - 1] and \
                int((cum[:live] <= r * cum[-1]).sum()) == live:
            break
    else:
        raise AssertionError("no hub row with total > cum[L - 1] found")
    f = layout_arrays(g)
    rng = np.random.default_rng(0)
    u0 = np.concatenate([[1, 5, 600], rng.integers(0, n, 8)])
    v1 = np.concatenate([[0, 0, 0], rng.integers(0, n, 8)])
    rand = rng.random((11, WALK_EDGE_STEPS)).astype(np.float32)
    rand[:3] = r
    return (f["adj"], f["wgt"], f["deg"], u0.astype(np.int32),
            v1.astype(np.int32), rand)


def check_walk(np, torch, K, arrays, p: float, q: float, label: str) -> int:
    """node2vec_walk on the card ``torch.equal`` to its plain version.
    Returns the largest |kernel - plain|."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
            for a in arrays]
    got = K.node2vec_walk(*args, p, q)
    want = K.node2vec_walk_plain(*args, p, q)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"node2vec_walk {label}: "
                             f"{int((got != want).sum())} differ")
    return int_err(got, want)


def check_step_edges(np, torch, K, rng, d: int, pad: int) -> int:
    """Both node2vec_step entries at width d, live lengths at block and
    level edges, rand near 1: each equals its plain version and the layout
    entry the row entry on the unified rows. Returns the largest |kernel -
    plain|."""
    from repro_torch.core.walk import unified_row
    dev = torch.device(DEV)
    w = 3 * len(edge_lives(d))
    cand, live = edge_rows(np, rng, w, d, pad)
    cw = np.where(cand != pad, rng.random((w, d)) + 0.1,
                  0.0).astype(np.float32)
    pick = cand[np.arange(w)[:, None],
                rng.integers(0, np.maximum(live, 1)[:, None], (w, d))]
    other, _ = edge_rows(np, rng, w, d, pad)
    prev = np.sort(np.where(rng.random((w, d)) < 0.5, pick, other),
                   axis=1).astype(np.int32)
    u = cand[np.arange(w), rng.integers(0, np.maximum(live, 1))]
    args = [torch.from_numpy(a).to(dev) for a in (
        cand, cw, u.astype(np.int32), prev, edge_rand(np, rng, w))]
    want = K.node2vec_step_plain(*args, 0.5, 2.0)
    got = K.node2vec_step(*args, 0.5, 2.0)
    err = int_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"node2vec_step at the edges of D={d}: "
                             f"{int((got != want).sum())} slots differ")
    pg, rows = edge_layout(np, torch, rng, d, min(d, 40), pad)
    wk = 3 * len(rows)
    v = np.resize(np.arange(len(rows)), wk)
    u = rng.integers(0, len(rows), wk)
    for i in range(0, wk, 3):                    # u in N(v): alpha = 1/p
        if len(rows[v[i]]):
            u[i] = rng.choice(rows[v[i]])
    u, v, r = (torch.from_numpy(a).to(dev) for a in (
        u.astype(np.int32), v.astype(np.int32), edge_rand(np, rng, wk)))
    want = K.node2vec_step_layout_plain(pg, u, v, r, 0.5, 2.0)
    cand, cw, _ = unified_row(pg, v, ("adj", "wgt"))
    prev, _ = unified_row(pg, u, ("adj",))
    rows_slot = K.node2vec_step(cand, cw, u, prev, r, 0.5, 2.0)
    slot, nxt = K.node2vec_step_layout(pg, u, v, r, 0.5, 2.0)
    err = max(err, int_err(slot, want[0]), int_err(nxt, want[1]),
              int_err(rows_slot, slot))
    if not (torch.equal(slot, want[0]) and torch.equal(nxt, want[1])
            and torch.equal(rows_slot, slot)):
        raise AssertionError(f"node2vec_step_layout at the edges of D={d} "
                             f"differs from its plain version or the row "
                             f"entry")
    return err


# --------------------------------------------------------------- phases --

def check_kernels(np, torch, K, pad):
    """Phase 1: each kernel equals its plain version on the card. Returns
    the largest |kernel - plain| of each kernel (slots, vertex ids)."""
    dev = torch.device(DEV)
    step_err = walk_err = 0
    rng = np.random.default_rng(0)
    cases = [(7, 1, 1), (7, 130, 300), (7, 793, 130), (4096, 1, 793),
             (4096, 300, 300), (4096, 793, 793), (65536, 130, 130),
             (65536, 793, 793), (64, 20000, 20000)]   # the last: scratch path
    for w, d, dp in cases:
        args = [torch.from_numpy(a).to(dev)
                for a in step_inputs(np, rng, w, d, dp, pad)]
        for p, q in ((0.5, 2.0), (2.0, 0.5), (1.0, 1.0)):
            want = K.node2vec_step_plain(*args, p, q)
            got = K.node2vec_step(*args, p, q)
            torch.cuda.synchronize()
            step_err = max(step_err, int_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"node2vec_step W={w} D={d} DP={dp} "
                                     f"p={p} q={q}: "
                                     f"{int((got != want).sum())} slots "
                                     f"differ")
    for d in STEP_EDGE_WIDTHS:
        step_err = max(step_err, check_step_edges(np, torch, K, rng, d, pad))
    log(f"node2vec_step == plain on {len(cases)} shapes x 3 (p, q); both "
        f"entries at widths {STEP_EDGE_WIDTHS} with live lengths at block "
        f"and level edges and rand near 1: row entry and layout entry == "
        f"plain, layout entry == row entry on the unified rows")
    shapes = [(64, 1, 7, 5), (4096, 130, 4096, 12), (8192, 300, 65536, 6),
              (2048, 793, 7, 9)]
    for n, d, w, steps in shapes:
        walk_err = max(walk_err, check_walk(
            np, torch, K, walk_inputs(np, rng, n, d, w, steps, pad), 0.5,
            2.0, f"n={n} D={d} W={w}"))
    for d in WALK_EDGE_WIDTHS:
        walk_err = max(walk_err, check_walk(
            np, torch, K, walk_edge_inputs(np, rng, d, pad), 0.5, 2.0,
            f"at the edges of D={d}"))
    hub = pad_hub(np, torch)
    for p, q in ((1.0, 1.0), (0.5, 2.0)):
        walk_err = max(walk_err, check_walk(np, torch, K, hub, p, q,
                                            f"hub p={p} q={q}"))
    got = K.node2vec_walk(*[torch.from_numpy(a).to(DEV) for a in hub], 1.0,
                          1.0)
    if not bool((got[:3] == pad).all()):
        raise AssertionError("node2vec_walk: the hub's walkers left PAD_ID")
    log(f"node2vec_walk == plain "
        f"on {len(shapes)} random shapes, at widths {WALK_EDGE_WIDTHS} with "
        f"live lengths at block and level edges, dead ends, rand at 0 and "
        f"1 - 2^-24, W = 4k + 3, {WALK_EDGE_STEPS} steps, v1 = PAD_ID and "
        f"u0 = n + 5, and on the hub graph whose walkers reach PAD_ID and "
        f"stay there")
    return step_err, walk_err


def sgns_rows(np, rng, b: int, k: int, d: int):
    """Gathered SGNS rows and a row mask (~80% live)."""
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, k, d)).astype(np.float32),
            (rng.random(b) > 0.2).astype(np.float32))


def sgns_compare(torch, S, args, label: str) -> float:
    """One input through the kernel twice and the plain version once:
    the two launches must be ``torch.equal``, the kernel within SGNS_TOL
    of the plain version, masked rows' grads exactly 0. Returns the
    largest |kernel - plain|."""
    got = S.sgns_fused(*args)
    again = S.sgns_fused(*args)
    want = S.sgns_fused_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    masked = args[3] == 0
    for name, g, a, w in zip(("loss", "g_ci", "g_po", "g_no"), got, again,
                             want):
        if not torch.equal(g, a):
            raise AssertionError(f"sgns_fused {label}: {name} differs "
                                 f"between two launches")
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        if not torch.allclose(g, w, atol=SGNS_TOL, rtol=SGNS_TOL):
            raise AssertionError(f"sgns_fused {label}: {name} differs from "
                                 f"the plain version by "
                                 f"{float((g - w).abs().max())}")
        if name != "loss" and not bool((g[masked] == 0).all()):
            raise AssertionError(f"sgns_fused {label}: {name} is not 0 on "
                                 f"masked rows")
    return err


def old_composition(torch, S):
    """The fused backend's SGNS step before the table entry: the rows
    gathered by torch, the row entry, every output divided by torch (the
    yardstick of the table entry, which must give the same bits)."""
    def run(emb_in, emb_out, center, pos, negs, valid, denom):
        out = S.sgns_fused(emb_in[center.long()], emb_out[pos.long()],
                           emb_out[negs.long()], valid)
        return tuple(t / denom for t in out)
    return run


def sgns_tables_args(np, torch, rng, v: int, b: int, k: int, d: int):
    """Random tables and a batch of int32 indices and a row mask on the
    card, with the divisor as the trainer forms it."""
    dev = torch.device(DEV)
    emb_in, emb_out = (torch.from_numpy(rng.normal(size=(v, d)).astype(
        np.float32)).to(dev) for _ in range(2))
    center, pos = (torch.from_numpy(rng.integers(0, v, b).astype(
        np.int32)).to(dev) for _ in range(2))
    negs = torch.from_numpy(rng.integers(0, v, (b, k)).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy((rng.random(b) > 0.2).astype(np.float32)).to(dev)
    return (emb_in, emb_out, center, pos, negs, valid,
            torch.clamp(valid.sum(), min=1.0))


def sgns_tables_compare(torch, S, args, label: str) -> float:
    """The table entry twice, the old composition and the plain version
    once: the launches ``torch.equal`` each other and the old composition,
    within SGNS_TOL of the plain version, masked rows 0. Returns the
    largest |kernel - plain|."""
    got = S.sgns_fused_tables(*args)
    again = S.sgns_fused_tables(*args)
    old = old_composition(torch, S)(*args)
    want = S.sgns_fused_tables_plain(*args)
    torch.cuda.synchronize()
    masked = args[5] == 0
    err = 0.0
    for name, g, a, o, w in zip(("loss", "g_ci", "g_po", "g_no"), got,
                                again, old, want):
        if not (torch.equal(g, a) and torch.equal(g, o)):
            raise AssertionError(f"sgns_fused_tables {label}: {name} differs "
                                 f"between launches or from the old "
                                 f"composition")
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        if not torch.allclose(g, w, atol=SGNS_TOL, rtol=SGNS_TOL):
            raise AssertionError(f"sgns_fused_tables {label}: {name} differs "
                                 f"from the plain version by "
                                 f"{float((g - w).abs().max())}")
        if name != "loss" and not bool((g[masked] == 0).all()):
            raise AssertionError(f"sgns_fused_tables {label}: {name} is not "
                                 f"0 on masked rows")
    return err


def check_sgns(np, torch, S) -> float:
    """Phase 1b: both ``sgns_fused`` entries against their plain versions
    on the card, the table entry also against the old composition."""
    rng = np.random.default_rng(1)
    err = 0.0
    for b, k, d in SGNS_SHAPES:
        args = [torch.from_numpy(a).to(DEV) for a in sgns_rows(np, rng, b, k,
                                                              d)]
        err = max(err, sgns_compare(torch, S, args, f"B={b} K={k} D={d}"))
        targs = sgns_tables_args(np, torch, rng, max(2 * b, 64), b, k, d)
        err = max(err, sgns_tables_compare(torch, S, targs,
                                           f"B={b} K={k} D={d}"))
    log(f"sgns_fused row and table entries == plain (atol=rtol={SGNS_TOL}, "
        f"max |err| {err:.3g}), deterministic, masked rows 0, the table "
        f"entry torch.equal to the old composition, on {len(SGNS_SHAPES)} "
        f"shapes")
    return err


def sgns_bound(b: int, k: int, d: int):
    """Least time for the table entry's work: the rows of ci, po and no and
    their (2 + K) int32 indices, valid and denom read once, the three grads
    and the loss written once; ~5KD + 4D float32 operations a row (dots,
    scales and the g_ci sum)."""
    nbytes = 8 * b * d * (2 + k) + 4 * b * (3 + k) + 8
    return bound_ms(nbytes, b * (5 * k * d + 4 * d))


def f1_scores(np, emb, labels, seed=0):
    """Micro/macro-F1 of a least-squares probe on a 50% split: a copy of
    benchmarks/bench_accuracy.py's ``_f1``."""
    rng = np.random.default_rng(seed)
    n = emb.shape[0]
    k = labels.max() + 1
    idx = rng.permutation(n)
    tr, te = idx[:n // 2], idx[n // 2:]
    y = np.eye(k)[labels]
    w, *_ = np.linalg.lstsq(emb[tr], y[tr], rcond=None)
    pred = (emb[te] @ w).argmax(1)
    gold = labels[te]
    micro = (pred == gold).mean()
    f1s = []
    for c in range(k):
        tp = ((pred == c) & (gold == c)).sum()
        fp = ((pred == c) & (gold != c)).sum()
        fn = ((pred != c) & (gold == c)).sum()
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        f1s.append(2 * p * r / max(p + r, 1e-9))
    return float(micro), float(np.mean(f1s))


def path_c(np, torch, pg, walkers_every: int = C_EVERY,
           rounds: int = C_ROUNDS, length: int = LENGTH):
    """Main path C: the streamed trainer with the fused SGNS kernel over
    ``rounds`` FN-Multi rounds of fused walks on ``pg``. Returns (trainer,
    the rounds' walks, sgns_fused launches of the run)."""
    from repro_torch.core.skipgram import normalize_embeddings
    from repro_torch.engine import WalkEngine, WalkPlan, round_seed
    from repro_torch.kernels import node2vec_step as K
    from repro_torch.kernels import sgns as S
    from repro_torch.train.pairs import num_pairs
    from repro_torch.train.stream import StreamingSGNSTrainer

    kw = dict(vocab=pg.n, dim=128, window=10, negatives=5, batch_size=1024,
              lr=0.025, epochs=1, sgns_backend="fused", device=pg.device)
    engine = WalkEngine.build(pg, WalkPlan(p=1.0, q=0.5, length=length,
                                           cap=128, backend="fused"))
    starts = np.arange(0, pg.n, walkers_every, dtype=np.int32)
    trainer = StreamingSGNSTrainer(**kw)
    kept, snap = [], {}

    def source():
        for r in range(rounds):
            if r == 1:   # round 0 has been trained: keep its tables
                snap["emb"] = normalize_embeddings(trainer.params).cpu()
            walks = engine.run(starts=starts, seed=round_seed(0, r)).walks
            kept.append(walks)
            yield walks

    S.sgns_fused.launches = 0
    K.node2vec_step.launches = 0
    K.node2vec_walk.launches = 0
    _, st = trainer.train(source())
    launches = S.sgns_fused.launches
    if launches != st.steps or st.steps == 0:
        raise AssertionError(f"C: sgns_fused launched {launches} times for "
                             f"{st.steps} optimizer steps")
    if K.node2vec_step.launches != rounds * (length - 1):
        raise AssertionError(f"C: node2vec_step launched "
                             f"{K.node2vec_step.launches} times")
    losses = trainer.loss_history()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("C: the loss is not finite")
    # every round has the same shape, so the same number of steps
    per_round = -(-num_pairs(len(starts), length, 10) // 1024)
    if len(losses) != rounds * per_round:
        raise AssertionError(f"C: {len(losses)} losses for {rounds} rounds "
                             f"of {per_round} steps")
    log(f"C: {len(starts)} walkers x {length} x {rounds} rounds, V={pg.n} "
        f"D=128 K=5 B=1024: {st.steps} steps in {st.wall_seconds:.3f} s = "
        f"{st.steps / st.wall_seconds:.4g} steps/s, "
        f"{st.pairs_per_sec:.4g} pairs/s; sgns_fused launches {launches} "
        f"== steps")
    for r, part in enumerate(losses.reshape(rounds, per_round)):
        win = max(1, per_round // 20)
        curve = [float(part[i:i + win].mean())
                 for i in range(0, per_round - win + 1, win)]
        log(f"C: round {r} loss over 5% windows: "
            f"{' '.join(f'{x:.4f}' for x in curve)}")
        if not curve[-1] <= C_FALL * curve[0]:
            raise AssertionError(f"C: round {r}'s loss ends at {curve[-1]}, "
                                 f"above {C_FALL} x its start {curve[0]}")
    log(f"C: {st}")
    t0 = time.perf_counter()
    replay = StreamingSGNSTrainer(**kw)
    replay.consume(kept[0])
    emb0 = normalize_embeddings(replay.params).cpu()
    if rounds > 1:
        if not torch.equal(emb0, snap["emb"]):
            raise AssertionError("C: concat replay of round 0 differs from "
                                 "the streamed run")
        log(f"C: concat replay of round 0 == streamed tables after round 0 "
            f"({time.perf_counter() - t0:.2f} s)")
    del replay
    from repro_torch.core import skipgram as SG
    table_entry = SG.sgns_fused_tables
    rates, tables = {}, {}
    # the table entry and the old composition in turns (host speed drifts
    # within a run), then autograd; each a fresh trainer on the same walkers
    for name in ("fused", "old composition", "old composition", "fused",
                 "jnp"):
        tr = StreamingSGNSTrainer(**{**kw, "sgns_backend": (
            "jnp" if name == "jnp" else "fused")})
        if name == "old composition":
            SG.sgns_fused_tables = old_composition(torch, S)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.consume(kept[0][:C_PROFILE_WALKERS])
            tr.loss_history()                   # waits for the last step
            rates.setdefault(name, []).append(
                tr.recorder.steps / (time.perf_counter() - t0))
        finally:
            SG.sgns_fused_tables = table_entry
        tables.setdefault(name, tr.params)
        if not all(torch.equal(tables[name][k], tr.params[k])
                   for k in ("emb_in", "emb_out")):
            raise AssertionError(f"C: two fresh {name} trainers differ")
        del tr
    same = all(torch.equal(tables["fused"][k], tables["old composition"][k])
               for k in ("emb_in", "emb_out"))
    if not same:
        raise AssertionError("C: the table entry's trainer differs from the "
                             "old composition's")
    each = {k: " / ".join(f"{x:.4g}" for x in v) for k, v in rates.items()}
    rates = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"C: the same {C_PROFILE_WALKERS} walkers of round 0 on fresh "
        f"trainers, in the order fused, old, old, fused, jnp: fused "
        f"{rates['fused']:.4g} steps/s ({each['fused']}), the old "
        f"composition (gathers, row entry, divisions) "
        f"{rates['old composition']:.4g} steps/s "
        f"({each['old composition']}), its tables torch.equal the table "
        f"entry's; jnp {rates['jnp']:.4g} steps/s")
    del tables
    return trainer, kept, launches


def graph_ms(torch, fn, reps: int) -> float:
    """Device-only milliseconds of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed and timed with CUDA events, so no host time
    between the launches counts."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    ms = cuda_ms(torch, graph.replay, 3) / reps
    del graph
    torch.cuda.synchronize()
    return ms


def time_sgns(np, torch, S, trainer, walks, b: int, label: str) -> dict:
    """The table entry at batch ``b`` on the trained tables, with pairs of
    ``walks``: host-inclusive (back-to-back wrapper calls) and device-only
    times, the old composition's (gathers, row entry, divisions) in turns
    with it, the row entry alone on gathered rows, the plain version, the
    bound and the largest |kernel - plain|."""
    from repro_torch.train.pairs import device_pairs
    w = torch.from_numpy(walks).to(DEV)
    c, x, valid = device_pairs(w, 10)
    pick = torch.from_numpy(np.random.default_rng(b).choice(
        c.numel(), b, replace=b > c.numel())).to(DEV)
    negs = torch.from_numpy(np.random.default_rng(b + 1).integers(
        0, trainer.vocab, (b, 5)).astype(np.int32)).to(DEV)
    p = trainer.params
    v = valid[pick].float()
    args = (p["emb_in"], p["emb_out"], c[pick], x[pick], negs, v,
            torch.clamp(v.sum(), min=1.0))
    r = {"err": sgns_tables_compare(torch, S, args, label)}
    old = old_composition(torch, S)
    reps = 200 if b <= 4096 else 50
    new_fn = lambda: S.sgns_fused_tables(*args)          # noqa: E731
    old_fn = lambda: old(*args)                          # noqa: E731
    t = [cuda_ms(torch, fn, reps, warmup=5)
         for fn in (new_fn, old_fn, old_fn, new_fn)]
    r["ms_host"], r["ms_old"] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    greps = 100 if b <= 4096 else 10
    t = [graph_ms(torch, fn, greps) for fn in (new_fn, old_fn, old_fn,
                                                 new_fn)]
    r["ms_device"], r["ms_old_device"] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    rows = (p["emb_in"][c[pick].long()], p["emb_out"][x[pick].long()],
            p["emb_out"][negs.long()], v)
    r["ms_rows_entry"] = cuda_ms(torch, lambda: S.sgns_fused(*rows), reps,
                                 warmup=5)
    r["ms_rows_entry_device"] = graph_ms(torch, lambda: S.sgns_fused(*rows),
                                         greps)
    r["plain_ms"] = cuda_ms(torch, lambda: S.sgns_fused_tables_plain(*args),
                            reps // 4, warmup=2)
    r["bound"] = sgns_bound(b, 5, 128)
    log(f"sgns_fused_tables {label} (B={b} K=5 D=128): device-only "
        f"{r['ms_device']:.4f} ms (a CUDA graph of {greps}), host-inclusive "
        f"{r['ms_host']:.4f} ms; the old composition (gathers, row entry, "
        f"divisions) {r['ms_old_device']:.4f} ms device-only, "
        f"{r['ms_old']:.4f} ms host-inclusive; the row entry alone on "
        f"gathered rows {r['ms_rows_entry_device']:.4f} ms device-only, "
        f"{r['ms_rows_entry']:.4f} ms host-inclusive; plain "
        f"{r['plain_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}); max |kernel - plain| {r['err']:.3g}, == old "
        f"composition")
    return r


def walk_phase(np, torch, K, spec: str, label: str,
               profile: bool = False) -> dict:
    """The whole-walk ``node2vec_walk`` kernel through the engine on the
    FN-Base layout of ``spec`` (``pipeline=True``, one round): the walks
    must equal the reference backend's, one launch. Then the kernel and
    its plain version are timed on that round's inputs (the kernel's
    output equal to the plain version's and to the round's walks), beside
    the bound of the bytes the draws need."""
    from repro_torch import random as jr
    from repro_torch.core.walk import step_uniforms
    from repro_torch.engine import WalkEngine, WalkPlan
    kw = dict(p=1.0, q=0.5, length=LENGTH, pipeline=True)
    t0 = time.perf_counter()
    fused = WalkEngine.build(spec, WalkPlan(backend="fused", **kw),
                             device=DEV)
    pg = fused.pg
    mbytes = sum(getattr(pg, f).numel() * getattr(pg, f).element_size()
                 for f in ("adj", "wgt", "deg", "alias_p", "alias_i"))
    log(f"{label}: {spec}: n={pg.n} m={fused.store.graph.m} "
        f"max_deg={pg.cap} layout {mbytes / 1e6:.1f} MB, built in "
        f"{time.perf_counter() - t0:.2f} s host")
    if not fused._fused_persistent():
        raise AssertionError(f"{label}: the whole-walk kernel path is not "
                             f"live")
    ref = WalkEngine.build(pg, WalkPlan(backend="reference", **kw))
    K.node2vec_step.launches = 0
    K.node2vec_walk.launches = 0
    walks, secs = drive(torch, fused, 1)
    launches = K.node2vec_walk.launches
    if (K.node2vec_walk.launches, K.node2vec_step.launches) != (1, 0):
        raise AssertionError(
            f"{label}: launches walk={K.node2vec_walk.launches} "
            f"step={K.node2vec_step.launches}, want 1 and 0")
    ref_walks, ref_secs = drive(torch, ref, 1)
    err = walks_err(np, walks, ref_walks)
    if err:
        raise AssertionError(f"{label}: fused walks differ from the "
                             f"reference")
    steps = pg.n * LENGTH
    log(f"{label}: fused {steps / secs:.4g} walker-steps/s ({secs:.3f} s), "
        f"reference {steps / ref_secs:.4g} walker-steps/s; == reference; "
        f"node2vec_walk launches {launches}")
    if profile:
        profile_round(torch, lambda: fused.run(seed=1), f"{label} "
                      f"fused+pipeline")

    starts = torch.arange(pg.n, dtype=torch.int32, device=DEV)
    v1 = torch.from_numpy(walks[0][:, 0].copy()).to(DEV)
    rand = step_uniforms(jr.PRNGKey(0, device=DEV), starts.long(), LENGTH)
    args = (pg.adj, pg.wgt, pg.deg, starts, v1, rand, 1.0, 0.5)
    d = pg.adj.shape[1]
    got = K.node2vec_walk(*args)
    want = K.node2vec_walk_plain(*args)
    err = max(int_err(got, want),
              walks_err(np, [got.cpu().numpy()], [walks[0][:, 1:]]))
    if not torch.equal(got, want) or \
            not np.array_equal(got.cpu().numpy(), walks[0][:, 1:]):
        raise AssertionError(f"node2vec_walk differs on {label}'s inputs")
    ms = cuda_ms(torch, lambda: K.node2vec_walk(*args), 3)
    plain_ms = cuda_ms(torch, lambda: K.node2vec_walk_plain(*args), 1)
    wk, st = rand.shape
    # what the walk needs: u0's live row once, then per step v's live ids
    # and weights and deg[v] (v = walks[:, s]), one uniform in and one
    # vertex out; u0 and v1 in per walker
    deg_v = pg.deg[torch.from_numpy(
        np.ascontiguousarray(walks[0][:, :st])).to(DEV).long()].long()
    bound = bound_ms(
        int((4 * deg_v.add(1).clamp(max=d) + 4 * deg_v).sum())
        + 8 * deg_v.numel() + 4 * int(pg.deg[starts.long()].long().sum())
        + 8 * wk, 3 * int(deg_v.sum()))
    log(f"{label}: node2vec_walk W={wk} steps={st} D={d} (mean live lanes "
        f"{float(deg_v.double().mean()):.2f} of v): {ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    del fused, ref, pg, args, rand, got, want
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound": bound, "d": d}


def path_d(np, torch, device=None):
    """Path D: ``train_streamed`` end to end; returns (micro, macro, stats,
    sgns_fused launches)."""
    from repro_torch.core.node2vec import Node2VecConfig
    from repro_torch.data.store import open_graph
    from repro_torch.kernels import sgns as S
    from repro_torch.train.stream import train_streamed
    ds = open_graph(D_SPEC)
    g = ds.graph
    g.wgt = (np.random.default_rng(0).random(g.m) * 4 + 0.5).astype(
        np.float32)
    cfg = Node2VecConfig(p=1.0, q=0.5, walk_length=20, num_walks=4, window=5,
                         dim=32, epochs=2, batch_size=4096, seed=0,
                         backend="fused", sgns_backend="fused")
    before = S.sgns_fused.launches
    emb, st = train_streamed(g, cfg, device=device)
    if emb.shape != (g.n, 32) or not np.all(np.isfinite(emb)):
        raise AssertionError(f"D: bad embeddings {emb.shape}")
    micro, macro = f1_scores(np, emb, ds.labels)
    return micro, macro, st, S.sgns_fused.launches - before


def flash_close(torch, got, want, tol, label: str) -> float:
    """Elementwise ``allclose`` of the kernel's output to the plain
    version's with ``tol`` = (atol, rtol); returns the largest |diff|."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, atol=tol[0], rtol=tol[1]):
        raise AssertionError(f"flash_attention {label}: differs from the "
                             f"plain version by {err} (atol, rtol {tol})")
    return err


def flash_compare(torch, FA, q, k, v, window: int, causal: bool,
                  label: str, tol=None) -> float:
    """One input through the kernel twice and the plain version once: the
    launches must be ``torch.equal``, the kernel within ``tol`` (atol,
    rtol; by default FLASH_TOL for both) of the plain version. Returns the
    largest |kernel - plain|."""
    got = FA.flash_attention(q, k, v, window, causal)
    again = FA.flash_attention(q, k, v, window, causal)
    want = FA.flash_attention_plain(q, k, v, window, causal)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention {label}: two launches differ")
    if tol is None:
        tol = (FLASH_TOL[str(q.dtype).split(".")[-1]],) * 2
    return flash_close(torch, got, want, tol, label)


def flash_counts(FA):
    """(total, tensor-core, SIMT) launches of ``flash_attention``."""
    f = FA.flash_attention
    return f.launches, f.launches_tc, f.launches_simt


def check_flash(np, torch, FA) -> float:
    """Phase 1c: ``flash_attention`` against its plain version on the card,
    on inputs from a numpy seed, in float32 and bf16, causal and not; both
    routes must run."""
    rng = np.random.default_rng(2)
    err, n = 0.0, 0
    before = flash_counts(FA)
    for b, s, h, kv, dh, window in FLASH_SHAPES:
        arrays = [rng.normal(size=(b, s, heads, dh)).astype(np.float32)
                  for heads in (h, kv, kv)]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = [torch.from_numpy(a).cuda().to(dt) for a in arrays]
            for causal in (True, False):
                err = max(err, flash_compare(
                    torch, FA, q, k, v, window, causal,
                    f"B={b} S={s} H={h} KV={kv} dh={dh} window={window} "
                    f"{dt} causal={causal}"))
                n += 1
    total, tc, simt = (a - b for a, b in zip(flash_counts(FA), before))
    if not (tc and simt and total == tc + simt == 2 * n):
        raise AssertionError(f"1c: launches {total} (tensor-core {tc}, SIMT "
                             f"{simt}) for {n} cases")
    log(f"flash_attention == plain (atol=rtol 3e-3 f32, 3e-2 bf16; max "
        f"|err| {err:.3g}), deterministic, on {n} cases; launches "
        f"tensor-core {tc}, SIMT {simt}")
    return err


def flash_flops(b: int, s: int, h: int, dh: int) -> int:
    """4 * dh flops for each of the s (s + 1) / 2 unmasked (query, key)
    pairs of a causal head."""
    return 4 * b * h * dh * (s * (s + 1) // 2)


def flash_bound(b: int, s: int, h: int, kv: int, dh: int):
    """Least time for causal bf16 attention: q, k, v read once and o
    written once, against :func:`flash_flops` at the bf16 tensor-core
    rate."""
    nbytes = 2 * b * s * dh * (2 * h + 2 * kv)
    return bound_ms(nbytes, flash_flops(b, s, h, dh), BF16_OPS_PER_S)


def load_one_rounding(build):
    """The tensor-core kernel with its lo product dropped, so that P is
    rounded to bf16 once: built from the committed source into
    build/variants/ to time what the hi/lo split costs and to count the
    outputs one rounding moves past path E's check. Never on the path."""
    text = (build.CSRC / "flash_attention_sm90.cu").read_text()
    one = text.replace("part < 2; ++part", "part < 1; ++part").replace(
        "flash_attention_sm90_launch(", "flash_attention_sm90_one_launch(")
    if one.count("part < 1; ++part") != 1 or "_one_launch(" not in one:
        raise AssertionError("the split's product loop or entry point moved")
    var = ROOT / "build" / "variants"
    var.mkdir(parents=True, exist_ok=True)
    (var / "flash_attention_sm90_one.cu").write_text(one)
    shutil.copy(build.CSRC / "hopper.cuh", var / "hopper.cuh")
    csrc, build.CSRC = build.CSRC, var
    try:
        lib = build.load("flash_attention_sm90_one")
    finally:
        build.CSRC = csrc
    fn = lib.flash_attention_sm90_one_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(torch, q, k, v):
        b, s, h, dh = q.shape
        o = torch.empty_like(q)
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), b, s, h, k.shape[2], dh,
                       dh ** -0.5 * math.log2(math.e), 1, 0,
                       torch.cuda.current_stream().cuda_stream),
                    "flash_attention one rounding")
        return o
    return run


def sdpa_ms(torch, q, k, v, reps: int) -> float:
    """PyTorch's fused attention on the same inputs (the yardstick): GQA in
    place, causal, on a fused backend only (the math backend would
    materialize the scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True), reps)


def serve(torch, M, cfg, params, tokens, gen: int):
    """``prefill`` then ``gen - 1`` greedy ``serve_step``s; returns (the
    logits of every step [gen, B, V], the tokens [B, gen], prefill seconds,
    decode seconds, kernel launches at prefill and at decode, each as
    (total, tensor-core, SIMT))."""
    from repro_torch.kernels import flash_attention as FA
    dev = params["embed"]["tok"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    b, s = tokens.shape
    sync()
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_tc = 0
    FA.flash_attention.launches_simt = 0
    t0 = time.perf_counter()
    logits, caches = M.prefill(cfg, params, {"tokens": tokens},
                               max_len=s + gen)
    sync()
    t_prefill = time.perf_counter() - t0
    at_prefill = flash_counts(FA)
    outs, toks = [logits], [torch.argmax(logits, -1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = M.serve_step(cfg, params, toks[-1], s + i, caches)
        outs.append(logits)
        toks.append(torch.argmax(logits, -1))
    sync()
    return (torch.stack(outs), torch.stack(toks, 1), t_prefill,
            time.perf_counter() - t0, at_prefill,
            tuple(a - b for a, b in zip(flash_counts(FA), at_prefill)))


def path_e(np, torch, walks, one, dev="cuda"):
    """Path E: LM serving at yi-6b's full width, 4 layers, with the kernel
    at every prefill layer; then the kernel's readings at layer 0's inputs
    and at S=32,768 (beside them ``one``, the kernel with P rounded to bf16
    once), and the same params in float32 on card and CPU. Returns
    (launches, max |err|, readings)."""
    import dataclasses
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.models.attention import prefill_qkv
    from repro_torch.models.layers import embed_tokens, rms_norm
    cfg = dataclasses.replace(get_config(E_ARCH), num_layers=E_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(cfg, jr.PRNGKey(0), dev)
    torch.cuda.synchronize()
    log(f"E: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} layers={cfg.num_layers} ({cfg.param_count():,} "
        f"params) initialised on the card in {time.perf_counter() - t0:.2f} "
        f"s host")
    tokens = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, E_SEQ)[:E_BATCH]).to(dev)
    logits, toks, t_pre, t_dec, launches, dec_launches = serve(
        torch, M, cfg, params, tokens, E_GEN + 1)
    n = cfg.num_layers
    if (launches, dec_launches) != ((n, n, 0), (0, 0, 0)):
        raise AssertionError(f"E: flash_attention launched (total, "
                             f"tensor-core, SIMT) {launches} at prefill and "
                             f"{dec_launches} at decode, want {(n, n, 0)} "
                             f"and (0, 0, 0)")
    launches, by_route = launches[0], launches[1:]
    if not bool(torch.isfinite(logits).all()) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        raise AssertionError("E: non-finite logits or tokens out of range")
    log(f"E: prefill B={E_BATCH} S={E_SEQ}: {t_pre:.4f} s = "
        f"{E_BATCH * E_SEQ / t_pre:.6g} tokens/s; decode {E_GEN} steps: "
        f"{t_dec / E_GEN * 1e3:.4f} ms/token; flash_attention launches "
        f"{launches} at prefill (== layers, all tensor-core), "
        f"{dec_launches[0]} at decode; tokens {toks[0, :8].tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = M.prefill(cfg, params, {"tokens": tokens},
                          max_len=E_SEQ + E_GEN + 1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"E: a second (warm) prefill {warm:.4f} s = "
        f"{E_BATCH * E_SEQ / warm:.6g} tokens/s")
    profile_round(torch, lambda: M.prefill(cfg, params, {"tokens": tokens},
                                           max_len=E_SEQ + E_GEN + 1),
                  "E prefill", "prefill")

    steps = min(8, E_GEN)

    def decode():
        tok = toks[:, 0]
        for i in range(steps):
            tok = torch.argmax(M.serve_step(cfg, params, tok, E_SEQ + i,
                                            caches)[0], -1)
    profile_round(torch, decode, "E decode", f"{steps} steps")
    del caches

    # the kernel at layer 0's inputs
    blk = {k: v[0] for k, v in params["blocks"]["l0"]["attn"].items()}
    h = rms_norm(embed_tokens(cfg, params["embed"], tokens),
                 params["blocks"]["l0"]["pre_norm"][0])
    q, k, v = prefill_qkv(cfg, blk, h, torch.arange(E_SEQ, device=dev))
    del h
    err = flash_compare(torch, FA, q, k, v, 0, True, "path E layer 0",
                        E_FLASH_TOL["bfloat16"])
    err32 = flash_compare(torch, FA, q.float(), k.float(), v.float(), 0,
                          True, "path E layer 0 in float32",
                          E_FLASH_TOL["float32"])
    r = {"ms": cuda_ms(torch, lambda: FA.flash_attention(q, k, v), 20),
         "plain_ms": cuda_ms(torch, lambda: FA.flash_attention_plain(
             q, k, v), 2),
         "simt_ms": cuda_ms(torch, lambda: FA.launch("simt", q, k, v), 3),
         "library_ms": sdpa_ms(torch, q, k, v, 20),
         "bound": flash_bound(*q.shape[:3], k.shape[2], q.shape[3])}
    flops = flash_flops(E_BATCH, E_SEQ, cfg.num_heads, cfg.head_dim)
    r["tflops"] = flops / r["ms"] / 1e9
    log(f"flash_attention B={E_BATCH} S={E_SEQ} H={cfg.num_heads} "
        f"KV={cfg.num_kv_heads} dh={cfg.head_dim} bf16 (path E layer 0): "
        f"tensor-core {r['ms']:.4f} ms = {r['tflops']:.1f} TFLOP/s of "
        f"{flops:.4g} flops, SIMT route {r['simt_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
        f"(tensor-core / SDPA {r['ms'] / r['library_ms']:.3f}), bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max |kernel - plain| "
        f"{err:.3g} (atol, rtol {E_FLASH_TOL['bfloat16']}); the same q, k, "
        f"v in float32 {err32:.3g} (atol, rtol {E_FLASH_TOL['float32']})")
    want = FA.flash_attention_plain(q, k, v).float()
    diff = (one(torch, q, k, v).float() - want).abs()
    tol = E_FLASH_TOL["bfloat16"]
    r["one_rounding_outside"] = int(
        (diff > tol[0] + tol[1] * want.abs()).sum())
    r["one_rounding_err"] = float(diff.max())
    del want, diff
    r["one_rounding_ms"] = cuda_ms(torch, lambda: one(torch, q, k, v), 20)
    log(f"flash_attention with P rounded to bf16 once (no lo product) at "
        f"layer 0: {r['one_rounding_ms']:.4f} ms (the split costs "
        f"{r['ms'] / r['one_rounding_ms']:.3f}x), max |kernel - plain| "
        f"{r['one_rounding_err']:.3g}, {r['one_rounding_outside']} outputs "
        f"outside (atol, rtol {tol})")
    del q, k, v
    torch.cuda.empty_cache()

    # a second reading at prefill_32k's length; the plain version on two
    # heads only (the first and the last, each with its KV head), in bf16
    # and with those heads in float32
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, E_LONG, heads, cfg.head_dim), generator=g,
                           device=dev).to(torch.bfloat16)
               for heads in (cfg.num_heads, cfg.num_kv_heads,
                             cfg.num_kv_heads))
    pick = [0, cfg.num_heads - 1]
    kv_pick = [h // cfg.q_per_kv for h in pick]
    got = FA.flash_attention(q, k, v)[:, :, pick]
    q2, k2, v2 = (t[:, :, i].contiguous()
                  for t, i in ((q, pick), (k, kv_pick), (v, kv_pick)))
    want = FA.flash_attention_plain(q2, k2, v2)
    torch.cuda.synchronize()
    err_long = flash_close(torch, got, want, E_FLASH_TOL["bfloat16"],
                           f"S={E_LONG} on two heads")
    del got, want
    err_long32 = flash_compare(torch, FA, q2.float(), k2.float(),
                               v2.float(), 0, True,
                               f"S={E_LONG} on two heads in float32",
                               E_FLASH_TOL["float32"])
    torch.cuda.empty_cache()
    r["plain_ms_32k_2heads"] = cuda_ms(
        torch, lambda: FA.flash_attention_plain(q2, k2, v2), 1)
    r["ms_32k"] = cuda_ms(torch, lambda: FA.flash_attention(q, k, v), 5)
    r["simt_ms_32k"] = cuda_ms(torch, lambda: FA.launch("simt", q, k, v), 1)
    r["library_ms_32k"] = sdpa_ms(torch, q, k, v, 5)
    r["one_rounding_ms_32k"] = cuda_ms(torch, lambda: one(torch, q, k, v),
                                       5)
    r["bound_32k"] = flash_bound(1, E_LONG, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim)
    flops = flash_flops(1, E_LONG, cfg.num_heads, cfg.head_dim)
    r["tflops_32k"] = flops / r["ms_32k"] / 1e9
    log(f"flash_attention B=1 S={E_LONG} bf16: tensor-core "
        f"{r['ms_32k']:.4f} ms = {r['tflops_32k']:.1f} TFLOP/s, P rounded "
        f"once {r['one_rounding_ms_32k']:.4f} ms, SIMT route "
        f"{r['simt_ms_32k']:.4f} ms, SDPA {r['library_ms_32k']:.4f} ms, "
        f"plain on 2 of {cfg.num_heads} heads "
        f"{r['plain_ms_32k_2heads']:.4f} ms, bound "
        f"{r['bound_32k'][0]:.4f} ms ({r['bound_32k'][1]}), max |kernel - "
        f"plain| on 2 heads {err_long:.3g}, in float32 {err_long32:.3g}")
    del q, k, v, q2, k2, v2

    # card vs CPU: the same params, float32 compute
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    prompt = torch.from_numpy(walks_to_lm_tokens(walks % cfg.vocab,
                                                 E_CPU_SEQ)[:1])
    card = serve(torch, M, cfg32, params, prompt.to(dev), E_CPU_GEN)
    host_params = _to_cpu(params)
    del params
    torch.cuda.empty_cache()
    host = serve(torch, M, cfg32, host_params, prompt, E_CPU_GEN)
    gap = float((card[0].cpu() - host[0]).abs().max())
    log(f"E: float32 B=1 S={E_CPU_SEQ}, {E_CPU_GEN} greedy tokens: card vs "
        f"CPU logits max |diff| {gap:.3g} (prefill {card[2]:.3f} s card, "
        f"{host[2]:.3f} s CPU); tokens {card[1][0].tolist()} on the card, "
        f"{host[1][0].tolist()} on the CPU")
    if not torch.allclose(card[0].cpu(), host[0], atol=E_CPU_TOL,
                          rtol=E_CPU_TOL) or \
            not torch.equal(card[1].cpu(), host[1]):
        raise AssertionError("E: card and CPU disagree in float32")
    r["launches_tc"], r["launches_simt"] = by_route
    return launches, max(err, err_long), r


def f_small_gates(np, torch, K, table) -> None:
    """Path F's gates (b) and (c) on ``F_SMALL_SPEC``. (b): each refresh's
    layout on the card equals a from-scratch build at the same store
    version, field by field (weight churn is spliced in place, mixed churn
    may relayout), and walk-window embeddings after the refreshes equal a
    freshly built service's. (c): on the FN-Base layout with
    ``pipeline=True``, after a weight-churn update (spliced, no relayout),
    the whole-walk kernel equals its plain version and the engine's walks
    equal the reference backend's on the same layout."""
    from repro_torch import random as jr
    from repro_torch.core.graph import FIELDS, PaddedGraph
    from repro_torch.core.walk import step_uniforms
    from repro_torch.data.deltas import weight_churn, zipf_churn
    from repro_torch.data.store import open_graph
    from repro_torch.engine import WalkEngine, WalkPlan
    from repro_torch.serve import EmbeddingService
    plan = WalkPlan(p=1.0, q=0.5, backend="fused", cap=128)
    kw = dict(plan=plan, cache_size=512, device=DEV)
    svc = EmbeddingService(F_SMALL_SPEC, table, **kw)
    g = svc.graph
    batches = list(weight_churn(g, num_batches=2, batch_edges=1024,
                                seed=3)) + \
        list(zipf_churn(g, num_batches=2, batch_edges=1024, seed=7))
    spliced = 0
    for batch in batches:
        rep = svc.refresh(batch)
        fresh = PaddedGraph.build(svc.graph, cap=128, device=DEV)
        if (svc._pg.cap, svc._pg.hot_cap) != (fresh.cap, fresh.hot_cap) or \
                not all(torch.equal(getattr(svc._pg, f), getattr(fresh, f))
                        for f in FIELDS):
            raise AssertionError(f"F(b): the layout after refresh {rep} "
                                 f"differs from a fresh build")
        spliced += not rep["relayout"]
        log(f"F(b): {F_SMALL_SPEC} refresh {rep}: layout == fresh build")
    if spliced < 2:
        raise AssertionError("F(b): the weight churn was not spliced")
    again = open_graph(F_SMALL_SPEC)
    again.apply(batches)
    other = EmbeddingService(again, table, **kw)
    nodes = np.random.default_rng(1).choice(g.n, 128, replace=False)
    got = svc.embed(nodes, window=F_WINDOW)
    if not np.array_equal(got, other.embed(nodes, window=F_WINDOW)):
        raise AssertionError("F(b): embed after refresh differs from a "
                             "freshly built service")
    if not np.all(np.isfinite(got)):
        raise AssertionError("F(b): embeddings are not finite")
    del svc, other, fresh

    eng = WalkEngine.build(F_SMALL_SPEC, WalkPlan(
        p=1.0, q=0.5, length=LENGTH, backend="fused", pipeline=True),
        device=DEV)
    rep = eng.update(list(weight_churn(eng.store.graph, num_batches=1,
                                       batch_edges=1024, seed=5)))
    if rep.relayout or not eng._fused_persistent():
        raise AssertionError(f"F(c): the update relaid out ({rep})")
    pg = eng.pg
    walks = eng.run(seed=0).walks
    ref = WalkEngine.build(pg, WalkPlan(p=1.0, q=0.5, length=LENGTH,
                                        backend="reference"))
    if not np.array_equal(walks, ref.run(seed=0).walks):
        raise AssertionError("F(c): fused walks after the update differ "
                             "from the reference backend's")
    starts = torch.arange(pg.n, dtype=torch.int32, device=DEV)
    v1 = torch.from_numpy(walks[:, 0].copy()).to(DEV)
    rand = step_uniforms(jr.PRNGKey(0, device=DEV), starts.long(), LENGTH)
    args = (pg.adj, pg.wgt, pg.deg, starts, v1, rand, 1.0, 0.5)
    got = K.node2vec_walk(*args)
    if not torch.equal(got, K.node2vec_walk_plain(*args)) or \
            not np.array_equal(got.cpu().numpy(), walks[:, 1:]):
        raise AssertionError("F(c): node2vec_walk on the spliced layout "
                             "differs from its plain version")
    log(f"F(c): FN-Base D={pg.cap} after a weight-churn update "
        f"({rep.patch.num_affected} rows spliced, no relayout): "
        f"node2vec_walk == plain == the engine's walks == reference")


def path_f(np, torch, K, store, table) -> dict:
    """Path F: an ``EmbeddingService`` over path A's graph and path C's
    serving table on the fused backend (FN-Cache, cap 128), the JAX
    launcher's ``--full`` settings: every bucket warmed, a Zipf trace of
    ``F_REQUESTS`` replayed against the real clock (closed loop), with
    ``zipf_churn`` (and one weight-churn batch) applied through
    ``refresh`` between its halves. Returns the readings."""
    import dataclasses
    from repro_torch.data.deltas import weight_churn, zipf_churn
    from repro_torch.engine import WalkEngine, WalkPlan
    from repro_torch.serve import EmbeddingService, synthetic_trace
    from repro_torch.serve.service import _walk_avg
    plan = WalkPlan(p=1.0, q=0.5, backend="fused", cap=128)
    t0 = time.perf_counter()
    svc = EmbeddingService(store, table, plan=plan, cache_size=512,
                           linger_s=2e-4, margin_s=1e-3, device=DEV)
    pg = svc._pg         # the first half's layout; refresh builds anew
    mbytes = sum(t.numel() * t.element_size() for t in vars(pg).values()
                 if torch.is_tensor(t))
    log(f"F: {A_SPEC}: n={pg.n} m={svc.graph.m} cap={pg.cap} hot_cap="
        f"{pg.hot_cap} hot={pg.num_hot}; table {tuple(svc.emb.shape)} "
        f"({svc.emb.numel() * 4 / 1e6:.1f} MB), layout {mbytes / 1e6:.1f} "
        f"MB, service built in {time.perf_counter() - t0:.2f} s host")
    t0 = time.perf_counter()
    warm = {}
    for b in svc.batcher.buckets:
        nodes = [0] * b
        svc.embed(nodes, window=0)
        warm[b] = svc.embed(nodes, window=F_WINDOW)
        svc.rank_neighbors(nodes, F_K)
    torch.cuda.synchronize()
    log(f"F: buckets {svc.batcher.buckets} warmed in "
        f"{time.perf_counter() - t0:.2f} s")
    n = svc.graph.n
    trace = synthetic_trace(n, F_REQUESTS, alpha=1.2, rank_share=0.5,
                            qps=20_000.0, deadline_s=0.05, seed=0)
    t0 = time.perf_counter()
    churn = list(zipf_churn(svc.graph, num_batches=4, batch_edges=1024,
                            seed=7))
    log(f"F: zipf_churn of 4 x 1024 events made in "
        f"{time.perf_counter() - t0:.2f} s host")
    responses = []
    asked = {}           # rid -> (kind, node, layout) of the cache misses

    def replay(events, layout):
        for ev in events:
            hits = svc.cache.hits
            rid = svc.submit(ev.kind, ev.node, window=F_WINDOW, k=F_K,
                             deadline_s=ev.deadline_s)
            if svc.cache.hits == hits:
                asked[rid] = (ev.kind, ev.node, layout)
            responses.extend(svc.pump())
        responses.extend(svc.drain())

    half = F_REQUESTS // 2
    runs = count_calls(WalkEngine, "run")
    K.node2vec_step.launches = 0
    K.node2vec_walk.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(trace[:half], 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        refreshes = []

        def refresh(batch):
            t1 = time.perf_counter()
            rep = svc.refresh(batch)
            torch.cuda.synchronize()
            refreshes.append(((time.perf_counter() - t1) * 1e3, rep))
            log(f"F: refresh {len(refreshes)}: {refreshes[-1][0]:.1f} ms "
                f"host, {rep}")
        for batch in churn:
            refresh(batch)
        # weight churn on the churned graph: degrees stay, rows spliced
        refresh(next(weight_churn(svc.graph, num_batches=1,
                                  batch_edges=1024, seed=7)))
        # the second half; its first F_PROFILED requests traced (device
        # activity only), which the stats include
        t1 = time.perf_counter()
        p_wall, p_busy, p_events = profiled(
            torch, lambda: replay(trace[half:half + F_PROFILED], 1),
            cpu=False)
        replay(trace[half + F_PROFILED:], 1)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t1
    finally:
        runs = runs()
    launches = K.node2vec_step.launches
    st = svc.stats()
    log(f"F: replay of {F_REQUESTS} requests (window {F_WINDOW}, k {F_K}, "
        f"zipf a=1.2, rank share 0.5, deadline 50 ms) in {wall:.2f} s "
        f"host: requests {st.requests} expired {st.expired} batches "
        f"{st.batches} p50 {st.p50_latency_us:.1f} us p99 "
        f"{st.p99_latency_us:.1f} us QPS {st.qps:.1f} hit rate "
        f"{st.cache_hit_rate:.4f} occupancy {st.batch_occupancy:.4f}")
    log(f"F: node2vec_step launches in the replay {launches} for {runs} "
        f"walk-window runs of {F_WINDOW} steps; node2vec_walk "
        f"{K.node2vec_walk.launches}")
    log_profile("F replay", f"{F_PROFILED} requests of the second half",
                p_wall, p_busy, p_events)
    if st.requests + st.expired != F_REQUESTS or \
            len(responses) != F_REQUESTS:
        raise AssertionError(f"F(d): {st.requests} + {st.expired} "
                             f"responses ({len(responses)} returned) for "
                             f"{F_REQUESTS} requests")
    if runs == 0 or launches != runs * (F_WINDOW - 1) or \
            K.node2vec_walk.launches:
        raise AssertionError(f"F: node2vec_step launched {launches} times "
                             f"for {runs} walk windows")
    for r in responses:
        if r.expired:
            continue
        ok = (np.all(np.isfinite(r.value)) and r.value.shape == (128,)) \
            if not isinstance(r.value, tuple) else (
                r.value[0].shape == (F_K,) and r.value[0].min() >= -1
                and r.value[0].max() < n
                and np.all(np.isfinite(r.value[1][r.value[0] >= 0])))
        if not ok:
            raise AssertionError(f"F: bad response {r}")

    # gate (a): walks through the refreshed (spliced) layout, fused vs
    # the reference backend on the same device layout, at every bucket's
    # width (from the second half's embed nodes) and at F_SAMPLE walkers
    if refreshes[-1][1]["relayout"]:
        raise AssertionError("F(a): the weight-churn refresh relaid out")
    short = dataclasses.replace(plan, length=F_WINDOW)
    plain = dataclasses.replace(short, backend="reference")
    second = [ev.node for ev in trace[half:] if ev.kind == "embed"]
    _, first_at = np.unique(second, return_index=True)
    second = np.asarray(second, np.int32)[np.sort(first_at)]
    sample = np.random.default_rng(0).choice(n, F_SAMPLE, replace=False)
    for starts in [second[:b] for b in svc.batcher.buckets] + [sample]:
        starts = starts.astype(np.int32)
        got = WalkEngine.build(svc._pg, short).run(
            starts=starts, seed=svc.walk_seed, walker_ids=starts).walks
        want = WalkEngine.build(svc._pg, plain).run(
            starts=starts, seed=svc.walk_seed, walker_ids=starts).walks
        if not np.array_equal(got, want):
            raise AssertionError(f"F(a): fused walks of {len(starts)} "
                                 f"walkers on the patched layout differ "
                                 f"from the reference backend's")
    log(f"F(a): walkers {list(svc.batcher.buckets) + [F_SAMPLE]} x "
        f"{F_WINDOW} on the spliced layout: fused == reference")

    # every served walk-window embedding (warm-up and the replay's cache
    # misses) against walks of the reference backend on the layout it was
    # served from, averaged as the service does
    def plain_embed(layout, nodes):
        nodes = np.asarray(nodes, np.int32)
        walks = WalkEngine.build(layout, plain).run(
            starts=nodes, seed=svc.walk_seed, walker_ids=nodes).walks
        return _walk_avg(svc.emb, torch.from_numpy(nodes).to(DEV),
                         torch.from_numpy(walks).to(DEV)).cpu().numpy()

    served = [{0: [row for b in warm for row in warm[b]]}, {}]
    for r in responses:
        kind, node, layout = asked.get(r.rid, ("hit", 0, 0))
        if kind == "embed" and not r.expired:
            served[layout].setdefault(node, []).append(r.value)
    embed_err, checked = 0.0, 0
    for layout, got in zip((pg, svc._pg), served):
        nodes = np.fromiter(got, np.int64, len(got))
        for node, want in zip(nodes, plain_embed(layout, nodes)):
            for value in got[node]:
                embed_err = max(embed_err, float(np.abs(value - want).max()))
                checked += 1
    if not embed_err <= F_EMBED_TOL:
        raise AssertionError(f"F: served embeddings differ from the plain "
                             f"walks' by {embed_err:.3g} > {F_EMBED_TOL}")
    log(f"F: {checked} served walk-window embeddings (warm-up and the "
        f"replay's cache misses, {len(served[0])} + {len(served[1])} nodes "
        f"on the two layouts) == the reference backend's walks averaged, "
        f"max |diff| {embed_err:.3g} (tolerance {F_EMBED_TOL})")
    del svc, pg
    torch.cuda.empty_cache()
    f_small_gates(np, torch, K, table)
    return {"stats": dataclasses.asdict(st), "launches": launches,
            "runs": runs, "wall": wall, "busy": p_busy / p_wall,
            "embed_err": embed_err, "embeds_checked": checked,
            "refresh_ms": [ms for ms, _ in refreshes],
            "relayouts": [rep["relayout"] for _, rep in refreshes]}


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def log_report(report: str, lib: str) -> None:
    """Each kernel's registers, stack and spills from ``lib``'s
    ``-Xptxas -v`` report, under the kernel's name (its integer and bool
    template arguments shown as <16, true>)."""
    kernel = "?"
    for line in report.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:   # _ZN, then <length><name> pieces (Itanium mangling)
            mangled, i = entry.group(1), 3
            while i < len(mangled) and mangled[i].isdigit():
                j = re.match(r"\d+", mangled[i:]).end() + i
                i = j + int(mangled[i:j])
                kernel = mangled[j:i]
            pairs = re.findall(r"L([a-z])(\d+)E", re.match(
                r"(I(?:L[a-z]\d+E)+E)?", mangled[i:]).group())
            kernel += "<" + ", ".join(("false", "true")[int(x)] if t == "b"
                                      else x for t, x in pairs) + ">" \
                if pairs else ""
        elif "registers" in line or "spill" in line or "Potential" in line:
            log(f"  {lib} {kernel}: {line.strip()}")


def count_calls(module, name: str):
    """Wrap ``module.name`` in a counter; the returned function puts the
    original back and returns the count."""
    orig, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)
    setattr(module, name, counted)

    def done() -> int:
        setattr(module, name, orig)
        return calls[0]
    return done


def drive(torch, engine, rounds: int):
    """Run ``rounds`` FN-Multi rounds; returns (walks list, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walks = [r.walks for r in engine.rounds(rounds, seed=0)]
    torch.cuda.synchronize()
    return walks, time.perf_counter() - t0


def main(argv) -> int:
    if argv not in ([], ["--walks"]):
        print("usage: python3 chip_smoke.py [--walks]", file=sys.stderr)
        return 2
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
    from repro_torch.core.skipgram import serving_table
    from repro_torch.core.walk import step_uniforms, unified_row
    from repro_torch.engine import WalkEngine, WalkPlan
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import node2vec_step as K
    from repro_torch.kernels import sgns as S
    from repro_torch.core import walk as WALK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if argv:   # phase 3 alone
        build.load_all(("node2vec_step",))
        log_report(build.report("node2vec_step"), "node2vec_step")
        walk = walk_phase(np, torch, K, B_SPEC, "B")
        wide = walk_phase(np, torch, K, A_SPEC, WIDE)
        print(json.dumps({"node2vec_walk": {
            "ms": walk["ms"], "d": walk["d"], "ms_wide": wide["ms"],
            "d_wide": wide["d"]}}), flush=True)
        return 0
    t0 = time.perf_counter()
    build.load_all(KERNEL_LIBS)
    one_rounding = load_one_rounding(build)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s host")
    for name in ("node2vec_step", "flash_attention_sm90"):
        log_report(build.report(name), name)

    step_err, walk_err = check_kernels(np, torch, K, PAD_ID)
    sgns_err = check_sgns(np, torch, S)
    # float32 products stay float32 (the card-vs-CPU check of path E)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_err = check_flash(np, torch, FA)

    # ---- main path A: per-step kernel, FN-Cache ------------------------
    spec_a = A_SPEC
    t0 = time.perf_counter()
    first = WalkEngine.build(spec_a, WalkPlan(
        p=1.0, q=0.5, length=LENGTH, cap=128, backend="fused"), device=DEV)
    pg_a = first.pg
    log(f"A: {spec_a}: n={pg_a.n} m={first.store.graph.m} "
        f"max_deg={pg_a.hot_cap} hot={pg_a.num_hot} layout built in "
        f"{time.perf_counter() - t0:.2f} s host")
    step_launches, rows_built = {}, {}
    for mode in ("exact", "approx"):
        kw = dict(p=1.0, q=0.5, length=LENGTH, cap=128, mode=mode)
        fused = WalkEngine.build(pg_a, WalkPlan(backend="fused", **kw))
        ref = WalkEngine.build(pg_a, WalkPlan(backend="reference", **kw))
        K.node2vec_step.launches = 0
        K.node2vec_walk.launches = 0
        built = count_calls(WALK, "unified_row")
        try:
            walks, secs = drive(torch, fused, 2)
        finally:
            built = built()
        step_launches[mode] = K.node2vec_step.launches
        rows_built[mode] = built
        # step 0's first-order draw builds the start rows once a run; exact
        # supersteps read the layout in place
        if mode == "exact" and built != 2:
            raise AssertionError(f"A/exact: the fused run built full-width "
                                 f"rows {built} times, want 2 (step 0 of "
                                 f"each round)")
        if mode == "exact":
            lm_walks = walks[0]               # path E's prompts
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
            f"{step_launches[mode]}; unified_row calls {rows_built[mode]}")
        profile_round(torch, lambda: fused.run(seed=1), f"A/{mode} fused")

    # superstep s of path A's round 0 (seed 0), for timing the step kernel:
    # walks[:, k] is the vertex after step k, so u = walks[:, s - 2] and
    # v = walks[:, s - 1]
    starts = torch.arange(pg_a.n, dtype=torch.int32, device=DEV)
    walk_a = torch.from_numpy(ref_walks[0]).to(DEV)
    s = LENGTH // 2
    u_s = walk_a[:, s - 2].contiguous()
    v_s = walk_a[:, s - 1].contiguous()
    rand = step_uniforms(jr.PRNGKey(0, device=DEV), starts.long(),
                         s + 1)[:, s - 1].contiguous()

    def rows():
        return (unified_row(pg_a, v_s, ("adj", "wgt")),
                unified_row(pg_a, u_s, ("adj",)))
    (cand, cw, _), (prev, _) = rows()
    step_args = (cand, cw, u_s, prev, rand, 1.0, 0.5)
    layout_args = (pg_a, u_s, v_s, rand, 1.0, 0.5)
    slot, nxt = K.node2vec_step_layout(*layout_args)
    want, want_nxt = K.node2vec_step_layout_plain(*layout_args)
    for got in (slot, K.node2vec_step(*step_args)):
        step_err = max(step_err, int_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError("node2vec_step differs on path A's inputs")
    step_err = max(step_err, int_err(nxt, want_nxt))
    if not torch.equal(nxt, want_nxt):
        raise AssertionError("node2vec_step_layout's next vertices differ on "
                             "path A's inputs")
    layout_fn = lambda: K.node2vec_step_layout(*layout_args)  # noqa: E731
    rows_fn = lambda: K.node2vec_step(*step_args)             # noqa: E731
    t = [cuda_ms(torch, fn, 20) for fn in (layout_fn, rows_fn, rows_fn,
                                           layout_fn)]
    step = {"ms_layout": (t[0] + t[3]) / 2,
            "ms_rows_entry": (t[1] + t[2]) / 2,
            "rows_ms": cuda_ms(torch, rows, 10),
            "plain_ms": cuda_ms(torch, lambda: K.node2vec_step_layout_plain(
                *layout_args), 5),
            "plain_rows_ms": cuda_ms(torch, lambda: K.node2vec_step_plain(
                *step_args), 5)}
    wk, d = cand.shape
    # what the layout entry needs: v's live ids and weights, u's live ids,
    # u, v, r, hot_pos and deg of u and v in, slot and next vertex out; the
    # row entry reads v's ids up to and including the PAD edge and writes
    # only the slot
    live_v = (cand != PAD_ID).sum(1)
    live_u = (prev != PAD_ID).sum(1)
    step_bound = bound_ms(int((8 * live_v + 4 * live_u).sum()) + 36 * wk,
                          3 * int(live_v.sum()))
    rows_bound = bound_ms(
        int((4 * live_v.add(1).clamp(max=d) + 4 * live_v + 4 * live_u).sum())
        + 12 * wk, 3 * int(live_v.sum()))
    log(f"node2vec_step W={wk} D={d} (mean live lanes "
        f"{float(live_v.double().mean()):.2f} of v, "
        f"{float(live_u.double().mean()):.2f} of u): layout entry "
        f"{step['ms_layout']:.4f} ms, bound {step_bound[0]:.4f} ms "
        f"({step_bound[1]}); row entry on the unified rows "
        f"{step['ms_rows_entry']:.4f} ms (bound {rows_bound[0]:.4f} ms) + "
        f"the rows' assembly (unified_row of v and u) {step['rows_ms']:.4f} "
        f"ms; plain layout {step['plain_ms']:.4f} ms, plain rows "
        f"{step['plain_rows_ms']:.4f} ms")
    store_a = first.store                     # path F serves this graph
    del first, fused, ref, walks, ref_walks, cand, cw, prev

    # ---- main path C: streamed SGNS with the fused kernel --------------
    trainer, c_walks, sgns_launches = path_c(np, torch, pg_a)
    sg = time_sgns(np, torch, S, trainer, c_walks[0], 1024, "main path")
    bw = time_sgns(np, torch, S, trainer, c_walks[0], 65536,
                   "bandwidth reading")
    sgns_err = max(sgns_err, sg["err"], bw["err"])
    profile_round(torch, lambda: trainer.consume(
        c_walks[0][:C_PROFILE_WALKERS]), "C fused SGNS", "~200 steps")
    table_c = serving_table(trainer.params)    # path F's table
    del trainer, c_walks, pg_a

    # ---- main path B: whole-walk kernel, FN-Base -----------------------
    walk = walk_phase(np, torch, K, B_SPEC, "B", profile=True)
    wide = walk_phase(np, torch, K, A_SPEC, WIDE)
    walk_err = max(walk_err, walk["err"], wide["err"])

    # ---- path D: train_streamed end to end, card vs CPU ----------------
    t0 = time.perf_counter()
    micro, macro, st_d, d_launches = path_d(np, torch)
    secs = time.perf_counter() - t0
    if d_launches != st_d.steps:
        raise AssertionError(f"D: sgns_fused launched {d_launches} times "
                             f"for {st_d.steps} steps")
    micro_cpu, macro_cpu, _, _ = path_d(np, torch, device="cpu")
    log(f"D: {D_SPEC} train_streamed on the card in {secs:.2f} s "
        f"({st_d.steps} steps, sgns_fused launches {d_launches}): "
        f"micro-F1 {micro:.4f} macro-F1 {macro:.4f}; on the CPU micro-F1 "
        f"{micro_cpu:.4f} macro-F1 {macro_cpu:.4f}")
    if abs(micro - micro_cpu) > D_F1_GAP:
        raise AssertionError(f"D: micro-F1 card {micro} vs CPU {micro_cpu}")

    # ---- path E: LM serving, flash_attention at every prefill layer ----
    torch.cuda.empty_cache()
    flash_launches, err, fl = path_e(np, torch, lm_walks, one_rounding)
    flash_err = max(flash_err, err)
    del lm_walks
    torch.cuda.empty_cache()

    # ---- path F: embedding serving with churn, step kernel per superstep
    f = path_f(np, torch, K, store_a, table_c)

    kernels = [
        {"name": "node2vec_step", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/node2vec_step.py:92",
         "launches": step_launches["exact"], "max_abs_err": step_err,
         "ms": step["ms_layout"], "plain_ms": step["plain_ms"],
         "bound_ms": step_bound[0], "bound_by": step_bound[1],
         "library_ms": None, "ms_layout": step["ms_layout"],
         "rows_ms": step["rows_ms"], "ms_rows_entry": step["ms_rows_entry"],
         "bound_ms_rows_entry": rows_bound[0],
         "plain_rows_ms": step["plain_rows_ms"],
         "launches_approx": step_launches["approx"],
         "launches_serving": f["launches"],
         "unified_row_calls": rows_built},
        {"name": "node2vec_walk", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/node2vec_step.py:192",
         "launches": walk["launches"], "max_abs_err": walk_err,
         "ms": walk["ms"], "plain_ms": walk["plain_ms"],
         "bound_ms": walk["bound"][0], "bound_by": walk["bound"][1],
         "library_ms": None, "d_wide": wide["d"], "ms_wide": wide["ms"],
         "plain_ms_wide": wide["plain_ms"],
         "bound_ms_wide": wide["bound"][0],
         "bound_by_wide": wide["bound"][1]},
        {"name": "sgns_fused", "route": "cuda", "source": SGNS_SOURCE,
         "replaces": "src/repro/kernels/sgns.py:76",
         "launches": sgns_launches, "max_abs_err": sgns_err,
         "ms": sg["ms_host"], "plain_ms": sg["plain_ms"],
         "bound_ms": sg["bound"][0], "bound_by": sg["bound"][1],
         "library_ms": None, "ms_host": sg["ms_host"],
         "ms_device": sg["ms_device"], "ms_old": sg["ms_old"],
         "ms_old_device": sg["ms_old_device"],
         "ms_rows_entry": sg["ms_rows_entry"],
         "ms_rows_entry_device": sg["ms_rows_entry_device"],
         "ms_bw": bw["ms_host"], "ms_device_bw": bw["ms_device"],
         "ms_old_bw": bw["ms_old"], "ms_old_device_bw": bw["ms_old_device"],
         "ms_rows_entry_bw": bw["ms_rows_entry"],
         "ms_rows_entry_device_bw": bw["ms_rows_entry_device"],
         "plain_ms_bw": bw["plain_ms"], "bound_ms_bw": bw["bound"][0],
         "bound_by_bw": bw["bound"][1]},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": flash_launches, "launches_tc": fl["launches_tc"],
         "launches_simt": fl["launches_simt"], "max_abs_err": flash_err,
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound"][0], "bound_by": fl["bound"][1],
         "library_ms": fl["library_ms"], "tflops": fl["tflops"],
         "simt_source": FLASH_SIMT_SOURCE, "simt_ms": fl["simt_ms"],
         "ms_32k": fl["ms_32k"], "library_ms_32k": fl["library_ms_32k"],
         "simt_ms_32k": fl["simt_ms_32k"],
         "plain_ms_32k_2heads": fl["plain_ms_32k_2heads"],
         "tflops_32k": fl["tflops_32k"],
         "one_rounding_ms": fl["one_rounding_ms"],
         "one_rounding_ms_32k": fl["one_rounding_ms_32k"],
         "one_rounding_outside": fl["one_rounding_outside"],
         "bound_ms_32k": fl["bound_32k"][0],
         "bound_by_32k": fl["bound_32k"][1]},
    ]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

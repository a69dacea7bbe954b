#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (walks, SGNS training and LM serving) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``. It
builds the kernels of ``src/repro_torch/kernels/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, on
   inputs made from a numpy seed (slots and walks must be ``torch.equal``);
   1b. ``sgns_fused`` against its plain version at nine shapes up to
   B=65,536, K=40 and D=1,024 (``atol=rtol=3e-4``, masked rows exactly 0,
   two launches on one input ``torch.equal``);
   1c. ``flash_attention`` against its plain version at the shapes of
   tests/test_flash_attention.py (GQA, MHA, MQA with window 64, ragged
   S=96, dh=128, bf16), S=1 and a ragged dh=100, causal and not
   (``atol=rtol=3e-3`` in float32, 3e-2 in bf16; two launches on one
   input ``torch.equal``);
2. main path A — the per-step ``node2vec_step`` kernel on the FN-Cache
   layout: ``WalkEngine.build("wec:k=17,deg=100,seed=0", WalkPlan(
   backend="fused", cap=128, ...))``, two FN-Multi rounds in exact and in
   approx mode, every vertex a walker; walks must equal the reference
   backend's and the kernel must launch once per superstep;
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
   round 0 exactly; then ~200 steps of a fresh trainer on each SGNS backend
   (fused and the autograd one) give their steps per second;
3. main path B — the whole-walk ``node2vec_walk`` kernel on the FN-Base
   layout (``er:k=18,deg=100,seed=0``, ``pipeline=True``, one round); walks
   must equal the reference backend's, one launch;
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
   prefill and never at decode, logits must be finite and tokens in
   range, and layer 0's kernel output within 3e-2 of the plain version's.
   The kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick, never on the path) are
   timed at layer 0's inputs, and the kernel and SDPA again at B=1,
   S=32,768 (checked against the plain version on two heads). Last, the
   same params in float32 on the card and on the CPU (B=1, S=512, 8
   greedy tokens): the logits within ``atol=rtol=1e-3``, tokens equal.

It prints the card's name and power limit, the build seconds, walker-steps
per second for each walk phase, prefill tokens/s and decode ms/token, a
``{"kernels": [...]}`` line, and last
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
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 dense tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/node2vec_step.cu"
SGNS_SOURCE = "src/repro_torch/kernels/csrc/sgns.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
LENGTH = 80
TOP = 8                         # kernels listed per profiled round
SGNS_TOL = 3e-4                 # the JAX package's kernel tolerance
SGNS_SHAPES = [(8, 1, 16), (64, 5, 32), (100, 8, 128), (512, 5, 200),
               (3, 12, 300), (256, 40, 64), (256, 5, 1024), (1024, 5, 128),
               (65536, 5, 128)]
C_EVERY = 128                   # path C walks every 128th vertex
C_ROUNDS = 2
C_PROFILE_WALKERS = 137         # ~200 optimizer steps at length 80
C_FALL = 0.9                    # each round's loss ends at most 0.9 x start
D_SPEC = "sbm:n=400,c=4,pin=0.06,pout=0.004,seed=1"
D_F1_GAP = 0.05
FLASH_TOL = {"float32": 3e-3, "bfloat16": 3e-2}   # the JAX package's tests
# (atol, rtol) at path E's inputs, whose outputs are ~0.01-0.04 past the
# first rows: kernel and plain both compute in float32, so in bf16 they
# differ by the output's rounding (one ulp, at most 2^-7 of a value) and in
# float32 by the order of the sums
E_FLASH_TOL = {"bfloat16": (2e-3, 1e-2), "float32": (1e-4, 1e-4)}
FLASH_SHAPES = [(2, 128, 4, 2, 32, 0), (1, 256, 2, 2, 64, 0),
                (2, 256, 4, 1, 32, 64), (1, 96, 3, 3, 16, 0),
                (1, 128, 2, 2, 128, 0), (1, 1, 4, 2, 128, 0),
                (2, 300, 8, 2, 100, 50)]
E_ARCH, E_LAYERS = "yi-6b", 4   # published widths, depth cut 32 -> 4
E_BATCH, E_SEQ, E_GEN = 4, 4096, 32
E_LONG = 32768                  # prefill_32k's length, a second reading
E_CPU_SEQ, E_CPU_GEN, E_CPU_TOL = 512, 8, 1e-3


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


def profile_round(torch, run, label: str, what: str = "round") -> None:
    """Profile one warm call of ``run``: its wall seconds (host clock,
    ending in a synchronize), the share of that window the device was busy
    (the summed time of the device's own events), and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                    key=device_us, reverse=True)
    busy = sum(map(device_us, events)) / 1e6
    log(f"profile {label}: {what} {wall:.4f} s under the profiler, device "
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


def check_sgns(np, torch, S) -> float:
    """Phase 1b: ``sgns_fused`` against its plain version on the card."""
    rng = np.random.default_rng(1)
    err = 0.0
    for b, k, d in SGNS_SHAPES:
        args = [torch.from_numpy(a).cuda() for a in sgns_rows(np, rng, b, k,
                                                              d)]
        err = max(err, sgns_compare(torch, S, args, f"B={b} K={k} D={d}"))
    log(f"sgns_fused == plain (atol=rtol={SGNS_TOL}, max |err| {err:.3g}), "
        f"deterministic, masked rows 0, on {len(SGNS_SHAPES)} shapes")
    return err


def sgns_bound(b: int, k: int, d: int):
    """Least time for the kernel's work: ci, po, no and valid read once,
    the three grads and the loss written once; ~5KD + 4D float32
    operations a row (dots, scales and the g_ci sum)."""
    nbytes = 8 * b * d * (2 + k) + 4 * b + 4
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
    rates = {}
    for backend in ("fused", "jnp"):
        tr = StreamingSGNSTrainer(**{**kw, "sgns_backend": backend})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.consume(kept[0][:C_PROFILE_WALKERS])
        tr.loss_history()                       # waits for the last step
        rates[backend] = tr.recorder.steps / (time.perf_counter() - t0)
        del tr
    log(f"C: the same {C_PROFILE_WALKERS} walkers of round 0 on a fresh "
        f"trainer: fused {rates['fused']:.4g} steps/s, jnp "
        f"{rates['jnp']:.4g} steps/s")
    return trainer, kept, launches


def time_sgns(np, torch, S, trainer, walks, b: int, label: str):
    """Kernel and plain-version times at batch ``b`` on rows gathered from
    the trained tables with pairs of ``walks``; returns (ms, plain_ms,
    bound, max |kernel - plain|)."""
    from repro_torch.train.pairs import device_pairs
    w = torch.from_numpy(walks).cuda()
    c, x, valid = device_pairs(w, 10)
    pick = torch.from_numpy(np.random.default_rng(b).choice(
        c.numel(), b, replace=b > c.numel())).cuda()
    negs = torch.from_numpy(np.random.default_rng(b + 1).integers(
        0, trainer.vocab, (b, 5))).cuda()
    p = trainer.params
    args = (p["emb_in"][c[pick].long()], p["emb_out"][x[pick].long()],
            p["emb_out"][negs], valid[pick].float())
    err = sgns_compare(torch, S, args, label)
    reps = 200 if b <= 4096 else 50
    ms = cuda_ms(torch, lambda: S.sgns_fused(*args), reps, warmup=5)
    plain = cuda_ms(torch, lambda: S.sgns_fused_plain(*args), reps // 4,
                    warmup=2)
    bound = sgns_bound(b, 5, 128)
    log(f"sgns_fused {label} (B={b} K=5 D=128): {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
        f"max |kernel - plain| {err:.3g}")
    return ms, plain, bound, err


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


def check_flash(np, torch, FA) -> float:
    """Phase 1c: ``flash_attention`` against its plain version on the card,
    on inputs from a numpy seed, in float32 and bf16, causal and not."""
    rng = np.random.default_rng(2)
    err, n = 0.0, 0
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
    log(f"flash_attention == plain (atol=rtol 3e-3 f32, 3e-2 bf16; max "
        f"|err| {err:.3g}), deterministic, on {n} cases")
    return err


def flash_bound(b: int, s: int, h: int, kv: int, dh: int):
    """Least time for causal bf16 attention: q, k, v read once and o
    written once, against 4 * dh flops for each of the s (s + 1) / 2
    unmasked (query, key) pairs of a head at the bf16 tensor-core rate."""
    nbytes = 2 * b * s * dh * (2 * h + 2 * kv)
    return bound_ms(nbytes, 4 * b * h * dh * (s * (s + 1) // 2),
                    BF16_OPS_PER_S)


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
    decode seconds, kernel launches at prefill and at decode)."""
    from repro_torch.kernels import flash_attention as FA
    dev = params["embed"]["tok"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    b, s = tokens.shape
    sync()
    FA.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, caches = M.prefill(cfg, params, {"tokens": tokens},
                               max_len=s + gen)
    sync()
    t_prefill = time.perf_counter() - t0
    at_prefill = FA.flash_attention.launches
    outs, toks = [logits], [torch.argmax(logits, -1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = M.serve_step(cfg, params, toks[-1], s + i, caches)
        outs.append(logits)
        toks.append(torch.argmax(logits, -1))
    sync()
    return (torch.stack(outs), torch.stack(toks, 1), t_prefill,
            time.perf_counter() - t0, at_prefill,
            FA.flash_attention.launches - at_prefill)


def path_e(np, torch, walks, dev="cuda"):
    """Path E: LM serving at yi-6b's full width, 4 layers, with the kernel
    at every prefill layer; then the kernel's readings at layer 0's inputs
    and at S=32,768, and the same params in float32 on card and CPU.
    Returns (launches, max |err|, readings)."""
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
    if (launches, dec_launches) != (cfg.num_layers, 0):
        raise AssertionError(f"E: flash_attention launched {launches} times "
                             f"at prefill and {dec_launches} at decode, want "
                             f"{cfg.num_layers} and 0")
    if not bool(torch.isfinite(logits).all()) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        raise AssertionError("E: non-finite logits or tokens out of range")
    log(f"E: prefill B={E_BATCH} S={E_SEQ}: {t_pre:.4f} s = "
        f"{E_BATCH * E_SEQ / t_pre:.6g} tokens/s; decode {E_GEN} steps: "
        f"{t_dec / E_GEN * 1e3:.4f} ms/token; flash_attention launches "
        f"{launches} at prefill (== layers), {dec_launches} at decode; "
        f"tokens {toks[0, :8].tolist()}")
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
    r = {"ms": cuda_ms(torch, lambda: FA.flash_attention(q, k, v), 5),
         "plain_ms": cuda_ms(torch, lambda: FA.flash_attention_plain(
             q, k, v), 2),
         "library_ms": sdpa_ms(torch, q, k, v, 20),
         "bound": flash_bound(*q.shape[:3], k.shape[2], q.shape[3])}
    log(f"flash_attention B={E_BATCH} S={E_SEQ} H={cfg.num_heads} "
        f"KV={cfg.num_kv_heads} dh={cfg.head_dim} bf16 (path E layer 0): "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}), max |kernel - plain| {err:.3g} (atol, rtol "
        f"{E_FLASH_TOL['bfloat16']}); the same q, k, v in float32 "
        f"{err32:.3g} (atol, rtol {E_FLASH_TOL['float32']})")
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
    r["ms_32k"] = cuda_ms(torch, lambda: FA.flash_attention(q, k, v), 2)
    r["library_ms_32k"] = sdpa_ms(torch, q, k, v, 5)
    r["bound_32k"] = flash_bound(1, E_LONG, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim)
    log(f"flash_attention B=1 S={E_LONG} bf16: {r['ms_32k']:.4f} ms, SDPA "
        f"{r['library_ms_32k']:.4f} ms, bound {r['bound_32k'][0]:.4f} ms "
        f"({r['bound_32k'][1]}), max |kernel - plain| on 2 heads "
        f"{err_long:.3g}, in float32 {err_long32:.3g}")
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
    return launches, max(err, err_long), r


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


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
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import node2vec_step as K
    from repro_torch.kernels import sgns as S

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load_all(("node2vec_step", "sgns", "flash_attention"))
    log(f"kernel build: {time.perf_counter() - t0:.2f} s host")

    step_err, walk_err = check_kernels(np, torch, K, PAD_ID)
    sgns_err = check_sgns(np, torch, S)
    # float32 products stay float32 (the card-vs-CPU check of path E)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash_err = check_flash(np, torch, FA)

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
            f"{step_launches[mode]}")
        profile_round(torch, lambda: fused.run(seed=1), f"A/{mode} fused")

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

    # ---- main path C: streamed SGNS with the fused kernel --------------
    trainer, c_walks, sgns_launches = path_c(np, torch, pg_a)
    sgns_ms, sgns_plain_ms, sgns_bnd, err = time_sgns(
        np, torch, S, trainer, c_walks[0], 1024, "main path")
    sgns_err = max(sgns_err, err)
    bw_ms, bw_plain_ms, bw_bnd, err = time_sgns(
        np, torch, S, trainer, c_walks[0], 65536, "bandwidth reading")
    sgns_err = max(sgns_err, err)
    profile_round(torch, lambda: trainer.consume(
        c_walks[0][:C_PROFILE_WALKERS]), "C fused SGNS", "~200 steps")
    del trainer, c_walks, pg_a

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
    profile_round(torch, lambda: fused.run(seed=1), "B fused+pipeline")

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
    del fused, ref, pg_b, walks, ref_walks, walk_args, rand, tail, want
    torch.cuda.empty_cache()
    flash_launches, err, fl = path_e(np, torch, lm_walks)
    flash_err = max(flash_err, err)

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
        {"name": "sgns_fused", "route": "cuda", "source": SGNS_SOURCE,
         "replaces": "src/repro/kernels/sgns.py:76",
         "launches": sgns_launches, "max_abs_err": sgns_err,
         "ms": sgns_ms, "plain_ms": sgns_plain_ms, "bound_ms": sgns_bnd[0],
         "bound_by": sgns_bnd[1], "library_ms": None,
         "ms_bw": bw_ms, "plain_ms_bw": bw_plain_ms, "bound_ms_bw": bw_bnd[0],
         "bound_by_bw": bw_bnd[1]},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": flash_launches, "max_abs_err": flash_err,
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound"][0], "bound_by": fl["bound"][1],
         "library_ms": fl["library_ms"],
         "ms_32k": fl["ms_32k"], "library_ms_32k": fl["library_ms_32k"],
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
    sys.exit(main())

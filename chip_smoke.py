#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (walks, SGNS training, LM serving,
embedding serving under graph churn, the training launcher on an on-disk
edge list, the sharded walk backend and tables across a
``torch.distributed`` world, LM training, the MoE and Mamba2 layers, cross
attention, the dry-run against the card and the examples) on one NVIDIA
GPU.

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
   1d. the threefry kernel ``torch.equal`` to ``threefry2x32_plain`` on
   the same card inputs at the cells' sizes: a superstep's fold_in, split
   and uniform (split's strided half) at W = 2^20, ``step_uniforms`` over
   [2^20, 79] whole and stage by stage, and ``random_bits`` one past a
   CHUNK; each timed device-only beside the plain version and its bound;
2. main path A — the per-step ``node2vec_step`` kernel on the FN-Cache
   layout: ``WalkEngine.build("wec:k=17,deg=100,seed=0", WalkPlan(
   backend="fused", cap=128, ...))``, two FN-Multi rounds in exact and in
   approx mode, every vertex a walker; walks must equal the reference
   backend's, the kernel (its layout entry) must launch once per
   superstep, and in exact mode no superstep may build full-width rows
   (``unified_row`` runs once a round, for step 0's first-order draw), and
   exact supersteps must launch the threefry kernel 3 times each. At
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
   round 0 exactly; then ~50 steps of a fresh trainer on the fused
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
5. profiles one more round of each walk path and ~50 steps of paths C
   and G1 with ``torch.profiler``, tracing the device's activity only:
   the window's wall seconds, the share of it the device was busy, and
   the kernels with the most device time;
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
   ``rank_neighbors`` at k=10; ``synthetic_trace(n, 3_000, alpha=1.2,
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
   version == the engine's walks == the reference backend's;
9. path G — training with sharded tables and the launcher. G1: right
   after path C, ``StreamingSGNSTrainer(..., shard_tables=True)`` at path
   C's settings over path C's two rounds: lazy row-Adam on each batch's
   unique rows, ``sgns_fused``'s row entry (through ``sgns_row_grads``)
   once a step and the table entry never, the loss falling within each
   round, a concat replay of round 0 ``torch.equal`` to the streamed
   tables, the tables within 2e-4 of the same trainer on the CPU after
   its first 100 steps, and at that reading and after each round within
   10x of a control's gap to the CPU (the CPU trainer with its row grads
   rounded once from float64: what rounding alone does under lazy
   row-Adam), and different from path C's dense tables; sharded and dense
   steps/s in turns and a profile of ~50 steps. The CPU trainers run in
   a worker process (``python3 chip_smoke.py --g1-cpu DIR``, which sees
   no card) beside paths G1 to G2, and are read at the end. G2:
   ``wec:k=16,deg=100,seed=0`` written with ``write_edgelist`` once per
   undirected edge (~3.3M lines), then
   ``repro_torch.launch.train.main`` in this process with ``--graph
   edgelist:<file>,relabel=degree --graph-cache <dir> --p 1 --q 0.5
   --rounds 1 --walk-length 80 --dim 128 --window 10 --negatives 5
   --sgns-batch 65536 --sgns-backend fused --shard-tables``: the cached
   CSR and ``perm.npy`` must equal ``relabel_by_degree`` of the in-memory
   graph, a second ``open_graph`` must hit the cache (no builder called,
   memmap-backed arrays), the row entry must launch once a step,
   ``embeddings.npy`` must be finite with unit-norm rows, and a second
   run on the same ``--ckpt-dir`` must resume from the checkpointed
   rounds and write the same ``embeddings.npy``; each stage's host
   seconds are printed.
10. path H — the sharded (Pregel) walk backend and the sharded tables
   across ``torch.distributed`` worlds, right after G1. H1: in this
   process, a world of one over NCCL: ``WalkEngine.build(path A's layout,
   WalkPlan(backend="sharded", cap=128, p=1, q=0.5, ...))`` in exact and
   approx mode, the walks equal to path A's fused walks of the same seed,
   0 drops, walker-steps/s and a profile. H2-H4 in two processes the
   script starts (``python3 chip_smoke.py --h-rank R DIR``), both on the
   one card in a gloo world (NCCL refuses two ranks on one card): H2 the
   same walks exact, barrier and ``pipeline=True`` (both ranks' gathered
   walks equal H1's, 0 drops) and at ``capacity="auto"`` (its drops and
   ``WalkStats.collective_bytes`` beside the exchange's time, each
   ``all_to_all`` timed from a synchronized card); H3 G1's sharded trainer
   on path C's round 0 (row-entry launches == steps on each rank, the loss
   falling, the gathered tables ``torch.equal`` to G1's world-1 tables
   after round 0);
   H4 ``launch.train.main`` with ``--shard-tables --sgns-backend fused``
   on ``wec:k=12,deg=100,seed=0`` in the ranks' world, its
   ``embeddings.npy`` equal to the same command's in this process (a
   world of one).
11. path I — LM training at yi-6b's full width (d_model 4,096, 32 heads on
   4 KV heads, head_dim 128, d_ff 11,008, vocab 64,000, bf16 compute, f32
   params, remat on) cut to 2 layers, right after path E, through the
   launcher's ``run_lm`` and ``lm_train_step`` (``loss_fn``'s grads by
   autograd, ``clip_by_global_norm(., 1.0)``, AdamW lr 3e-4). I1: the
   same params in float32 on the card and on the CPU, one ``loss_fn``
   and its grads' global norm at B=1, S=128 (relative gaps within 1e-4),
   then 5 launcher steps at ``smoke_config("yi-6b")`` on both (losses
   and grad norms within 1e-4 relative). I2: ``run_lm`` for 20 steps at
   B=8, S=1,024 on path A's round-0 walks modulo the vocabulary
   (``walks_to_lm_tokens``), which checkpoints ``(params, opt_state)``
   at the end; the loss finite, its last 5 steps' mean below its first
   5's; ms/step and tokens/s of the steady steps, peak memory, and a
   profile of 3 more steps. None of the four kernels may launch (the
   LM launcher's resume is held on the card in path J3, and on the CPU
   in tests/test_torch_lm_train.py);
12. path J — the MoE and Mamba2 layers, right after path I, on path A's
   round-0 walks modulo the vocabulary. J1: mamba2-370m whole (48 layers
   at published widths, bf16 compute, f32 params): ``prefill`` of B=4 x
   S=4,096 (16 chunks of 256) and 32 greedy ``serve_step``s with every
   kernel count set to 0 just before, none of the four kernels launched,
   a second prefill ``torch.equal`` to the first, profiles of a prefill
   and 8 decode steps, peak memory; in float32 on its first 2 layers the
   logits of ``prefill`` of 255 tokens and one ``serve_step`` within 2e-3
   of ``prefill`` of 256's (tests/test_models.py's chunked == stepwise
   tolerance), and card vs CPU at B=1, S=512 within 1e-3 (8 greedy tokens
   equal). J2: phi3.5-moe-42b-a6.6b at published widths cut from 32 to 2
   layers (16 experts, top-2, capacity factor 1.25): the same serving run
   (capacity 2,560 at prefill, 1 at decode), ``flash_attention`` exactly
   twice at prefill, both on the tensor-core route, and never at decode,
   the share of (token, expert) assignments dropped per layer at prefill
   and at decode, two prefills ``torch.equal`` (the deterministic
   scatter-add), the kernel at layer 0's bf16 q, k, v (B=4, S=4,096,
   32/8 heads) within path E's tolerance of its plain version; then
   layer 0 in float32 on the card and on the CPU from
   params made once on the card (B=1, S=128): logits within 1e-3, and
   each token's experts and each expert's kept tokens equal but where a
   token's k-th and next router probabilities lie within 1e-5 (their
   count printed). J3: ``launch.train.run_lm`` with ``--task lm --arch
   mamba2-370m`` at full depth at the launcher's batch (B=8, S=128): 3
   steps, then a fresh run resumed from their checkpoint to 6 (the
   restored params and AdamW state ``torch.equal`` to the saved); the
   losses and grad norms finite, ms/step and tokens/s;
13. path K — cross attention, right after path J, prompts from path A's
   round-0 walks, memories normal(0, 1) from a numpy seed in float32
   (zero memory would leave the cross layers inert). K1:
   seamless-m4t-medium whole (12 encoder and 12 decoder layers at
   published widths, bf16 compute, f32 params): ``prefill`` of B=4 x
   S=4,096 with frames [4, 1,024, 1,024] and 32 greedy ``serve_step``s
   with every count set to 0 just before; ``flash_attention`` exactly 24
   times at prefill (12 with ``causal=False``: the encoder), all on the
   tensor-core route, and never at decode; a second prefill
   ``torch.equal``; each cross layer's ``mk``/``mv`` ``torch.equal`` to
   ``memory_kv`` of the encoder output recomputed alone, and unchanged by
   decode steps; frames from another seed move the logits; profiles; the
   kernel at encoder layer 0's (non-causal) and decoder layer 0's inputs
   within path E's bf16 tolerance of its plain version, timed beside it,
   SDPA and the bound; float32 card vs CPU at 2 encoder and 2 decoder
   layers, B=1, S=256 with the full 1,024 frames (1e-3, 8 greedy tokens
   equal). K2: llama-3.2-vision-11b at published widths cut from 40 to
   5 layers (four self-attention layers and the cross layer over 1,600
   patch embeddings): the same, with 4 launches at prefill, and card vs
   CPU on the whole cut model. K3: ``launch.train.lm_train_step`` on
   seamless whole, B=8 x S=256 with seeded frames, 5 steps: losses and
   grad norms finite, every encoder leaf's first AdamW moment non-zero
   after step 1, none of the four kernels launched; ms/step, tokens/s,
   peak memory and a profile;
14. path L — the dry-run (``repro_torch.launch.dryrun``) held against
   the card, right after path K. L1: ``lower_cell`` at mesh 1x1 of the
   runs paths E (prefill), I (a training step), J2 and K2 (prefill) made,
   at their config cuts, batches and seqs: counted FLOPs over 989 TFLOP/s
   and ``analytic_bytes`` over 3.35 TB/s, the larger over the path's
   measured time (warm prefills, I's median step) must lie in (0, 1.05],
   and ``resident_bytes`` must not pass the path's peak memory; no model
   runs there. L2: jamba-v0.1-52b at published widths cut to one
   superblock (8 of 32 layers: 1 attention, 7 Mamba2, 4 MoE of 16
   experts x 14,336), bf16 params drawn on the card through the chunked
   draws, the init peak at most the params' bytes plus the largest
   leaf's float32 bytes plus 1 GB; one prefill of B=1 x S=4,096 of path
   A's walks and 8 greedy steps with every count set to 0 just before:
   ``flash_attention`` once at prefill on the tensor-core route and
   never at decode, logits finite, the kernel on the attention layer's
   own q, k, v within path E's tolerance of its plain version, the
   dry-run's ``resident_bytes`` within the measured peak. L3, run beside
   the examples so that its host load times nothing: ``python -m
   repro_torch.launch.dryrun --arch yi-6b --shape train_4k`` with no card
   visible exits 0 and writes its pod16x16 artifact;
15. the examples — ``examples/torch/{quickstart,classify_nodes,
   serve_embeddings,distributed_walks,train_lm_on_walks,
   serve_decode}.py`` on the card in subprocesses started together
   (``distributed_walks.py`` at world 1), ``train_lm_on_walks.py
   --arch jamba-v0.1-52b`` (attention, Mamba and MoE layers at its smoke
   size) and ``--arch llama-3.2-vision-11b``, and ``serve_decode.py
   --arch seamless-m4t-medium`` (the cross-attention archs with the
   examples' zero memory); each must exit 0.

It prints the card's name and power limit, the build seconds, the
registers and spills of the walk kernels and the tensor-core kernel,
walker-steps per second for each walk phase, prefill tokens/s and decode
ms/token (paths E, J, K and L), path L's shares and peaks, path J's
dropped assignments, path F's
latency quantiles, QPS, hit rate, occupancy, refresh
host ms and device-busy share, LM training's ms/step, tokens/s, peak
memory and busy share, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.

    python3 chip_smoke.py --walks

runs phase 3 alone and prints its kernel times as one JSON line: copied
into a checkout of another commit, it times that commit's walk kernel on
the same inputs. Whatever the script started is stopped when it exits.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
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
INT32_OPS_PER_S = 16.7e12       # H100 SXM: 132 SMs x 64 int32 lanes x 1.98 GHz
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 dense tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/node2vec_step.cu"
SGNS_SOURCE = "src/repro_torch/kernels/csrc/sgns.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
FLASH_SIMT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
THREEFRY_SOURCE = "src/repro_torch/kernels/csrc/threefry.cu"
KERNEL_LIBS = ("node2vec_step", "sgns", "flash_attention",
               "flash_attention_sm90", "threefry")
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
C_PROFILE_WALKERS = 35          # ~50 optimizer steps at length 80
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
I_LAYERS = 2                    # path I: yi-6b's widths, depth 32 -> 2
I_BATCH, I_SEQ = 8, 1024
I_STEPS = 20
I_LR = 3e-4                     # the launcher's default
I_CPU_SEQ = 128                 # I1: B=1 at full width, card vs CPU
I_SMOKE_STEPS = 5               # I1: AdamW steps at the smoke config
I_TOL = 1e-4                    # I1: relative, losses and grad norms
I_PROFILE_STEPS = 3
I_WORK = ROOT / "build" / "chip_smoke_i"     # path I's checkpoints
J_MAMBA, J_MOE = "mamba2-370m", "phi3.5-moe-42b-a6.6b"
J_MOE_LAYERS = 2                # phi3.5-moe at published widths, 32 -> 2
J_BATCH, J_SEQ, J_GEN = 4, 4096, 32
J_STEP_LAYERS, J_STEP_TOL = 2, 2e-3   # chunked == stepwise, f32, 2 layers
J_CPU_SEQ = 512                 # J1: card vs CPU at B=1, 2 layers, f32
J2_CPU_SEQ = 128                # J2: card vs CPU at B=1, 1 layer, f32
J_TIE = 1e-5                    # router probabilities nearer than this tie
J_PROFILE_STEPS = 8
J3_STEPS = 6                    # --task lm --arch mamba2-370m, full depth
J3_SAVE = 3                     # J3's first run checkpoints here
J_WORK = ROOT / "build" / "chip_smoke_j"     # J3's checkpoint
K_SEAMLESS = "seamless-m4t-medium"     # K1: whole, published widths
K_VISION, K_VISION_LAYERS = "llama-3.2-vision-11b", 5   # K2: 40 -> 5
K_CPU_LAYERS, K_CPU_SEQ = 2, 256       # K1: card vs CPU, 2 + 2 layers, f32
K3_BATCH, K3_SEQ, K3_STEPS = 8, 256, 5
K_PROFILE_STEPS = 8
L_ARCH = "jamba-v0.1-52b"       # L2: published widths, one superblock
L_SEQ, L_GEN = 4096, 8          # L2: B=1 prefill, then 8 greedy steps
L_SHARE_MAX = 1.05              # L1: max(t_compute, t_memory) / measured
L_INIT_SLACK = 1e9              # L2: init peak - params - largest f32 leaf
L_CELL = ("yi-6b", "train_4k")  # L3: one production cell, no device
# (script, arguments; None: a checkpoint dir of the phase's own), each on
# the card in its own process
EXAMPLES = (("quickstart", []), ("classify_nodes", []),
            ("serve_embeddings", []), ("distributed_walks", None),
            ("train_lm_on_walks", []),
            ("train_lm_on_walks", ["--arch", "jamba-v0.1-52b"]),
            ("train_lm_on_walks", ["--arch", "llama-3.2-vision-11b"]),
            ("serve_decode", []),
            ("serve_decode", ["--arch", "seamless-m4t-medium"]))
EXAMPLES_WAIT_S = 300
F_REQUESTS = 3_000              # serve_graph --full replays 50,000
F_WINDOW, F_K = 10, 10
F_PROFILED = 1_500              # requests of path F traced for busy share
F_SAMPLE = 4_096                # gate (a)'s walkers beside the buckets
F_EMBED_TOL = 1e-6              # served embed vs plain: reductions only
F_SMALL_SPEC = "wec:k=13,deg=100,seed=0"
G_CPU_STEPS = 100               # G1's card-vs-CPU gate after these steps
G_CPU_TOL = 2e-4
# G1's control: the CPU trainer with each row gradient rounded once from
# float64 (a change of float rounding, not of the math); lazy row-Adam
# amplifies it to the card's order (PERF.md §6). The card rounds
# more operations differently (transcendentals, the sums in the kernel and
# the scatter), so its gap to the CPU may be a few times the control's; a
# gap past this factor is more than rounding
G_ORDER_FACTOR = 10
G1_WORK = ROOT / "build" / "chip_smoke_g1"   # the CPU worker's files
G1_CPU_THREADS = 4              # its torch threads, beside the card's paths
G1_CPU_WAIT_S = 900             # the longest the script waits for it
G2_SPEC = "wec:k=16,deg=100,seed=0"
G2_ROUNDS = 1                   # the launcher's --rounds, cut from 10
G_BATCH = 65536                 # G2's --sgns-batch
H_WORK = ROOT / "build" / "chip_smoke_h"     # path H's files and init
H_WORLD = 2                     # H2-H4's ranks, both on the one card
H_WAIT_S = 600                  # the longest the script waits for them
H4_SPEC = "wec:k=12,deg=100,seed=0"
H3_ROUNDS = 1                   # H3 trains path C's round 0 (of 2)
TF_W = 1 << 20                  # the threefry check's walkers (the cells')
TF_OPS = 80                     # uint32 operations a threefry evaluation


CHILDREN: list = []             # worker processes, stopped at exit


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


def profiled(torch, run):
    """Run ``run`` once under ``torch.profiler``, tracing the device's
    activity only: returns (wall seconds on the host clock, ending in a
    synchronize; device-busy seconds, the summed time of the device's own
    events; those events grouped by name as (name, calls, microseconds),
    by device time). The events are read from the trace as it stands:
    ``key_averages`` first builds a tree of every event, which costs the
    host tens of seconds at ~10^5 kernels (~200 trainer steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        us = e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA and us > 0:
            calls_us = by_name.setdefault(e.name(), [0, 0.0])
            calls_us[0] += 1
            calls_us[1] += us
    events = sorted(((k, c, us) for k, (c, us) in by_name.items()),
                    key=lambda e: e[2], reverse=True)
    return wall, sum(e[2] for e in events) / 1e6, events


def log_profile(label: str, what: str, wall: float, busy: float,
                events) -> None:
    log(f"profile {label}: {what} {wall:.4f} s under the profiler, device "
        f"busy {busy:.4f} s = {busy / wall:.3f} of the window"
        + ("" if events else " (the trace holds no device time)"))
    for key, calls, us in events[:TOP]:
        log(f"  {us / 1e3:10.3f} ms {calls:7d} calls "
            f"{us / 1e6 / busy:6.3f}  {key[:80]}")


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


def threefry_plain(torch, jr):
    """The main paths' draws written out on ``threefry2x32_plain`` alone
    (eager ops on whatever device the inputs are on): fold_in, split,
    uniform, step_uniforms and random_bits."""
    P, MASK = jr.threefry2x32_plain, jr.MASK

    def fold_in(k, data):
        return torch.stack(P(k[..., 0], k[..., 1], 0, data & MASK), dim=-1)

    def split(k):
        k = k.unsqueeze(-2)
        return torch.stack(P(k[..., 0], k[..., 1], 0,
                             torch.arange(2, device=k.device)), dim=-1)

    def uniform(k):
        o0, o1 = P(k[..., 0], k[..., 1], 0, 0)
        return jr._to_float(o0 ^ o1)

    def step_uniforms(seed, ids, length):
        steps = torch.arange(1, length, device=ids.device)
        keys = fold_in(fold_in(seed, ids)[:, None], steps[None, :])
        return uniform(split(keys)[..., 0, :])

    def random_bits(k, n):
        count = torch.arange(n, device=k.device)
        o0, o1 = P(k[0], k[1], count >> 32, count & MASK)
        return o0 ^ o1
    return fold_in, split, uniform, step_uniforms, random_bits


def check_threefry(np, torch, jr, TF) -> dict:
    """The threefry kernel at the main paths' sizes, ``torch.equal`` to
    :func:`threefry_plain` on the same inputs on the card: a superstep's
    fold_in, split and uniform (split's strided half) at W = 2^20, the
    whole walk's ``step_uniforms`` over [2^20, 79] whole and stage by
    stage, and a shaped draw one past a CHUNK (two launches). Each call's
    device-only time (a CUDA graph), the plain version's (CUDA events), and
    the bound of the bytes the call needs (its operands read once, its
    output written once) and of TF_OPS operations an evaluation at
    INT32_OPS_PER_S."""
    from repro_torch.core.walk import step_uniforms
    fold_in, split, uniform, step_plain, bits_plain = threefry_plain(torch,
                                                                     jr)
    w, n = TF_W, TF_W * (LENGTH - 1)
    seed = jr.PRNGKey(2 ** 31 + 7, device=DEV)
    ids = torch.arange(w, device=DEV)
    wkeys = jr.fold_in(seed, ids)
    half = jr.split(wkeys)[:, 0]
    steps = torch.arange(1, LENGTH, device=DEV)
    grid = jr.fold_in(wkeys[:, None], steps[None, :])
    grid_half = jr.split(grid)[..., 0, :]
    nb = jr.CHUNK + 1
    # name: (kernel, plain, bytes needed, evaluations, launches)
    calls = {
        "fold_in_seed": (lambda: jr.fold_in(seed, ids),
                         lambda: fold_in(seed, ids), 24 * w, w, 1),
        "fold_in": (lambda: jr.fold_in(wkeys, LENGTH // 2),
                    lambda: fold_in(wkeys, LENGTH // 2), 32 * w, w, 1),
        "split": (lambda: jr.split(wkeys), lambda: split(wkeys), 48 * w, w,
                  1),
        "uniform": (lambda: jr.uniform(half), lambda: uniform(half), 20 * w,
                    w, 1),
        "fold_in_grid": (lambda: jr.fold_in(wkeys[:, None], steps[None, :]),
                         lambda: fold_in(wkeys[:, None], steps[None, :]),
                         16 * w + 8 * (LENGTH - 1) + 16 * n, n, 1),
        "split_grid": (lambda: jr.split(grid), lambda: split(grid), 48 * n,
                       n, 1),
        "uniform_grid": (lambda: jr.uniform(grid_half),
                         lambda: uniform(grid_half), 20 * n, n, 1),
        "step_uniforms": (lambda: step_uniforms(seed, ids, LENGTH),
                          lambda: step_plain(seed, ids, LENGTH),
                          8 * w + 4 * n, w + 3 * n, 4),
        "random_bits": (lambda: jr.random_bits(seed, (nb,)),
                        lambda: bits_plain(seed, nb), 8 * nb, nb, 2),
    }
    out = {}
    for name, (kernel, plain, nbytes, evals, launches) in calls.items():
        before = TF.threefry2x32.launches
        got = kernel()
        if TF.threefry2x32.launches - before != launches:
            raise AssertionError(f"threefry {name}: "
                                 f"{TF.threefry2x32.launches - before} "
                                 f"launches, want {launches}")
        want = plain()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"threefry {name}: the kernel differs from "
                                 f"threefry2x32_plain")
        del got, want
        big = evals > 4 * w
        ms = graph_ms(torch, kernel, 5 if big else 50)
        plain_ms = cuda_ms(torch, plain, 1 if big else 5)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = TF_OPS * evals / INT32_OPS_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                     "bound_ms_bytes": b_bytes, "bound_ms_ops": b_ops,
                     "launches": launches}
        log(f"threefry {name} (== plain, {launches} launch(es)): "
            f"{ms:.4f} ms device-only, bound {max(b_bytes, b_ops):.4f} ms "
            f"(bytes {b_bytes:.4f}: {nbytes / 1e6:.1f} MB; operations "
            f"{b_ops:.4f}), plain {plain_ms:.4f} ms")
    torch.cuda.synchronize()
    out["fold_in"]["ms_host"] = cuda_ms(
        torch, lambda: jr.fold_in(wkeys, LENGTH // 2), 50)
    log(f"threefry fold_in at W=2^20, back-to-back calls: "
        f"{out['fold_in']['ms_host']:.4f} ms a call host-inclusive")
    return out


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


def check_loss(np, losses, rounds, label: str, batch: int = 1024) -> None:
    """The loss of a run over ``rounds`` (walk arrays of one shape) is
    finite, has one value a step, and falls within each round: its last 5%
    window at most C_FALL of its first."""
    from repro_torch.train.pairs import num_pairs
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: the loss is not finite")
    # every round has the same shape, so the same number of steps
    per_round = -(-num_pairs(*rounds[0].shape, 10) // batch)
    if len(losses) != len(rounds) * per_round:
        raise AssertionError(f"{label}: {len(losses)} losses for "
                             f"{len(rounds)} rounds of {per_round} steps")
    for r, part in enumerate(losses.reshape(len(rounds), per_round)):
        win = max(1, per_round // 20)
        curve = [float(part[i:i + win].mean())
                 for i in range(0, per_round - win + 1, win)]
        log(f"{label}: round {r} loss over 5% windows: "
            f"{' '.join(f'{x:.4f}' for x in curve)}")
        if not curve[-1] <= C_FALL * curve[0]:
            raise AssertionError(f"{label}: round {r}'s loss ends at "
                                 f"{curve[-1]}, above {C_FALL} x its start "
                                 f"{curve[0]}")


def path_c(np, torch, pg, walkers_every: int = C_EVERY,
           rounds: int = C_ROUNDS, length: int = LENGTH):
    """Main path C: the streamed trainer with the fused SGNS kernel over
    ``rounds`` FN-Multi rounds of fused walks on ``pg``. Returns (trainer,
    the rounds' walks, sgns_fused launches of the run)."""
    from repro_torch.core.skipgram import normalize_embeddings
    from repro_torch.engine import WalkEngine, WalkPlan, round_seed
    from repro_torch.kernels import node2vec_step as K
    from repro_torch.kernels import sgns as S
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
    log(f"C: {len(starts)} walkers x {length} x {rounds} rounds, V={pg.n} "
        f"D=128 K=5 B=1024: {st.steps} steps in {st.wall_seconds:.3f} s = "
        f"{st.steps / st.wall_seconds:.4g} steps/s, "
        f"{st.pairs_per_sec:.4g} pairs/s; sgns_fused launches {launches} "
        f"== steps")
    check_loss(np, trainer.loss_history(), kept, "C")
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


def cut_grid(ST, steps: int):
    """Keep only the first ``steps`` rows of every step grid the trainer
    draws (``train.stream._perm_batches``): its first ``steps`` optimizer
    steps, bit for bit. Returns the function that puts it back."""
    orig = ST._perm_batches

    def cut(*args):
        return orig(*args)[:steps]
    ST._perm_batches = cut

    def done() -> None:
        ST._perm_batches = orig
    return done


def f64_row_grads(SH, S):
    """G1's control: the sharded epoch's row grads
    (``train.shard.sgns_row_grads``) computed in float64 and rounded once
    to float32. Returns the function that puts the float32 ones back."""
    orig = SH.sgns_row_grads

    def f64(ci, po, no, valid, backend):
        return tuple(t.float() for t in S.sgns_fused_plain(
            ci.double(), po.double(), no.double(), valid.double()))
    SH.sgns_row_grads = f64

    def done() -> None:
        SH.sgns_row_grads = orig
    return done


def table_gap(torch, a: dict, b: dict) -> float:
    """Largest |a - b| over both SGNS tables (on the host)."""
    return max(float((a[k].cpu() - b[k].cpu()).abs().max())
               for k in ("emb_in", "emb_out"))


def start_g1_cpu(np, walks, kw: dict):
    """Start G1's CPU half (:func:`g1_cpu`) in a worker process that sees
    no card, on the rounds ``walks`` and the trainer settings ``kw``: it
    trains beside the card's paths and is read by :func:`g1_cpu_gates`."""
    shutil.rmtree(G1_WORK, ignore_errors=True)
    G1_WORK.mkdir(parents=True)
    np.save(G1_WORK / "walks.npy", np.stack(walks))
    (G1_WORK / "kw.json").write_text(json.dumps(kw))
    with open(G1_WORK / "worker.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--g1-cpu",
             str(G1_WORK)], stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "OMP_NUM_THREADS": str(G1_CPU_THREADS),
                 "OMP_WAIT_POLICY": "PASSIVE"})
    CHILDREN.append(proc)
    return proc, time.perf_counter()


def g1_cpu(np, torch, work: Path) -> None:
    """The worker's body: the sharded trainer on the CPU after its first
    G_CPU_STEPS steps and after each round, and the control (the same
    with its row grads rounded once from float64) beside it; writes the
    CPU's tables to ``cpu.pt`` and the control's gaps to the CPU's to
    ``control.json`` in ``work``."""
    from repro_torch.kernels import sgns as S
    from repro_torch.train import shard as SH
    from repro_torch.train import stream as ST
    os.nice(10)          # the card's paths' host threads come first
    torch.set_num_threads(G1_CPU_THREADS)
    kw = json.loads((work / "kw.json").read_text())
    walks = list(np.load(work / "walks.npy"))

    def consume(tr, w, f64: bool) -> None:
        back = f64_row_grads(SH, S) if f64 else (lambda: None)
        try:
            tr.consume(w)
        finally:
            back()
    done = cut_grid(ST, G_CPU_STEPS)
    try:
        cut = {}
        for name in ("cpu", "f64"):
            tr = ST.StreamingSGNSTrainer(**kw, device="cpu")
            consume(tr, walks[0], name == "f64")
            cut[name] = tr.params
    finally:
        done()
    tables = [cut["cpu"]]
    control = [table_gap(torch, cut["f64"], cut["cpu"])]
    cpu = ST.StreamingSGNSTrainer(**kw, device="cpu")
    ctl = ST.StreamingSGNSTrainer(**kw, device="cpu")
    for w in walks:
        consume(cpu, w, False)
        consume(ctl, w, True)
        tables.append(cpu.params)
        control.append(table_gap(torch, ctl.params, cpu.params))
    torch.save(tables, work / "cpu.pt")
    (work / "control.json").write_text(json.dumps(control))


def g1_cpu_gates(torch, g1: dict) -> None:
    """Wait for G1's worker and hold the card's tables to the CPU's: within
    G_CPU_TOL after G_CPU_STEPS steps, and at that reading and after each
    round within G_ORDER_FACTOR of the control's gap to the CPU."""
    proc, started = g1["worker"]
    try:
        rc = proc.wait(timeout=G1_CPU_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"G1: the CPU worker ran past "
                             f"{G1_CPU_WAIT_S} s")
    if rc:
        tail = (G1_WORK / "worker.log").read_text()[-3000:]
        raise AssertionError(f"G1: the CPU worker exited with {rc}:\n{tail}")
    waited = time.perf_counter() - started
    cpu = torch.load(G1_WORK / "cpu.pt")
    control = json.loads((G1_WORK / "control.json").read_text())
    card_gaps = [table_gap(torch, c, t) for c, t in zip(g1["card"], cpu)]
    shutil.rmtree(G1_WORK, ignore_errors=True)
    readings = (f"card vs CPU max |diff| after the first {G_CPU_STEPS} "
                f"steps, then after each round: "
                f"{', '.join(f'{x:.3g}' for x in card_gaps)}; the control "
                f"(the CPU's row grads rounded once from float64) vs CPU: "
                f"{', '.join(f'{x:.3g}' for x in control)}")
    if not card_gaps[0] <= G_CPU_TOL:
        raise AssertionError(f"G1: {readings}: above {G_CPU_TOL} after "
                             f"{G_CPU_STEPS} steps")
    if len(card_gaps) != len(control) or not all(
            g <= G_ORDER_FACTOR * c for g, c in zip(card_gaps, control)):
        raise AssertionError(f"G1: {readings}: the card is more than "
                             f"{G_ORDER_FACTOR}x the control's rounding gap")
    log(f"G1: {readings}; card <= {G_CPU_TOL} after {G_CPU_STEPS} steps "
        f"and <= {G_ORDER_FACTOR}x the control at each reading (the CPU "
        f"worker, {G1_CPU_THREADS} threads, done {waited:.2f} s after it "
        f"started)")


def path_g1(np, torch, walks, dense) -> dict:
    """Path G1: the sharded trainer (lazy row-Adam on each batch's unique
    rows, ``sgns_fused``'s row entry through ``sgns_row_grads``) at path
    C's width over path C's rounds ``walks``; ``dense`` is path C's
    trained dense trainer."""
    from repro_torch.core import skipgram as SG
    from repro_torch.kernels import sgns as S
    from repro_torch.train import stream as ST

    kw = dict(vocab=dense.vocab, dim=128, window=10, negatives=5,
              batch_size=1024, lr=0.025, epochs=1, sgns_backend="fused",
              shard_tables=True)
    worker = start_g1_cpu(np, walks, kw)
    trainer = ST.StreamingSGNSTrainer(**kw, device=DEV)
    # an epoch never writes the tables it is handed, so the tables after
    # each round are kept by reference
    after = []

    def source():
        for r, w in enumerate(walks):
            if r:   # round r - 1 has been trained
                after.append(trainer.params)
            yield w

    S.sgns_fused.launches = 0
    tables = count_calls(SG, "sgns_fused_tables")
    try:
        _, st = trainer.train(source())
    finally:
        table_calls = tables()
    launches = S.sgns_fused.launches
    after.append(trainer.params)
    if launches != st.steps or st.steps == 0 or table_calls:
        raise AssertionError(f"G1: the row entry launched {launches} times "
                             f"for {st.steps} steps, the table entry was "
                             f"called {table_calls} times")
    log(f"G1: sharded (lazy row-Adam), {len(walks[0])} walkers x "
        f"{walks[0].shape[1]} x {len(walks)} rounds, V={dense.vocab} D=128 "
        f"K=5 B=1024, u_in {trainer._u_in} u_out {trainer._u_out}: "
        f"{st.steps} steps in {st.wall_seconds:.3f} s = "
        f"{st.steps / st.wall_seconds:.4g} steps/s; sgns_fused row-entry "
        f"launches {launches} == steps, table entry called 0 times")
    check_loss(np, trainer.loss_history(), walks, "G1")

    t0 = time.perf_counter()
    replay = ST.StreamingSGNSTrainer(**kw, device=DEV)
    replay.consume(walks[0])
    if not all(torch.equal(replay.params[k], after[0][k])
               for k in ("emb_in", "emb_out")):
        raise AssertionError("G1: concat replay of round 0 differs from the "
                             "streamed run")
    log(f"G1: concat replay of round 0 == streamed tables after round 0 "
        f"({time.perf_counter() - t0:.2f} s)")
    del replay

    # the card after its first G_CPU_STEPS steps; the CPU's readings come
    # from the worker started above
    done = cut_grid(ST, G_CPU_STEPS)
    try:
        tr = ST.StreamingSGNSTrainer(**kw, device=DEV)
        tr.consume(walks[0])
    finally:
        done()
    card = [_to_cpu(t) for t in [tr.params] + after]
    del tr
    gap = table_gap(torch, trainer.params, dense.params)
    if not gap > 1e-3:
        raise AssertionError(f"G1: the sharded tables are within {gap} of "
                             f"path C's dense ones")
    log(f"G1: sharded vs dense path C tables: max |diff| {gap:.4g} (lazy "
        f"row-Adam is another optimizer)")

    # sharded and dense in turns on fresh trainers (host rates drift)
    rates = {}
    for name in ("sharded", "dense", "dense", "sharded"):
        tr = ST.StreamingSGNSTrainer(**{**kw, "shard_tables":
                                        name == "sharded"}, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.consume(walks[0][:C_PROFILE_WALKERS])
        tr.loss_history()                       # waits for the last step
        rates.setdefault(name, []).append(
            tr.recorder.steps / (time.perf_counter() - t0))
        del tr
    each = {k: " / ".join(f"{x:.4g}" for x in v) for k, v in rates.items()}
    rates = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"G1: the same {C_PROFILE_WALKERS} walkers of round 0 on fresh "
        f"trainers, in the order sharded, dense, dense, sharded: sharded "
        f"{rates['sharded']:.4g} steps/s ({each['sharded']}), dense "
        f"{rates['dense']:.4g} steps/s ({each['dense']})")
    profile_round(torch, lambda: trainer.consume(
        walks[0][:C_PROFILE_WALKERS]), "G1 sharded SGNS", "~50 steps")
    return {"launches": launches, "steps": st.steps, "rates": rates,
            "worker": worker, "card": card, "kw": kw}


def timed(owner, name: str, calls: dict, label: str):
    """Wrap ``owner.name`` (a module's function or a class's method) so
    that each call appends (host seconds, result) to ``calls[label]``;
    returns the function that puts the original back."""
    raw = vars(owner)[name]
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        calls.setdefault(label, []).append((time.perf_counter() - t0, out))
        return out
    setattr(owner, name, staticmethod(wrapped)
            if isinstance(raw, staticmethod) else wrapped)

    def done() -> None:
        setattr(owner, name, raw)
    return done


def launcher_run(torch, argv) -> dict:
    """``repro_torch.launch.train.main(argv)`` in this process, with the
    host seconds of its stages, the trainer's stats, the checkpoints saved
    and the row entry's launches."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.graph import PaddedGraph
    from repro_torch.data import ingest
    from repro_torch.kernels import sgns as S
    from repro_torch.launch import train as LT
    from repro_torch.train.stream import StreamingSGNSTrainer

    calls: dict = {}
    undo = [timed(ingest, "edgelist_to_csr", calls, "parse and build"),
            timed(ingest, "relabel_by_degree", calls, "relabel"),
            timed(ingest, "save_csr", calls, "cache write"),
            timed(PaddedGraph, "build", calls, "layout build"),
            timed(StreamingSGNSTrainer, "train", calls, "train"),
            timed(Checkpointer, "save", calls, "checkpoint")]
    S.sgns_fused.launches = 0
    t0 = time.perf_counter()
    try:
        emb = LT.main(argv)
        torch.cuda.synchronize()
    finally:
        for fn in undo:
            fn()
    (_, (_, st)), = calls["train"]
    return {"emb": emb, "seconds": time.perf_counter() - t0, "stats": st,
            "launches": S.sgns_fused.launches,
            "saves": len(calls.get("checkpoint", [])),
            "stages": {k: sum(t for t, _ in v) for k, v in calls.items()
                       if k not in ("train", "checkpoint")}}


def path_g2(np, torch, tmp: Path) -> dict:
    """Path G2: the launcher end to end on an on-disk edge list: G2_SPEC
    written once per undirected edge, built with relabel=degree into a
    CSR cache, walked, trained sharded with the row entry, then resumed."""
    from repro_torch.data import ingest
    from repro_torch.data.store import open_graph
    from repro_torch.train.shard import table_rows, unique_rows

    t0 = time.perf_counter()
    g = open_graph(G2_SPEC).graph
    gen = time.perf_counter() - t0
    rows = np.repeat(np.arange(g.n), np.diff(g.row_ptr))
    once = rows < g.col
    text = tmp / "edges.txt"
    t0 = time.perf_counter()
    ingest.write_edgelist(str(text), rows[once], g.col[once], g.wgt[once])
    write_s = time.perf_counter() - t0
    spec = f"edgelist:{text},relabel=degree"
    cache, ckpt = tmp / "cache", tmp / "ckpt"
    argv = ["--task", "node2vec", "--graph", spec, "--graph-cache",
            str(cache), "--p", "1", "--q", "0.5",
            "--rounds", str(G2_ROUNDS),
            "--walk-length", str(LENGTH), "--dim", "128", "--window", "10",
            "--negatives", "5", "--sgns-batch", str(G_BATCH),
            "--sgns-backend", "fused", "--shard-tables", "--ckpt-dir",
            str(ckpt), "--device", DEV]
    log(f"G2: {G2_SPEC} (n={g.n}, m={g.m}, generated in {gen:.2f} s) "
        f"written as {int(once.sum())} undirected lines "
        f"({text.stat().st_size} bytes) in {write_s:.2f} s host; "
        f"launcher: {' '.join(argv)}")
    first = launcher_run(torch, argv)

    # the cache holds relabel_by_degree of the in-memory graph
    sub, = (p for p in cache.iterdir() if p.is_dir())
    want, perm = ingest.relabel_by_degree(g)
    for name, arr in (("indptr", want.row_ptr), ("col", want.col),
                      ("wgt", want.wgt), ("perm", perm)):
        got = np.load(sub / f"{name}.npy")
        if got.dtype != arr.dtype or not np.array_equal(got, arr):
            raise AssertionError(f"G2: the cached {name}.npy differs from "
                                 f"relabel_by_degree of {G2_SPEC}")
    builders = [count_calls(ingest, "edgelist_to_csr"),
                count_calls(ingest, "relabel_by_degree")]
    t0 = time.perf_counter()
    try:
        hit = open_graph(spec, cache_dir=str(cache))
    finally:
        built = sum(done() for done in builders)
    open_ms = (time.perf_counter() - t0) * 1e3
    if built or not isinstance(hit.graph.col, np.memmap) or \
            not isinstance(hit.graph.row_ptr, np.memmap):
        raise AssertionError(f"G2: the cached open called a builder "
                             f"{built} times or gave arrays not "
                             f"memmap-backed")
    del hit

    st, emb = first["stats"], first["emb"]
    if first["launches"] != st.steps or st.steps == 0:
        raise AssertionError(f"G2: the row entry launched "
                             f"{first['launches']} times for {st.steps} "
                             f"steps")
    saved = np.load(ckpt / "embeddings.npy")
    norms = np.linalg.norm(saved, axis=1)
    if saved.shape != (g.n, 128) or not np.all(np.isfinite(saved)) or \
            not np.allclose(norms, 1.0, rtol=0, atol=1e-5) or \
            not np.array_equal(saved, emb):
        raise AssertionError(f"G2: embeddings.npy {saved.shape} not finite "
                             f"and unit-norm (|norm - 1| up to "
                             f"{float(np.abs(norms - 1).max())})")
    again = launcher_run(torch, argv)
    resumed = np.load(ckpt / "embeddings.npy")
    if again["saves"] or first["saves"] != G2_ROUNDS or \
            again["launches"] != again["stats"].steps or \
            not np.array_equal(resumed, saved):
        raise AssertionError(f"G2: the resumed run saved {again['saves']} "
                             f"checkpoints (the first {first['saves']}) or "
                             f"wrote other embeddings")
    u_in = unique_rows(G_BATCH, table_rows(g.n, 1))
    u_out = unique_rows(G_BATCH * 6, table_rows(g.n, 1))
    stages = {"text write": write_s, **first["stages"],
              "cached open": open_ms / 1e3,
              "walks (exposed)": st.walk_wait_seconds,
              "training": st.train_seconds}
    log(f"G2: host seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f"; the launcher {first['seconds']:.2f} s in all")
    log(f"G2: cached open {open_ms:.1f} ms host, no builder called, "
        f"memmap-backed; cache == relabel_by_degree of {G2_SPEC} (indptr, "
        f"col, wgt, perm)")
    log(f"G2: {st.steps} steps in {st.train_seconds:.3f} s = "
        f"{st.steps / st.train_seconds:.4g} steps/s, {st.pairs_per_sec:.4g} "
        f"pairs/s; row-entry launches {first['launches']} == steps; "
        f"unique buffers u_in {u_in} ({u_in * 128 * 4} bytes a table "
        f"buffer), u_out {u_out} ({u_out * 128 * 4} bytes, "
        f"{u_out / g.n:g}x the vocab)")
    log(f"G2: embeddings.npy {saved.shape}, finite, unit norm within "
        f"{float(np.abs(norms - 1).max()):.3g}; resumed from {G2_ROUNDS} "
        f"checkpointed round(s) (0 saved, {again['launches']} launches, "
        f"{again['seconds']:.2f} s, stages " + ", ".join(
            f"{k} {v:.3f}" for k, v in again["stages"].items())
        + "): the same embeddings.npy")
    return {"launches": first["launches"], "steps": st.steps,
            "stages": stages}


def h_plan(mode: str = "exact", **kw):
    """Path H's walk plan: path A's, on the sharded backend."""
    from repro_torch.engine import WalkPlan
    return WalkPlan(p=1.0, q=0.5, length=LENGTH, cap=128, mode=mode,
                    backend="sharded", **kw)


def h4_argv(ckpt: Path) -> list:
    """H4's launcher command (G2's settings on H4_SPEC's generated graph);
    the card is the default device."""
    return ["--task", "node2vec", "--graph", H4_SPEC, "--p", "1", "--q",
            "0.5", "--rounds", "1", "--walk-length", str(LENGTH), "--dim",
            "128", "--window", "10", "--negatives", "5", "--sgns-batch",
            str(G_BATCH), "--sgns-backend", "fused", "--shard-tables",
            "--ckpt-dir", str(ckpt)]


def sha1(np, a) -> str:
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def path_h1(np, torch, pg, a_walks: dict) -> dict:
    """H1: the sharded backend in a world of one over NCCL on path A's
    layout, exact and approx: the walks must equal path A's fused walks of
    the same seed, with no drop."""
    import torch.distributed as dist
    from repro_torch.engine import WalkEngine, round_seed

    H_WORK.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{H_WORK}/h1",
                            rank=0, world_size=1)
    out = {}
    try:
        for mode in ("exact", "approx"):
            eng = WalkEngine.build(pg, h_plan(mode))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run(seed=round_seed(0, 0))
            secs = time.perf_counter() - t0
            if res.stats.dropped or \
                    not np.array_equal(res.walks, a_walks[mode]):
                raise AssertionError(
                    f"H1/{mode}: {res.stats.dropped} drops, walks equal to "
                    f"path A's: {np.array_equal(res.walks, a_walks[mode])}")
            steps = res.walks.size
            log(f"H1/{mode}: sharded, world 1 over "
                f"{dist.get_backend(eng.mesh.group)}, capacity "
                f"{eng.capacity}: {steps / secs:.4g} walker-steps/s "
                f"({secs:.3f} s); == path A's fused walks; dropped 0")
            profile_round(torch, lambda: eng.run(seed=1), f"H1/{mode} sharded")
            out[mode] = steps / secs
    finally:
        dist.destroy_process_group()
    return out


def timed_exchanges(torch, WD):
    """Wrap ``walk_distributed._all_to_all`` so each call (and the wait of
    its handle) is timed from a synchronized card; returns a function that
    puts it back and returns (seconds, calls)."""
    orig, acc = WD._all_to_all, [0.0, 0]

    def run(group, x, async_op=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, work = orig(group, x, False)
        torch.cuda.synchronize()
        acc[0] += time.perf_counter() - t0
        acc[1] += 1
        return out, None
    WD._all_to_all = run

    def done():
        WD._all_to_all = orig
        return acc[0], acc[1]
    return done


def h_rank(np, torch, rank: int, work: Path) -> None:
    """The body of one of path H's two processes (``python3 chip_smoke.py
    --h-rank R DIR``): both on the one card in a gloo world (NCCL refuses
    two ranks on one card). H2 walks path A's layout sharded (barrier,
    pipelined, and at capacity "auto" with each exchange timed), H3 trains
    path G1's sharded trainer on path C's round 0, H4 runs the launcher;
    each rank writes what it saw to ``rank<R>.json``."""
    import datetime
    import warnings
    import torch.distributed as dist
    from repro_torch.core import walk_distributed as WD
    from repro_torch.core.graph import PaddedGraph
    from repro_torch.engine import WalkEngine, round_seed
    from repro_torch.kernels import build
    from repro_torch.kernels import sgns as S
    from repro_torch.launch import train as LT
    from repro_torch.train.stream import StreamingSGNSTrainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/init",
                            rank=rank, world_size=H_WORLD,
                            timeout=datetime.timedelta(seconds=H_WAIT_S))
    res: dict = {"rank": rank}
    try:
        build.load_all(("sgns",))
        z = np.load(work / "layout.npz")
        pg = PaddedGraph.from_numpy({k: z[k] for k in z.files}, z["n"],
                                    DEV)
        del z
        for name, kw in (("barrier", {}), ("pipeline", {"pipeline": True}),
                         ("auto", {"capacity": "auto"})):
            eng = WalkEngine.build(pg, h_plan(**kw))
            dist.barrier()
            torch.cuda.synchronize()
            timer = timed_exchanges(torch, WD) if name == "auto" else None
            t0 = time.perf_counter()
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    r = eng.run(seed=round_seed(0, 0))
            finally:
                exch = timer() if timer else None
            secs = time.perf_counter() - t0
            res[name] = {"seconds": secs, "sha1": sha1(np, r.walks),
                         "shape": list(r.walks.shape),
                         "dropped": r.stats.dropped,
                         "capacity": eng.capacity,
                         "collective_bytes": r.stats.collective_bytes,
                         "exposed_bytes": r.stats.exposed_collective_bytes,
                         "exchange": exch}
            del eng, r
        del pg
        torch.cuda.empty_cache()

        walks = list(np.load(work / "c_walks.npy"))[:H3_ROUNDS]
        kw = json.loads((work / "g1_kw.json").read_text())
        S.sgns_fused.launches = 0
        dist.barrier()
        trainer = StreamingSGNSTrainer(**kw, device=DEV)
        t0 = time.perf_counter()
        _, st = trainer.train(iter(walks))
        tables = {k: v.cpu().numpy() for k, v in trainer.tables().items()}
        res["h3"] = {"seconds": time.perf_counter() - t0,
                     "steps": st.steps, "launches": S.sgns_fused.launches,
                     "shards": st.shards, "u": [trainer._u_in,
                                               trainer._u_out],
                     "sha1": sha1(np, np.stack([tables["emb_in"],
                                               tables["emb_out"]]))}
        if rank == 0:
            np.save(work / "h3_tables.npy",
                    np.stack([tables["emb_in"], tables["emb_out"]]))
            np.save(work / "h3_losses.npy", trainer.loss_history())
        del trainer, tables
        torch.cuda.empty_cache()

        S.sgns_fused.launches = 0
        dist.barrier()
        t0 = time.perf_counter()
        emb = LT.main(h4_argv(work / "h4_two"))
        res["h4"] = {"seconds": time.perf_counter() - t0,
                     "sha1": sha1(np, emb), "launches":
                     S.sgns_fused.launches}
    finally:
        (work / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def path_h(np, torch, pg, a_walks: dict, c_walks, g1_kw: dict,
           g1_tables: dict) -> dict:
    """Path H: the sharded (Pregel) backend and the sharded tables across
    ``torch.distributed`` worlds on the one card. H1 in this process
    (world 1, NCCL); H2-H4 in two processes started here (world 2, gloo),
    each gated against the world-1 results."""
    shutil.rmtree(H_WORK, ignore_errors=True)
    H_WORK.mkdir(parents=True)
    t_h = time.perf_counter()
    h1 = path_h1(np, torch, pg, a_walks)
    t0 = time.perf_counter()
    fields = {k: getattr(pg, k).cpu().numpy() for k in (
        "adj", "wgt", "deg", "alias_p", "alias_i", "w_min", "w_max",
        "hot_pos", "hot_ids", "hot_adj", "hot_wgt", "hot_alias_p",
        "hot_alias_i")}
    np.savez(H_WORK / "layout.npz", n=pg.n, **fields)
    del fields
    np.save(H_WORK / "c_walks.npy", np.stack(c_walks))
    (H_WORK / "g1_kw.json").write_text(json.dumps(g1_kw))
    log(f"H: path A's layout and path C's walks written for the ranks in "
        f"{time.perf_counter() - t0:.2f} s host")

    from repro_torch.kernels import sgns as S
    S.sgns_fused.launches = 0
    t0 = time.perf_counter()
    from repro_torch.launch import train as LT
    one = LT.main(h4_argv(H_WORK / "h4_one"))
    h4_one_s, h4_one_launches = time.perf_counter() - t0, \
        S.sgns_fused.launches

    t0 = time.perf_counter()
    procs = []
    for r in range(H_WORLD):
        with open(H_WORK / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--h-rank",
                 str(r), str(H_WORK)], stdout=out, stderr=subprocess.STDOUT))
    CHILDREN.extend(procs)
    try:
        codes = [p.wait(timeout=H_WAIT_S) for p in procs]
    except subprocess.TimeoutExpired:
        codes = [p.poll() for p in procs]
    ranks_s = time.perf_counter() - t0
    if codes != [0] * H_WORLD:
        for r in range(H_WORLD):
            log(f"H rank {r} log (tail):\n" + "".join(
                (H_WORK / f"rank{r}.log").read_text().splitlines(True)[-40:]))
        raise AssertionError(f"H: the ranks exited with {codes}")
    ranks = [json.loads((H_WORK / f"rank{r}.json").read_text())
             for r in range(H_WORLD)]

    want = sha1(np, a_walks["exact"])
    for name in ("barrier", "pipeline"):
        for rk in ranks:
            h = rk[name]
            if h["sha1"] != want or h["dropped"]:
                raise AssertionError(
                    f"H2/{name} rank {rk['rank']}: walks equal to H1's "
                    f"{h['sha1'] == want}, {h['dropped']} drops")
        h = ranks[0][name]
        log(f"H2/{name}: world 2 over gloo on one card, capacity "
            f"{h['capacity']}: {a_walks['exact'].size / h['seconds']:.4g} "
            f"walker-steps/s ({h['seconds']:.3f} s); both ranks' gathered "
            f"walks == H1's; dropped 0; collective_bytes "
            f"{h['collective_bytes']} a rank, exposed {h['exposed_bytes']}")
    auto = ranks[0]["auto"]
    if any(rk["auto"]["sha1"] != auto["sha1"] for rk in ranks):
        raise AssertionError("H2/auto: the ranks' gathered walks differ")
    if auto["dropped"] == 0 and auto["sha1"] != want:
        raise AssertionError("H2/auto: no request dropped, yet the walks "
                             "differ from H1's")
    exch_s, calls = auto["exchange"]
    # the model counts each rank's block to itself, which never leaves the
    # process: (S-1)/S of the bytes cross between the ranks
    cross = auto["collective_bytes"] * (H_WORLD - 1) / H_WORLD
    log(f"H2/auto: capacity {auto['capacity']} (auto), dropped "
        f"{auto['dropped']} ({auto['dropped'] / a_walks['exact'].size:.3g} "
        f"of walker-steps), walks == H1's: {auto['sha1'] == want}; "
        f"{a_walks['exact'].size / auto['seconds']:.4g} walker-steps/s "
        f"({auto['seconds']:.3f} s, each exchange timed); collective_bytes "
        f"{auto['collective_bytes']} a rank beside the exchange measured "
        f"on rank 0 (each all_to_all from a synchronized card): "
        f"{exch_s:.3f} s in {calls} calls; modelled bytes that cross "
        f"between the ranks ({H_WORLD - 1}/{H_WORLD} of them) over the "
        f"measured time {cross / exch_s / 1e9:.3f} GB/s")

    tables = np.load(H_WORK / "h3_tables.npy")
    losses = np.load(H_WORK / "h3_losses.npy")
    for rk in ranks:
        h = rk["h3"]
        if h["launches"] != h["steps"] or h["steps"] == 0 or \
                h["shards"] != H_WORLD or h["sha1"] != ranks[0]["h3"]["sha1"]:
            raise AssertionError(f"H3 rank {rk['rank']}: {h}")
    check_loss(np, losses, c_walks[:H3_ROUNDS], "H3")
    for i, k in enumerate(("emb_in", "emb_out")):
        if not torch.equal(torch.from_numpy(tables[i]), g1_tables[k]):
            raise AssertionError(f"H3: the world-2 {k} differs from G1's "
                                 f"world-1 table after round 0")
    h = ranks[0]["h3"]
    log(f"H3: G1's sharded trainer at world 2 (gloo, one card): "
        f"{h['steps']} steps in {h['seconds']:.3f} s = "
        f"{h['steps'] / h['seconds']:.4g} steps/s, u_in/u_out {h['u']}; "
        f"row-entry launches {[rk['h3']['launches'] for rk in ranks]} == "
        f"steps on each rank; tables torch.equal G1's world-1 tables after "
        f"round 0")

    saved = np.load(H_WORK / "h4_two" / "embeddings.npy")
    if not np.array_equal(saved, one) or \
            any(rk["h4"]["sha1"] != sha1(np, one) for rk in ranks):
        raise AssertionError("H4: the world-2 launcher's embeddings differ "
                             "from world 1's")
    log(f"H4: launch.train.main {' '.join(h4_argv(Path('DIR')))}: world 1 "
        f"{h4_one_s:.2f} s ({h4_one_launches} row-entry launches), world 2 "
        f"{ranks[0]['h4']['seconds']:.2f} s "
        f"({[rk['h4']['launches'] for rk in ranks]} a rank); embeddings.npy "
        f"{saved.shape} equal")
    log(f"H: the two ranks took {ranks_s:.1f} s from their start; path H "
        f"{time.perf_counter() - t_h:.1f} s in all")
    shutil.rmtree(H_WORK, ignore_errors=True)
    return {"h1": h1, "launches": [rk["h3"]["launches"] for rk in ranks],
            "steps": ranks[0]["h3"]["steps"]}


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


def flash_flops(b: int, s: int, h: int, dh: int, causal: bool = True) -> int:
    """4 * dh flops for each unmasked (query, key) pair of a head: s (s +
    1) / 2 of them causal, s * s bidirectional."""
    return 4 * b * h * dh * (s * (s + 1) // 2 if causal else s * s)


def flash_bound(b: int, s: int, h: int, kv: int, dh: int,
                causal: bool = True):
    """Least time for bf16 attention: q, k, v read once and o written once,
    against :func:`flash_flops` at the bf16 tensor-core rate."""
    nbytes = 2 * b * s * dh * (2 * h + 2 * kv)
    return bound_ms(nbytes, flash_flops(b, s, h, dh, causal), BF16_OPS_PER_S)


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


def sdpa_ms(torch, q, k, v, reps: int, causal: bool = True) -> float:
    """PyTorch's fused attention on the same inputs (the yardstick): GQA in
    place, causal or not, on a fused backend only (the math backend would
    materialize the scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True), reps)


def serve(torch, M, cfg, params, tokens, gen: int, memory=None):
    """``prefill`` (with ``memory``'s ``frames`` or ``patches`` for the
    cross-attention archs) then ``gen - 1`` greedy ``serve_step``s;
    returns (the logits of every step [gen, B, V], the tokens [B, gen],
    prefill seconds, decode seconds, kernel launches at prefill and at
    decode, each as (total, tensor-core, SIMT), and the caches)."""
    from repro_torch.kernels import flash_attention as FA
    dev = params["embed"]["tok"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    b, s = tokens.shape
    sync()
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_tc = 0
    FA.flash_attention.launches_simt = 0
    t0 = time.perf_counter()
    logits, caches = M.prefill(cfg, params, {"tokens": tokens,
                                             **(memory or {})},
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
            tuple(a - b for a, b in zip(flash_counts(FA), at_prefill)),
            caches)


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, toks, t_pre, t_dec, launches, dec_launches, _ = serve(
        torch, M, cfg, params, tokens, E_GEN + 1)
    peak = torch.cuda.max_memory_allocated()
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
    card_vs_cpu(torch, M, cfg32, params, prompt, "E")
    del params
    r["launches_tc"], r["launches_simt"] = by_route
    r["warm_s"], r["peak_bytes"] = warm, peak
    return launches, max(err, err_long), r


def lm_args(torch, ckpt: Path, steps: int):
    """The LM launcher's arguments for path I (its parser's defaults but
    these), on the card."""
    from repro_torch.launch import train as LT
    args = LT.parser().parse_args([
        "--task", "lm", "--arch", E_ARCH, "--batch", str(I_BATCH),
        "--seq", str(I_SEQ), "--steps", str(steps), "--lr", str(I_LR),
        "--log-every", "1", "--ckpt-dir", str(ckpt)])
    args.device = torch.device(DEV)
    return args


def _leaves(tree):
    return [x for k in sorted(tree) for x in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def i1_card_vs_cpu(np, torch, cfg, walks) -> dict:
    """I1: one ``loss_fn`` and its grads' global norm at yi-6b's width in
    float32 (B=1, S=128) on the card and on the CPU from the same params;
    then ``I_SMOKE_STEPS`` launcher steps at the smoke config on both.
    Relative gaps, each within ``I_TOL``."""
    import dataclasses
    from repro_torch import random as jr
    from repro_torch.configs import smoke_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.grad_utils import global_norm, value_and_grad
    from repro_torch.optim.optimizers import adamw

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    seqs = torch.from_numpy(walks_to_lm_tokens(walks % cfg.vocab,
                                               I_CPU_SEQ + 1)[:1])
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    params = M.init_params(cfg32, jr.PRNGKey(0), DEV)
    out = {}
    for name in ("card", "cpu"):
        if name == "cpu":
            params = _to_cpu(params)
            torch.cuda.empty_cache()
        dev = params["embed"]["tok"].device
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p, b: M.loss_fn(cfg32, p, b), params,
            {k: v.to(dev) for k, v in batch.items()})
        out[name] = (float(loss), float(global_norm(grads)),
                     time.perf_counter() - t0)
        del grads
    del params
    gap = (rel(out["card"][0], out["cpu"][0]),
           rel(out["card"][1], out["cpu"][1]))
    log(f"I1: {cfg.name} width, float32, B=1 S={I_CPU_SEQ}: loss card "
        f"{out['card'][0]!r} CPU {out['cpu'][0]!r} (rel {gap[0]:.3g}), "
        f"grad global norm card {out['card'][1]!r} CPU {out['cpu'][1]!r} "
        f"(rel {gap[1]:.3g}; tolerance {I_TOL}); loss + grads "
        f"{out['card'][2]:.3f} s card, {out['cpu'][2]:.3f} s CPU host")
    if not max(gap) <= I_TOL:
        raise AssertionError(f"I1: card and CPU disagree at full width: "
                             f"{gap}")

    small = smoke_config(cfg.name)
    opt = adamw(I_LR)
    rng = np.random.default_rng(0)
    toks = walks_to_lm_tokens(walks % small.vocab, 65)
    batches = [toks[rng.integers(0, toks.shape[0], 4)]
               for _ in range(I_SMOKE_STEPS)]
    p_card = M.init_params(small, jr.PRNGKey(0), DEV)
    runs = {}
    for name, p in (("card", p_card), ("cpu", _to_cpu(p_card))):
        dev = p["embed"]["tok"].device
        state = opt.init(p)
        seen = []
        for b in batches:
            t = torch.from_numpy(b).to(dev)
            p, state, loss, gnorm = lm_train_step(
                small, opt, p, state, {"tokens": t[:, :-1],
                                       "labels": t[:, 1:]})
            seen.append((float(loss), float(gnorm)))
        runs[name] = seen
    smoke_gap = max(rel(a, b) for ca, cc in zip(runs["card"], runs["cpu"])
                    for a, b in zip(ca, cc))
    log(f"I1: {small.name} smoke config, {I_SMOKE_STEPS} AdamW steps: "
        f"losses card {[x for x, _ in runs['card']]}, CPU "
        f"{[x for x, _ in runs['cpu']]}; largest relative gap of losses and "
        f"grad norms {smoke_gap:.3g} (tolerance {I_TOL})")
    if not smoke_gap <= I_TOL:
        raise AssertionError(f"I1: smoke steps differ, {smoke_gap}")
    return {"loss_gap": gap[0], "gnorm_gap": gap[1], "smoke_gap": smoke_gap}


def kernel_counts(K, S, FA) -> tuple:
    return (K.node2vec_step.launches, K.node2vec_walk.launches,
            S.sgns_fused.launches, FA.flash_attention.launches)


def path_i(np, torch, walks) -> dict:
    """Path I: LM training at yi-6b's full width cut to ``I_LAYERS``
    layers, through the launcher's ``run_lm`` on path A's walks: I1 card vs
    CPU; I2 ``I_STEPS`` steps (checkpointed at the end), the loss
    falling, and a profiled window of ``I_PROFILE_STEPS`` more steps.
    Runs none of the four kernels."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import node2vec_step as K
    from repro_torch.kernels import sgns as S
    from repro_torch.launch import train as LT
    from repro_torch.optim.optimizers import adamw
    cfg = dataclasses.replace(get_config(E_ARCH), num_layers=I_LAYERS)
    log(f"I: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} layers={cfg.num_layers} ({cfg.param_count():,} "
        f"params) dtype={cfg.dtype} params {cfg.param_dtype} "
        f"remat={cfg.remat}")
    r = i1_card_vs_cpu(np, torch, cfg, walks)
    torch.cuda.empty_cache()

    tokens = walks_to_lm_tokens(walks % cfg.vocab, I_SEQ + 1)
    shutil.rmtree(I_WORK, ignore_errors=True)
    before = kernel_counts(K, S, FA)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = LT.run_lm(lm_args(torch, I_WORK, I_STEPS), cfg, tokens)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["peak_gb"] = r["peak_bytes"] / 1e9
    finally:
        shutil.rmtree(I_WORK, ignore_errors=True)
    losses = run["losses"]
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if len(losses) != I_STEPS or not np.isfinite(losses).all() or \
            not tail < head:
        raise AssertionError(f"I2: losses {losses}")
    # steady steps: the steps after the first (every step prints, so each
    # ends after the device finished it)
    dts = np.diff(run["step_end"])
    r["ms_step"] = float(np.median(dts)) * 1e3
    r["ms_step_mean"] = float(np.mean(dts)) * 1e3
    r["tokens_s"] = I_BATCH * I_SEQ / (r["ms_step"] / 1e3)
    log(f"I2: {I_STEPS} steps B={I_BATCH} S={I_SEQ} on path A's walks "
        f"({tokens.shape[0]} sequences): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, mean of the first 5 {head:.4f}, of the last 5 "
        f"{tail:.4f}; ms/step median {r['ms_step']:.2f} (mean "
        f"{r['ms_step_mean']:.2f}, {len(dts)} steady steps) = "
        f"{r['tokens_s']:.6g} tokens/s; peak memory {r['peak_gb']:.2f} GB; "
        f"run {run_s:.2f} s host (init and the 10.4 GB checkpoint "
        f"included)")

    final = (run["params"], run["opt_state"])
    opt = adamw(I_LR)
    rng = np.random.default_rng(1)

    def steps():
        p, st = final
        for _ in range(I_PROFILE_STEPS):
            seqs = torch.from_numpy(tokens[rng.integers(
                0, tokens.shape[0], I_BATCH)]).to(DEV)
            p, st, _, _ = LT.lm_train_step(cfg, opt, p, st, {
                "tokens": seqs[:, :-1], "labels": seqs[:, 1:]})
    wall, busy, events = profiled(torch, steps)
    log_profile("I train", f"{I_PROFILE_STEPS} steps", wall, busy, events)
    r["busy"] = busy / wall
    after = kernel_counts(K, S, FA)
    if after != before:
        raise AssertionError(f"I: LM training launched kernels: {before} "
                             f"-> {after}")
    del final, run
    torch.cuda.empty_cache()
    return r


def zero_counts(K, S, FA) -> None:
    """Every kernel's launch counts to 0, just before a main path runs."""
    K.node2vec_step.launches = 0
    K.node2vec_walk.launches = 0
    S.sgns_fused.launches = 0
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_tc = 0
    FA.flash_attention.launches_simt = 0


def first_layers(params, n: int):
    """The params of a model cut to its first ``n`` superblocks, of the
    decoder and of the encoder where there is one (views)."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}
    return {k: v if k == "embed" else cut(v) for k, v in params.items()}


def card_vs_cpu(torch, M, cfg, params, prompt, label: str,
                memory=None) -> float:
    """``serve`` of ``prompt`` (and ``memory``, a dict of CPU tensors) for
    ``E_CPU_GEN`` greedy tokens with the same float32 params on the card
    and on the CPU: the logits within ``E_CPU_TOL`` (atol and rtol), the
    tokens equal. Returns the largest |diff| of the logits."""
    memory = memory or {}
    card = serve(torch, M, cfg, params, prompt.to(DEV), E_CPU_GEN,
                 {k: v.to(DEV) for k, v in memory.items()})
    host = serve(torch, M, cfg, _to_cpu(params), prompt, E_CPU_GEN, memory)
    gap = float((card[0].cpu() - host[0]).abs().max())
    log(f"{label}: float32 B={prompt.shape[0]} S={prompt.shape[1]}, "
        f"{E_CPU_GEN} greedy tokens: card vs CPU logits max |diff| "
        f"{gap:.3g} (tolerance {E_CPU_TOL} abs + rel; prefill "
        f"{card[2]:.3f} s card, {host[2]:.3f} s CPU); tokens "
        f"{card[1][0].tolist()} on the card, {host[1][0].tolist()} on the "
        f"CPU")
    if not torch.allclose(card[0].cpu(), host[0], atol=E_CPU_TOL,
                          rtol=E_CPU_TOL) or \
            not torch.equal(card[1].cpu(), host[1]):
        raise AssertionError(f"{label}: card and CPU disagree in float32")
    return gap


def j_serve(np, torch, K, S, FA, M, cfg, params, tokens, label: str,
            memory=None):
    """J's (and K's) main path for one arch: every count set to 0, then
    ``prefill`` of ``tokens`` (and ``memory``) and ``J_GEN`` greedy
    ``serve_step``s; the counts read just after. Then a second (warm)
    prefill, whose logits must be ``torch.equal`` to the first's. Logs
    prefill tokens/s (cold and warm), decode ms/token and peak memory;
    returns ``serve``'s tuple, the counts (step, walk, sgns) and the warm
    prefill's seconds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(K, S, FA)
    out = serve(torch, M, cfg, params, tokens, J_GEN + 1, memory)
    others = kernel_counts(K, S, FA)[:3]
    logits, toks, t_pre, t_dec = out[:4]
    if not bool(torch.isfinite(logits).all()) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        raise AssertionError(f"{label}: non-finite logits or tokens out "
                             f"of range")
    b, s = tokens.shape
    log(f"{label}: prefill B={b} S={s}: {t_pre:.4f} s = "
        f"{b * s / t_pre:.6g} tokens/s; decode {J_GEN} steps: "
        f"{t_dec / J_GEN * 1e3:.4f} ms/token; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"(step, walk, sgns) {others}, flash (total, tensor-core, SIMT) "
        f"{out[4]} at prefill, {out[5]} at decode; tokens "
        f"{toks[0, :8].tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = M.prefill(cfg, params, {"tokens": tokens, **(memory or {})},
                         max_len=s + J_GEN + 1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if not torch.equal(again, logits[0]):
        raise AssertionError(f"{label}: two prefills differ")
    log(f"{label}: a second (warm) prefill {warm:.4f} s = "
        f"{b * s / warm:.6g} tokens/s, its logits torch.equal the first's")
    return out, others, warm


def path_j1(np, torch, K, S, FA, walks) -> dict:
    """J1: mamba2-370m whole (48 layers at published widths): prefill B=4 x
    S=4,096 and 32 greedy steps, none of the four kernels launched;
    profiles; chunked == stepwise and card vs CPU in float32 on its first
    2 layers."""
    import dataclasses
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.models import model as M
    cfg = get_config(J_MAMBA)
    t0 = time.perf_counter()
    params = M.init_params(cfg, jr.PRNGKey(0), DEV)
    torch.cuda.synchronize()
    log(f"J1: {cfg.name} d_model={cfg.d_model} d_inner={cfg.d_inner} "
        f"heads={cfg.ssm_heads} x {cfg.ssm_headdim} state={cfg.ssm_state} "
        f"vocab={cfg.vocab} layers={cfg.num_layers} "
        f"({cfg.param_count():,} params, dtype={cfg.dtype}) initialised on "
        f"the card in {time.perf_counter() - t0:.2f} s host")
    tokens = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, J_SEQ)[:J_BATCH]).to(DEV)
    out, others, warm = j_serve(np, torch, K, S, FA, M, cfg, params,
                                tokens, "J1")
    if others != (0, 0, 0) or out[4] != (0, 0, 0) or out[5] != (0, 0, 0):
        raise AssertionError(f"J1: a kernel launched: {others}, flash "
                             f"{out[4]}, {out[5]}")
    r = {"prefill_tokens_s": J_BATCH * J_SEQ / out[2],
         "warm_tokens_s": J_BATCH * J_SEQ / warm,
         "decode_ms": out[3] / J_GEN * 1e3,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    toks = out[1]
    del out
    wall, busy, events = profiled(torch, lambda: M.prefill(
        cfg, params, {"tokens": tokens}, max_len=J_SEQ + J_GEN + 1))
    log_profile("J1 prefill", "prefill", wall, busy, events)
    r["prefill_busy"] = busy / wall
    _, caches = M.prefill(cfg, params, {"tokens": tokens},
                          max_len=J_SEQ + J_GEN + 1)

    steps = min(J_PROFILE_STEPS, J_GEN)

    def decode():
        tok = toks[:, 0]
        for i in range(steps):
            tok = torch.argmax(M.serve_step(cfg, params, tok, J_SEQ + i,
                                            caches)[0], -1)
    wall, busy, events = profiled(torch, decode)
    log_profile("J1 decode", f"{steps} steps", wall, busy, events)
    r["decode_busy"] = busy / wall
    del caches

    # chunked == stepwise and card vs CPU: float32, the first 2 layers
    cfg32 = dataclasses.replace(cfg, num_layers=J_STEP_LAYERS,
                                dtype="float32")
    p32 = first_layers(params, J_STEP_LAYERS)
    prompt = tokens[:, :256]
    full, _ = M.prefill(cfg32, p32, {"tokens": prompt}, max_len=257)
    part, caches = M.prefill(cfg32, p32, {"tokens": prompt[:, :255]},
                             max_len=257)
    step, _ = M.serve_step(cfg32, p32, prompt[:, 255], 255, caches)
    r["step_gap"] = float((step - full).abs().max())
    log(f"J1: float32, {J_STEP_LAYERS} layers, B={J_BATCH}: prefill(255) + "
        f"serve_step vs prefill(256) logits max |diff| {r['step_gap']:.3g} "
        f"(tolerance {J_STEP_TOL} abs + rel)")
    if not torch.allclose(step, full, atol=J_STEP_TOL, rtol=J_STEP_TOL):
        raise AssertionError("J1: chunked and stepwise disagree")
    cpu_prompt = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, J_CPU_SEQ)[:1])
    r["cpu_gap"] = card_vs_cpu(torch, M, cfg32, p32, cpu_prompt, "J1")
    del params, p32, caches
    torch.cuda.empty_cache()
    return r


def route_recorder(torch, MOE, gaps: bool = False):
    """Wrap ``MOE.route`` to keep each call's routing: (the kept (token,
    expert) pairs, the assigned ones, the ``Routing``, the group's tokens,
    and with ``gaps`` each token's gap between its k-th and (k+1)-th
    router probabilities, computed as ``route`` does). Returns the list it
    appends to and a function that puts the original back."""
    orig, seen = MOE.route, []

    def recorded(cfg, p, xg):
        r = orig(cfg, p, xg)
        gap = None
        if gaps:
            logits = torch.einsum("gtd,de->gte", xg,
                                  p["router"].to(xg.dtype))
            probs = torch.sort(torch.softmax(logits.float(), -1), -1,
                               descending=True).values
            k = cfg.moe_top_k
            gap = (probs[..., k - 1] - probs[..., k]).cpu()
        seen.append((r.sel_valid.sum(), r.top_e.numel(), r, xg.shape[1],
                     gap))
        return r
    MOE.route = recorded

    def done():
        MOE.route = orig
    return seen, done


def drop_shares(seen, layers: int):
    """Per layer, the share of (token, expert) assignments dropped over
    the calls recorded (``layers`` calls per forward)."""
    kept = [0] * layers
    total = [0] * layers
    for i, (k, n, _, _, _) in enumerate(seen):
        kept[i % layers] += int(k)
        total[i % layers] += n
    return [1 - k / n for k, n in zip(kept, total)]


def path_j2(np, torch, K, S, FA, walks) -> dict:
    """J2: phi3.5-moe-42b-a6.6b at published widths cut to 2 layers:
    prefill B=4 x S=4,096 (capacity 2,560) and 32 greedy steps (capacity
    1), ``flash_attention`` twice at prefill on the tensor-core route and
    never at decode, drop shares per layer, two prefills ``torch.equal``;
    the kernel held against its plain version at layer 0's bf16 inputs
    (B=4, S=4,096, 32/8 heads: GQA group 4); then card vs CPU in float32
    on layer 0 (B=1, S=128): logits within 1e-3, routing equal but for
    near-ties."""
    import dataclasses
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.attention import prefill_qkv
    from repro_torch.models.layers import embed_tokens, rms_norm
    cfg = dataclasses.replace(get_config(J_MOE), num_layers=J_MOE_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(cfg, jr.PRNGKey(0), DEV)
    torch.cuda.synchronize()
    log(f"J2: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.head_dim} experts="
        f"{cfg.moe_experts} top-{cfg.moe_top_k} d_ff={cfg.d_ff} capacity "
        f"factor {cfg.capacity_factor} vocab={cfg.vocab} layers="
        f"{cfg.num_layers} ({cfg.param_count():,} params, dtype="
        f"{cfg.dtype}) initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s host; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tokens = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, J_SEQ)[:J_BATCH]).to(DEV)
    seen, done = route_recorder(torch, MOE)
    try:
        out, others, warm = j_serve(np, torch, K, S, FA, M, cfg, params,
                                    tokens, "J2")
    finally:
        done()
    n = cfg.num_layers
    if others != (0, 0, 0) or out[4] != (n, n, 0) or out[5] != (0, 0, 0):
        raise AssertionError(f"J2: launches (step, walk, sgns) {others}, "
                             f"flash {out[4]} at prefill and {out[5]} at "
                             f"decode; want (0, 0, 0), {(n, n, 0)} and "
                             f"(0, 0, 0)")
    caps = sorted({MOE.capacity(cfg, tg) for _, _, _, tg, _ in seen})
    r = {"prefill_tokens_s": J_BATCH * J_SEQ / out[2],
         "warm_tokens_s": J_BATCH * J_SEQ / warm, "warm_s": warm,
         "decode_ms": out[3] / J_GEN * 1e3,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "launches": out[4][0], "launches_tc": out[4][1],
         "drop_prefill": drop_shares(seen[:n], n),
         "drop_decode": drop_shares(seen[n:n * (J_GEN + 1)], n)}
    log(f"J2: assignments dropped per layer at prefill (capacity "
        f"{caps[-1]}) {[round(x, 6) for x in r['drop_prefill']]}, over the "
        f"{J_GEN} decode steps (capacity {caps[0]}) "
        f"{[round(x, 6) for x in r['drop_decode']]}")
    toks = out[1]
    del out, seen
    wall, busy, events = profiled(torch, lambda: M.prefill(
        cfg, params, {"tokens": tokens}, max_len=J_SEQ + J_GEN + 1))
    log_profile("J2 prefill", "prefill", wall, busy, events)
    r["prefill_busy"] = busy / wall
    _, caches = M.prefill(cfg, params, {"tokens": tokens},
                          max_len=J_SEQ + J_GEN + 1)

    steps = min(J_PROFILE_STEPS, J_GEN)

    def decode():
        tok = toks[:, 0]
        for i in range(steps):
            tok = torch.argmax(M.serve_step(cfg, params, tok, J_SEQ + i,
                                            caches)[0], -1)
    wall, busy, events = profiled(torch, decode)
    log_profile("J2 decode", f"{steps} steps", wall, busy, events)
    r["decode_busy"] = busy / wall
    del caches

    # the kernel at layer 0's inputs, the shapes J2's prefill gives it
    blk = {k: v[0] for k, v in params["blocks"]["l0"]["attn"].items()}
    h = rms_norm(embed_tokens(cfg, params["embed"], tokens),
                 params["blocks"]["l0"]["pre_norm"][0])
    q, k, v = prefill_qkv(cfg, blk, h, torch.arange(J_SEQ, device=DEV))
    del h
    tc = FA.flash_attention.launches_tc
    r["flash_err"] = flash_compare(torch, FA, q, k, v, cfg.window, True,
                                   "J2 layer 0", E_FLASH_TOL["bfloat16"])
    if FA.flash_attention.launches_tc - tc != 2:
        raise AssertionError("J2: the layer-0 comparison did not take the "
                             "tensor-core route")
    log(f"J2: flash_attention at layer 0's inputs (q {tuple(q.shape)}, "
        f"k/v {tuple(k.shape)}, {q.dtype}, tensor-core) vs its plain "
        f"version: max |diff| {r['flash_err']:.3g} (atol, rtol "
        f"{E_FLASH_TOL['bfloat16']})")
    del q, k, v, blk

    # card vs CPU: layer 0 in float32, the params made once on the card
    cfg32 = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    p32 = first_layers(params, 1)
    del params
    torch.cuda.empty_cache()
    prompt = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, J2_CPU_SEQ)[:1])
    seen, done = route_recorder(torch, MOE, gaps=True)
    try:
        r["cpu_gap"] = card_vs_cpu(torch, M, cfg32, p32, prompt, "J2")
    finally:
        done()
    # the prefills' routing: the card's first call, the CPU's after the
    # card's E_CPU_GEN calls (a prefill and E_CPU_GEN - 1 steps)
    (_, _, rc, _, gap_c), (_, _, rh, _, gap_h) = seen[0], seen[E_CPU_GEN]
    near = (torch.minimum(gap_c, gap_h) < J_TIE)[0]
    differ = (rc.top_e.cpu() != rh.top_e.cpu()).any(-1)[0]

    def kept(rt):
        return {(e, int(t)) for e in range(cfg.moe_experts)
                for t, ok in zip(rt.sel_idx[0, e].tolist(),
                                 rt.sel_valid[0, e].tolist()) if ok}
    odd = kept(rc) ^ kept(rh)
    r["near_ties"] = int(near.sum())
    log(f"J2: layer 0 float32 B=1 S={J2_CPU_SEQ} (capacity "
        f"{rc.sel_idx.shape[-1]}): tokens routed to other experts on the "
        f"card than on the CPU {int(differ.sum())}, kept (token, expert) "
        f"pairs that differ {len(odd)}; near-ties (a token's k-th and next "
        f"router probabilities within {J_TIE}) {r['near_ties']}")
    if (differ & ~near).any() or any(not near[t] for _, t in odd):
        raise AssertionError("J2: card and CPU route differently outside "
                             "near-ties")
    del p32, seen, rc, rh
    torch.cuda.empty_cache()
    return r


def path_j3(np, torch, walks) -> dict:
    """J3: ``--task lm --arch mamba2-370m`` through the launcher's
    ``run_lm`` at full depth and the launcher's batch (B=8, S=128) on path
    A's walks: ``J3_SAVE`` steps, then a fresh ``run_lm`` resumed from its
    checkpoint to ``J3_STEPS`` (the restored params and AdamW state
    ``torch.equal`` to the saved); the losses and grad norms finite;
    ms/step and tokens/s."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.launch import train as LT

    def args_to(steps: int):
        args = LT.parser().parse_args([
            "--task", "lm", "--arch", J_MAMBA, "--steps", str(steps),
            "--log-every", "1", "--ckpt-dir", str(J_WORK)])
        args.device = torch.device(DEV)
        return args
    args = args_to(J3_STEPS)
    tokens = walks_to_lm_tokens(walks % get_config(J_MAMBA).vocab,
                                args.seq + 1)
    shutil.rmtree(J_WORK, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = LT.run_lm(args_to(J3_SAVE), None, tokens)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = LT.run_lm(args, None, tokens)
        second_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(J_WORK, ignore_errors=True)
    if second["start_step"] != J3_SAVE or second["restored"] is None:
        raise AssertionError(f"J3: the second run started at step "
                             f"{second['start_step']}, want {J3_SAVE}")
    params, state = second["restored"]
    saved = first["opt_state"]
    pairs = list(zip(_leaves(first["params"]) + _leaves(saved.mu)
                     + _leaves(saved.nu) + [saved.count],
                     _leaves(params) + _leaves(state.mu) + _leaves(state.nu)
                     + [state.count]))
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError("J3: the restored (params, opt_state) differ "
                             "from the saved")
    del params, state, saved, pairs
    losses = first["losses"] + second["losses"]
    gnorms = list(first["gnorms"]) + list(second["gnorms"])
    if len(losses) != J3_STEPS or not np.isfinite(losses).all() or \
            not np.isfinite(gnorms).all():
        raise AssertionError(f"J3: losses {losses}, grad norms {gnorms}")
    # steady steps: each run's steps after its first
    dts = np.concatenate([np.diff(run["step_end"])
                          for run in (first, second)])
    r = {"ms_step": float(np.median(dts)) * 1e3}
    r["tokens_s"] = args.batch * args.seq / (r["ms_step"] / 1e3)
    log(f"J3: --task lm --arch {J_MAMBA} "
        f"({get_config(J_MAMBA).num_layers} layers) B={args.batch} "
        f"S={args.seq}, {J3_STEPS} steps: losses {losses}; restored state "
        f"at step {J3_SAVE} torch.equal the saved; ms/step median "
        f"{r['ms_step']:.2f} of {len(dts)} steady steps = "
        f"{r['tokens_s']:.6g} tokens/s; runs {first_s:.2f} s and "
        f"{second_s:.2f} s host (init, the 5 GB checkpoint writes and the "
        f"resume included)")
    del first, second
    torch.cuda.empty_cache()
    return r


def launch_recorder(FA):
    """Wrap ``FA.launch`` to keep the ``causal`` flag of every launch the
    model makes; returns the list it appends to and a function that puts
    the original back."""
    orig, seen = FA.launch, []

    def recorded(which, q, k, v, window=0, causal=True):
        seen.append(bool(causal))
        return orig(which, q, k, v, window, causal)
    FA.launch = recorded

    def done():
        FA.launch = orig
    return seen, done


def k_memory(np, torch, cfg, b: int, seed: int, dev=None) -> dict:
    """``{"frames": ...}`` (encoder-decoder) or ``{"patches": ...}`` (VLM)
    [b, M, d_model] float32, normal(0, 1) from a numpy seed."""
    name = "frames" if cfg.enc_layers else "patches"
    m = cfg.num_audio_frames if cfg.enc_layers else cfg.num_image_tokens
    a = np.random.default_rng(seed).standard_normal(
        (b, m, cfg.d_model), dtype=np.float32)
    return {name: torch.from_numpy(a).to(dev or DEV)}


def k_memory_kv(torch, cfg, params, memory: dict):
    """Each cross layer's (mk, mv) recomputed alone from the memory: the
    encoder's output through ``stack_encode`` (seamless) or the patches
    (llama-vision), in the cache's dtype; as [(superblock, position,
    mk, mv)]."""
    from repro_torch.models import attention as ATT
    from repro_torch.models import model as M
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import dtype_of
    dt = dtype_of(cfg)
    if cfg.enc_layers:
        frames = memory["frames"].to(dt)
        mem = TF.stack_encode(M.encoder_config(cfg), params["encoder"],
                              frames, torch.arange(frames.shape[1],
                                                   device=frames.device))
    else:
        mem = memory["patches"].to(dt)
    out = []
    for i, spec in enumerate(cfg.superblock()):
        if spec.kind not in ("cross_attn", "attn_cross"):
            continue
        name = "xattn" if spec.kind == "attn_cross" else "attn"
        for j in range(cfg.num_superblocks):
            p = {k: v[j] for k, v in params["blocks"][f"l{i}"][name].items()}
            mk, mv = ATT.memory_kv(cfg, p, mem)
            out.append((j, f"l{i}", mk.to(dt), mv.to(dt)))
    return out


def k_flash_layer0(torch, FA, cfg, params, tokens, memory: dict, label: str):
    """The kernel at decoder layer 0's self-attention inputs (causal) and,
    for seamless, at encoder layer 0's (``causal=False``): each held to
    its plain version within path E's bf16 tolerance on the tensor-core
    route, then timed beside its plain version, SDPA and its bound.
    Returns {"decoder"|"encoder": readings}."""
    from repro_torch.models import model as M
    from repro_torch.models.attention import prefill_qkv
    from repro_torch.models.layers import dtype_of, embed_tokens, rms_norm
    sites = []
    blocks = params["blocks"]["l0"]
    h = rms_norm(embed_tokens(cfg, params["embed"], tokens),
                 blocks["pre_norm"][0])
    sites.append(("decoder", cfg, blocks, h, True))
    if cfg.enc_layers:
        enc = params["encoder"]["l0"]
        frames = memory["frames"].to(dtype_of(cfg))
        sites.append(("encoder", M.encoder_config(cfg), enc,
                      rms_norm(frames, enc["pre_norm"][0]), False))
    out = {}
    for name, c, blk, x, causal in sites:
        p = {k: v[0] for k, v in blk["attn"].items()}
        q, k, v = prefill_qkv(c, p, x, torch.arange(x.shape[1],
                                                    device=x.device))
        tc = FA.flash_attention.launches_tc
        err = flash_compare(torch, FA, q, k, v, 0, causal,
                            f"{label} {name} layer 0", E_FLASH_TOL["bfloat16"])
        if FA.flash_attention.launches_tc - tc != 2:
            raise AssertionError(f"{label}: the {name} layer-0 comparison "
                                 f"did not take the tensor-core route")
        b, s_, hh, dh = q.shape
        r = {"err": err, "shape": (b, s_, hh, k.shape[2], dh),
             "causal": causal,
             "ms": cuda_ms(torch, lambda: FA.flash_attention(
                 q, k, v, 0, causal), 20),
             "plain_ms": cuda_ms(torch, lambda: FA.flash_attention_plain(
                 q, k, v, 0, causal), 2),
             "library_ms": sdpa_ms(torch, q, k, v, 20, causal),
             "bound": flash_bound(b, s_, hh, k.shape[2], dh, causal)}
        r["tflops"] = flash_flops(b, s_, hh, dh, causal) / r["ms"] / 1e9
        log(f"{label}: flash_attention at {name} layer 0 (B={b} S={s_} "
            f"H={hh} KV={k.shape[2]} dh={dh} bf16 causal={causal}): "
            f"tensor-core {r['ms']:.4f} ms = {r['tflops']:.1f} TFLOP/s, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"(tensor-core / SDPA {r['ms'] / r['library_ms']:.3f}), bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); max |kernel - "
            f"plain| {err:.3g} (atol, rtol {E_FLASH_TOL['bfloat16']})")
        out[name] = r
        del q, k, v
    torch.cuda.empty_cache()
    return out


def path_k_serve(np, torch, K, S, FA, walks, arch: str, layers=None,
                 label: str = "K") -> dict:
    """K1 / K2: one cross-attention arch at published widths (``layers``
    cuts the depth), bf16 compute, f32 params: ``prefill`` of B=4 x S=4,096
    with seeded memory and ``J_GEN`` greedy ``serve_step``s through
    ``j_serve`` (every count set to 0 just before, read just after), the
    flash launches by ``causal`` flag, the memory caches unchanged by
    decode and equal to ``memory_kv`` recomputed alone, another seed's
    memory changing the logits, profiles, the kernel at layer 0's inputs,
    then float32 card vs CPU."""
    import dataclasses
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, jr.PRNGKey(0), DEV)
    torch.cuda.synchronize()
    r = {"init_s": time.perf_counter() - t0,
         "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "params_gb": sum(v.numel() * 4 for v in _leaves(params)) / 1e9}
    log(f"{label}: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
        f"({cfg.mlp_act}) vocab={cfg.vocab} layers={cfg.num_layers} "
        f"encoder layers={cfg.enc_layers} memory "
        f"{cfg.num_audio_frames if cfg.enc_layers else cfg.num_image_tokens}"
        f" ({cfg.param_count():,} params, {r['params_gb']:.2f} GB f32, "
        f"dtype={cfg.dtype}) initialised on the card in {r['init_s']:.2f} "
        f"s host; peak memory of init {r['init_peak_gb']:.2f} GB")
    tokens = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, J_SEQ)[:J_BATCH]).to(DEV)
    memory = k_memory(np, torch, cfg, J_BATCH, 0)
    seen, done = launch_recorder(FA)
    try:
        out, others, warm = j_serve(np, torch, K, S, FA, M, cfg, params,
                                    tokens, label, memory)
    finally:
        done()
    enc = cfg.enc_layers
    n = cfg.num_superblocks * sum(
        s.kind in ("attn", "attn_cross") for s in cfg.superblock()) + enc
    noncausal = seen[:n].count(False)
    if others != (0, 0, 0) or out[4] != (n, n, 0) or out[5] != (0, 0, 0) \
            or noncausal != enc or len(seen) != 2 * n:
        raise AssertionError(f"{label}: launches (step, walk, sgns) "
                             f"{others}, flash {out[4]} at prefill "
                             f"({noncausal} with causal=False) and {out[5]} "
                             f"at decode, {len(seen)} in two prefills; want "
                             f"(0, 0, 0), {(n, n, 0)} ({enc}), (0, 0, 0), "
                             f"{2 * n}")
    r.update({"prefill_tokens_s": J_BATCH * J_SEQ / out[2],
              "warm_tokens_s": J_BATCH * J_SEQ / warm, "warm_s": warm,
              "decode_ms": out[3] / J_GEN * 1e3,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "launches": out[4][0], "launches_tc": out[4][1],
              "launches_noncausal": noncausal})
    logits, toks, caches = out[0], out[1], out[6]
    del out
    # the memory caches after prefill and J_GEN decode steps: each equal to
    # memory_kv recomputed alone from the memory
    recomputed = k_memory_kv(torch, cfg, params, memory)
    for j, name, mk, mv in recomputed:
        c = caches[name]
        if not (torch.equal(c["mk"][j], mk) and torch.equal(c["mv"][j], mv)):
            raise AssertionError(f"{label}: {name}'s mk/mv of superblock {j} "
                                 f"differ from memory_kv recomputed alone")
    cross = sorted({name for _, name, _, _ in recomputed})
    del recomputed, caches
    other = k_memory(np, torch, cfg, J_BATCH, 1)
    moved, _ = M.prefill(cfg, params, {"tokens": tokens, **other},
                         max_len=J_SEQ + 1)
    r["other_memory_gap"] = float((moved - logits[0]).abs().max())
    log(f"{label}: memory from another seed moves the last-token logits by "
        f"max |diff| {r['other_memory_gap']:.4g}")
    if not r["other_memory_gap"] > 0:
        raise AssertionError(f"{label}: the memory does not reach the "
                             f"logits")
    del moved, other, logits
    batch = {"tokens": tokens, **memory}
    wall, busy, events = profiled(torch, lambda: M.prefill(
        cfg, params, batch, max_len=J_SEQ + J_GEN + 1))
    log_profile(f"{label} prefill", "prefill", wall, busy, events)
    r["prefill_busy"] = busy / wall
    _, caches = M.prefill(cfg, params, batch, max_len=J_SEQ + J_GEN + 1)
    before = [(caches[name]["mk"].clone(), caches[name]["mv"].clone())
              for name in cross]
    steps = min(K_PROFILE_STEPS, J_GEN)

    def decode():
        t = toks[:, 0]
        for i in range(steps):
            t = torch.argmax(M.serve_step(cfg, params, t, J_SEQ + i,
                                          caches)[0], -1)
    wall, busy, events = profiled(torch, decode)
    log_profile(f"{label} decode", f"{steps} steps", wall, busy, events)
    r["decode_busy"] = busy / wall
    if not all(torch.equal(caches[name]["mk"], a) and
               torch.equal(caches[name]["mv"], b)
               for name, (a, b) in zip(cross, before)):
        raise AssertionError(f"{label}: decode wrote the memory caches")
    log(f"{label}: flash launches per prefill {r['launches']} (all "
        f"tensor-core; {noncausal} with causal=False), 0 at decode; mk/mv "
        f"of every cross layer torch.equal memory_kv recomputed alone after "
        f"{J_GEN} decode steps, and torch.equal before and after {steps} "
        f"more")
    del caches, before
    torch.cuda.empty_cache()
    r["flash"] = k_flash_layer0(torch, FA, cfg, params, tokens, memory, label)

    # card vs CPU: float32, the params made once on the card
    cut = K_CPU_LAYERS if enc else cfg.num_superblocks
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=cut * len(cfg.superblock()),
                                enc_layers=cut if enc else 0)
    p32 = first_layers(params, cut)
    del params
    torch.cuda.empty_cache()
    prompt = torch.from_numpy(walks_to_lm_tokens(walks % cfg.vocab,
                                                 K_CPU_SEQ)[:1])
    r["cpu_gap"] = card_vs_cpu(torch, M, cfg32, p32, prompt,
                               f"{label} ({cfg32.num_layers} decoder, "
                               f"{cfg32.enc_layers} encoder layers)",
                               k_memory(np, torch, cfg, 1, 2, "cpu"))
    del p32
    torch.cuda.empty_cache()
    return r


def path_k3(np, torch, K, S, FA, walks) -> dict:
    """K3: ``lm_train_step`` of the launcher on seamless-m4t-medium whole,
    bf16 compute, B=8 x S=256 with seeded frames, ``K3_STEPS`` steps: the
    losses and grad norms finite, every encoder leaf's grad non-zero on
    the first step (its AdamW first moment), none of the four kernels
    launched; ms/step, tokens/s, peak memory and a profile."""
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw
    cfg = get_config(K_SEAMLESS)
    tokens = walks_to_lm_tokens(walks % cfg.vocab, K3_SEQ + 1)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, jr.PRNGKey(0), DEV)
    opt = adamw(I_LR)
    state = opt.init(params)
    frames = [k_memory(np, torch, cfg, K3_BATCH, 10 + i)
              for i in range(K3_STEPS + 2)]
    zero_counts(K, S, FA)
    losses, gnorms, ends = [], [], []
    for step in range(K3_STEPS):
        seqs = torch.from_numpy(tokens[rng.integers(
            0, tokens.shape[0], K3_BATCH)]).to(DEV)
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:],
                 **frames[step]}
        params, state, loss, gnorm = LT.lm_train_step(cfg, opt, params,
                                                      state, batch)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        ends.append(time.perf_counter())
        if step == 0:
            flat = _leaves(state.mu["encoder"])
            dead = sum(not bool(m.abs().max() > 0) for m in flat)
            if not flat or dead:
                raise AssertionError(f"K3: {dead} of the {len(flat)} encoder "
                                     f"leaves have a zero grad on step 1")
    counts = kernel_counts(K, S, FA)
    if counts != (0, 0, 0, 0) or not np.isfinite(losses).all() or \
            not np.isfinite(gnorms).all():
        raise AssertionError(f"K3: launches {counts}, losses {losses}, grad "
                             f"norms {gnorms}")
    dts = np.diff(ends)
    r = {"ms_step": float(np.median(dts)) * 1e3,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    r["tokens_s"] = K3_BATCH * K3_SEQ / (r["ms_step"] / 1e3)
    log(f"K3: lm_train_step on {cfg.name} whole ({cfg.enc_layers} + "
        f"{cfg.num_layers} layers, {cfg.param_count():,} params, bf16, "
        f"AdamW lr {I_LR}) B={K3_BATCH} S={K3_SEQ} with seeded frames "
        f"[{K3_BATCH}, {cfg.num_audio_frames}, {cfg.d_model}]: losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}; every encoder leaf ({len(flat)}) "
        f"has a non-zero grad on step 1; ms/step median {r['ms_step']:.2f} "
        f"of {len(dts)} steady steps = {r['tokens_s']:.6g} tokens/s; peak "
        f"memory {r['peak_gb']:.2f} GB; no kernel launched")

    def steps():
        nonlocal params, state
        for i in range(2):
            seqs = torch.from_numpy(tokens[rng.integers(
                0, tokens.shape[0], K3_BATCH)]).to(DEV)
            params, state, _, _ = LT.lm_train_step(cfg, opt, params, state, {
                "tokens": seqs[:, :-1], "labels": seqs[:, 1:],
                **frames[K3_STEPS + i]})
    wall, busy, events = profiled(torch, steps)
    log_profile("K3 train", "2 steps", wall, busy, events)
    r["busy"] = busy / wall
    del params, state
    torch.cuda.empty_cache()
    return r


def l1_share(torch, label: str, cfg, kind: str, seq: int, batch: int,
             measured_s: float, peak_bytes: int) -> dict:
    """One L1 reading: ``lower_cell`` of the run a path already made (its
    config cut, batch and seq, mesh 1x1) beside that run's time and peak:
    t_compute = counted FLOPs over 989 TFLOP/s, t_memory = ``analytic_bytes``
    (flash's term dropped at prefill) over 3.35 TB/s; the share =
    max(t_compute, t_memory) / measured must lie in (0, L_SHARE_MAX], and
    ``resident_bytes`` (a floor) must not pass the measured peak."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.roofline import analysis as roof
    from repro_torch.roofline import traffic
    cell = lower_cell(cfg, kind, seq, batch, make_test_mesh(1, 1), 1)
    nbytes = traffic.analytic_bytes(cfg, kind, seq, batch,
                                    {"data": 1, "model": 1},
                                    flash_attention=kind == "prefill")
    r = {"flops": cell["flops"],
         "model_flops": roof.model_flops_for(cfg, kind, seq, batch),
         "t_compute": cell["flops"] / roof.PEAK_FLOPS,
         "t_memory": nbytes["total"] / roof.HBM_BW,
         "measured_s": measured_s, "resident_bytes": cell["resident_bytes"],
         "peak_bytes": peak_bytes, "count_s": cell["seconds"]}
    r["share"] = max(r["t_compute"], r["t_memory"]) / measured_s
    # the same with 6ND/2ND, fixed by the config: the counted FLOPs are the
    # port's own work (remat's recompute, MoE capacity slots, training's
    # masked S^2 pairs) and move with the implementation
    r["model_share"] = max(r["model_flops"] / roof.PEAK_FLOPS,
                           r["t_memory"]) / measured_s
    log(f"L1 {label}: {cfg.name} {kind} B={batch} S={seq} "
        f"({cfg.num_layers} layers): counted {r['flops']:.6g} FLOPs "
        f"(6ND/2ND {r['model_flops']:.6g}; on meta in {r['count_s']:.2f} "
        f"s), t_compute {r['t_compute'] * 1e3:.4f} ms at 989 TFLOP/s, "
        f"t_memory {r['t_memory'] * 1e3:.4f} ms ({nbytes['total']:.6g} "
        f"bytes at 3.35 TB/s), measured {measured_s * 1e3:.4f} ms: share "
        f"{r['share']:.4f} (with 6ND/2ND {r['model_share']:.4f}); resident "
        f"{r['resident_bytes'] / 1e9:.3f} GB vs measured peak "
        f"{peak_bytes / 1e9:.3f} GB")
    if not 0 < r["share"] <= L_SHARE_MAX:
        raise AssertionError(f"L1 {label}: share {r['share']} outside (0, "
                             f"{L_SHARE_MAX}]: a miscount")
    if r["resident_bytes"] > peak_bytes:
        raise AssertionError(f"L1 {label}: resident {r['resident_bytes']} "
                             f"bytes above the measured peak {peak_bytes}")
    return r


def path_l1(torch, e: dict, lm: dict, j2: dict, k2: dict) -> dict:
    """L1: the dry-run of the runs paths E (prefill), I (training step), J2
    and K2 (prefill) made, at their own config cuts, batches and seqs,
    against their measured times (warm prefills, I's median step) and
    peaks. No model runs here."""
    import dataclasses
    from repro_torch.configs import get_config

    def cut(arch, layers):
        return dataclasses.replace(get_config(arch), num_layers=layers)
    return {
        "E": l1_share(torch, "E", cut(E_ARCH, E_LAYERS), "prefill", E_SEQ,
                      E_BATCH, e["warm_s"], e["peak_bytes"]),
        "I": l1_share(torch, "I", cut(E_ARCH, I_LAYERS), "train", I_SEQ,
                      I_BATCH, lm["ms_step"] / 1e3, lm["peak_bytes"]),
        "J2": l1_share(torch, "J2", cut(J_MOE, J_MOE_LAYERS), "prefill",
                       J_SEQ, J_BATCH, j2["warm_s"], j2["peak_bytes"]),
        "K2": l1_share(torch, "K2", cut(K_VISION, K_VISION_LAYERS),
                       "prefill", J_SEQ, J_BATCH, k2["warm_s"],
                       k2["peak_bytes"])}


def path_l2(np, torch, K, S, FA, walks) -> dict:
    """L2: jamba-v0.1-52b at published widths cut to one superblock (8 of
    32 layers: 1 attention, 7 Mamba2, 4 MoE of 16 x 14,336), bf16 params
    drawn on the card in chunks; its init peak within the params' bytes
    plus the largest leaf's float32 bytes plus 1 GB; one prefill of B=1 x
    S=4,096 and 8 greedy steps with every count set to 0 just before
    (flash once at prefill, tensor-core, never at decode); flash held to
    its plain version on the attention layer's own q, k, v; the dry-run's
    ``resident_bytes`` within the measured peak."""
    import dataclasses
    from repro_torch import random as jr
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import walks_to_lm_tokens
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    full = get_config(L_ARCH)
    cfg = dataclasses.replace(full, num_layers=len(full.superblock()),
                              param_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, jr.PRNGKey(0), DEV)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    r = {"init_s": time.perf_counter() - t0,
         "init_peak": torch.cuda.max_memory_allocated() - base,
         "params_bytes": sum(v.numel() * v.element_size() for v in leaves),
         "largest_f32": max(v.numel() for v in leaves) * 4}
    limit = r["params_bytes"] + r["largest_f32"] + L_INIT_SLACK
    log(f"L2: {cfg.name} d_model={cfg.d_model} layers={cfg.num_layers} "
        f"(of {full.num_layers}; {cfg.param_count():,} params, bf16 "
        f"{r['params_bytes'] / 1e9:.3f} GB) experts={cfg.moe_experts} "
        f"d_ff={cfg.d_ff} ssm_state={cfg.ssm_state} initialised on the "
        f"card in {r['init_s']:.2f} s host; init peak "
        f"{r['init_peak'] / 1e9:.3f} GB (limit: params + largest leaf "
        f"{r['largest_f32'] / 1e9:.3f} GB f32 + 1 GB = {limit / 1e9:.3f})")
    if r["init_peak"] > limit:
        raise AssertionError(f"L2: init peak {r['init_peak']} above "
                             f"{limit}")
    tokens = torch.from_numpy(walks_to_lm_tokens(
        walks % cfg.vocab, L_SEQ)[:1]).to(DEV)
    orig, qkv = FA.launch, []

    def keep(which, q, k, v, window=0, causal=True):
        if not qkv:
            qkv.append((q.clone(), k.clone(), v.clone(), window, causal))
        return orig(which, q, k, v, window, causal)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(K, S, FA)
    FA.launch = keep
    try:
        logits, toks, t_pre, t_dec, at_prefill, at_decode, caches = serve(
            torch, M, cfg, params, tokens, L_GEN + 1)
    finally:
        FA.launch = orig
    others = kernel_counts(K, S, FA)[:3]
    r.update({"peak_bytes": torch.cuda.max_memory_allocated(),
              "prefill_tokens_s": L_SEQ / t_pre,
              "decode_ms": t_dec / L_GEN * 1e3,
              "launches": at_prefill[0], "launches_tc": at_prefill[1]})
    del caches
    if others != (0, 0, 0) or at_prefill != (1, 1, 0) or \
            at_decode != (0, 0, 0):
        raise AssertionError(f"L2: launches (step, walk, sgns) {others}, "
                             f"flash {at_prefill} at prefill and "
                             f"{at_decode} at decode; want (0, 0, 0), "
                             f"(1, 1, 0), (0, 0, 0)")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("L2: non-finite logits")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.prefill(cfg, params, {"tokens": tokens}, max_len=L_SEQ + L_GEN + 1)
    torch.cuda.synchronize()
    r["warm_s"] = time.perf_counter() - t0
    q, k, v, window, causal = qkv.pop()
    r["flash_err"] = flash_compare(torch, FA, q, k, v, window, causal,
                                   "L2 attention layer",
                                   E_FLASH_TOL["bfloat16"])
    del q, k, v
    cell = lower_cell(cfg, "prefill", L_SEQ, 1, make_test_mesh(1, 1), 1)
    r["resident_bytes"] = cell["resident_bytes"]
    log(f"L2: prefill B=1 S={L_SEQ}: {t_pre:.4f} s = "
        f"{r['prefill_tokens_s']:.6g} tokens/s (a second, warm prefill "
        f"{r['warm_s']:.4f} s; counted {cell['flops']:.6g} FLOPs = "
        f"{cell['flops'] / 989e12 * 1e3:.4f} ms at 989 TFLOP/s); decode "
        f"{L_GEN} steps: "
        f"{r['decode_ms']:.4f} ms/token; flash (total, tensor-core, SIMT) "
        f"{at_prefill} at prefill, {at_decode} at decode; the attention "
        f"layer's q, k, v through the kernel vs its plain version: max "
        f"|diff| {r['flash_err']:.3g} (atol, rtol "
        f"{E_FLASH_TOL['bfloat16']}); peak {r['peak_bytes'] / 1e9:.3f} GB, "
        f"dry-run resident {r['resident_bytes'] / 1e9:.3f} GB; tokens "
        f"{toks[0].tolist()}")
    if r["resident_bytes"] > r["peak_bytes"]:
        raise AssertionError(f"L2: resident {r['resident_bytes']} above the "
                             f"measured peak {r['peak_bytes']}")
    del params, logits
    torch.cuda.empty_cache()
    return r


def start_l3():
    """L3's process: ``python -m repro_torch.launch.dryrun --arch yi-6b
    --shape train_4k`` with no card visible, started beside the examples
    (it runs on the host's cores alone)."""
    arch, shape = L_CELL
    art = ROOT / "experiments" / "dryrun_torch" / \
        f"{arch}__{shape}__pod16x16.json"
    art.unlink(missing_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    proc = subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    CHILDREN.append(proc)
    return proc, art, time.perf_counter()


def path_l3(started) -> dict:
    """L3: the process ``start_l3`` started exits 0 and leaves an ``ok``
    artifact at pod16x16."""
    proc, art, t0 = started
    _, err = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not art.is_file():
        raise AssertionError(f"L3: the dry-run exited {proc.returncode}: "
                             f"{err[-2000:]}")
    a = json.loads(art.read_text())
    if a["status"] != "ok" or a["mesh"] != "pod16x16" or a["chips"] != 256:
        raise AssertionError(f"L3: artifact {a}")
    log(f"L3: {L_CELL[0]} {L_CELL[1]} at pod16x16 with no card visible: "
        f"the cell counted in {a['total_seconds']:.2f} s (its artifact's "
        f"total_seconds, beside the examples; the process ended within "
        f"{secs:.2f} s of its start, read once the examples ended), resident "
        f"{a['memory']['resident_bytes'] / 1e9:.4f} GB a card, t_compute "
        f"{a['t_compute']:.4e} s, t_memory {a['t_memory']:.4e} s, "
        f"bottleneck {a['bottleneck']}, useful ratio "
        f"{a['useful_ratio']:.4f}")
    return {"seconds": a["total_seconds"],
            "resident_bytes": a["memory"]["resident_bytes"],
            "bottleneck": a["bottleneck"]}


def run_examples(torch) -> None:
    """The six ``examples/torch/`` scripts on the card (and the LM ones
    once more with jamba, a hybrid of attention, Mamba and MoE layers, and
    with the cross-attention archs), in subprocesses started together
    (``distributed_walks.py`` at world 1); any non-zero exit fails the
    run. Their output is printed as they left it."""
    work = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    procs = {}
    t0 = time.perf_counter()
    for i, (script, args) in enumerate(EXAMPLES):
        argv = [sys.executable, str(ROOT / "examples" / "torch" /
                                    f"{script}.py")]
        argv += ["--ckpt-dir", str(work / "walks")] if args is None \
            else args
        out = open(work / f"{i}_{script}.log", "w+")
        proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=env)
        CHILDREN.append(proc)
        procs[" ".join([f"examples/torch/{script}.py"] + (args or []))] = \
            (proc, out)
    failed = []
    for name, (proc, out) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, EXAMPLES_WAIT_S -
                                       (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        out.seek(0)
        text = out.read()
        out.close()
        log(f"{name}: exit {rc}, "
            f"{time.perf_counter() - t0:.1f} s since the phase began")
        for line in text.strip().splitlines()[-12:]:
            log(f"  | {line}")
        if rc != 0:
            failed.append(name)
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise AssertionError(f"examples failed: {failed}")


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
            torch, lambda: replay(trace[half:half + F_PROFILED], 1))
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


def since(t_start: float, what: str) -> None:
    log(f"-- {what} done, {time.perf_counter() - t_start:.1f} s since the "
        f"start")


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
    worker = len(argv) == 2 and argv[0] == "--g1-cpu"
    rank = len(argv) == 3 and argv[0] == "--h-rank"
    if argv not in ([], ["--walks"]) and not worker and not rank:
        print("usage: python3 chip_smoke.py [--walks]", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if worker:   # G1's CPU half, started by the script itself
        sys.path.insert(0, str(SRC))
        g1_cpu(np, torch, Path(argv[1]))
        return 0
    if rank:     # one of path H's ranks, started by the script itself
        sys.path.insert(0, str(SRC))
        h_rank(np, torch, int(argv[1]), Path(argv[2]))
        return 0
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
    from repro_torch.kernels import threefry as TF
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
    tf = check_threefry(np, torch, jr, TF)
    since(t_start, "phase 1")

    # ---- main path A: per-step kernel, FN-Cache ------------------------
    spec_a = A_SPEC
    t0 = time.perf_counter()
    first = WalkEngine.build(spec_a, WalkPlan(
        p=1.0, q=0.5, length=LENGTH, cap=128, backend="fused"), device=DEV)
    pg_a = first.pg
    log(f"A: {spec_a}: n={pg_a.n} m={first.store.graph.m} "
        f"max_deg={pg_a.hot_cap} hot={pg_a.num_hot} layout built in "
        f"{time.perf_counter() - t0:.2f} s host")
    step_launches, rows_built, a_walks, tf_launches = {}, {}, {}, {}
    for mode in ("exact", "approx"):
        kw = dict(p=1.0, q=0.5, length=LENGTH, cap=128, mode=mode)
        fused = WalkEngine.build(pg_a, WalkPlan(backend="fused", **kw))
        ref = WalkEngine.build(pg_a, WalkPlan(backend="reference", **kw))
        K.node2vec_step.launches = 0
        K.node2vec_walk.launches = 0
        TF.threefry2x32.launches = 0
        built = count_calls(WALK, "unified_row")
        try:
            walks, secs = drive(torch, fused, 2)
        finally:
            built = built()
        step_launches[mode] = K.node2vec_step.launches
        # a round: the walkers' keys (1) and step 0's alias draw (4), then
        # the supersteps' draws
        tf_launches[mode] = (TF.threefry2x32.launches - 2 * 5) / (
            2 * (LENGTH - 1))
        if mode == "exact" and tf_launches[mode] != 3:
            raise AssertionError(f"A/exact: {TF.threefry2x32.launches} "
                                 f"threefry launches in 2 rounds, "
                                 f"{tf_launches[mode]} a superstep, want 3 "
                                 f"(fold_in, split, uniform)")
        rows_built[mode] = built
        # step 0's first-order draw builds the start rows once a run; exact
        # supersteps read the layout in place
        if mode == "exact" and built != 2:
            raise AssertionError(f"A/exact: the fused run built full-width "
                                 f"rows {built} times, want 2 (step 0 of "
                                 f"each round)")
        a_walks[mode] = walks[0]              # path H's yardstick
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
            f"{step_launches[mode]}; unified_row calls {rows_built[mode]}; "
            f"threefry launches a superstep {tf_launches[mode]:.4g}")
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
    since(t_start, "path A")

    # ---- main path C: streamed SGNS with the fused kernel --------------
    trainer, c_walks, sgns_launches = path_c(np, torch, pg_a)
    sg = time_sgns(np, torch, S, trainer, c_walks[0], 1024, "main path")
    bw = time_sgns(np, torch, S, trainer, c_walks[0], 65536,
                   "bandwidth reading")
    sgns_err = max(sgns_err, sg["err"], bw["err"])
    profile_round(torch, lambda: trainer.consume(
        c_walks[0][:C_PROFILE_WALKERS]), "C fused SGNS", "~50 steps")
    since(t_start, "path C")

    # ---- path G1: the sharded trainer at path C's width ----------------
    g1 = path_g1(np, torch, c_walks, trainer)
    since(t_start, "path G1")
    table_c = serving_table(trainer.params)    # path F's table
    del trainer
    torch.cuda.empty_cache()

    # ---- path H: the sharded backend and tables across worlds ----------
    # G1's world-1 tables after round 0 (card[0] is its 100-step reading)
    h = path_h(np, torch, pg_a, a_walks, c_walks, g1["kw"], g1["card"][1])
    since(t_start, "path H")
    del c_walks, pg_a, a_walks

    # ---- main path B: whole-walk kernel, FN-Base -----------------------
    walk = walk_phase(np, torch, K, B_SPEC, "B", profile=True)
    wide = walk_phase(np, torch, K, A_SPEC, WIDE)
    walk_err = max(walk_err, walk["err"], wide["err"])
    since(t_start, "path B")

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
    since(t_start, "path D")

    # ---- path E: LM serving, flash_attention at every prefill layer ----
    torch.cuda.empty_cache()
    flash_launches, err, fl = path_e(np, torch, lm_walks, one_rounding)
    flash_err = max(flash_err, err)
    since(t_start, "path E")
    torch.cuda.empty_cache()

    # ---- path I: LM training at yi-6b's width through the launcher -----
    lm = path_i(np, torch, lm_walks)
    since(t_start, "path I")

    # ---- path J: mamba2-370m whole, phi3.5-moe at published widths -----
    t_j = time.perf_counter()
    j1 = path_j1(np, torch, K, S, FA, lm_walks)
    j2 = path_j2(np, torch, K, S, FA, lm_walks)
    j3 = path_j3(np, torch, lm_walks)
    j_secs = time.perf_counter() - t_j
    flash_err = max(flash_err, j2["flash_err"])
    since(t_start, "path J")

    # ---- path K: cross attention, seamless whole and llama-vision ------
    t_k = time.perf_counter()
    k1 = path_k_serve(np, torch, K, S, FA, lm_walks, K_SEAMLESS, None, "K1")
    k2 = path_k_serve(np, torch, K, S, FA, lm_walks, K_VISION,
                      K_VISION_LAYERS, "K2")
    k3 = path_k3(np, torch, K, S, FA, lm_walks)
    k_secs = time.perf_counter() - t_k
    flash_err = max(flash_err, *(r["err"] for k in (k1, k2)
                                 for r in k["flash"].values()))
    since(t_start, "path K")

    # ---- path L: the dry-run against the card; jamba's superblock ------
    t_l = time.perf_counter()
    l1 = path_l1(torch, fl, lm, j2, k2)
    l2 = path_l2(np, torch, K, S, FA, lm_walks)
    l_secs = time.perf_counter() - t_l
    flash_err = max(flash_err, l2["flash_err"])
    del lm_walks
    since(t_start, "path L1, L2")
    # L3 runs on the host's cores beside the examples, never beside a
    # timed path: its load would move L2's host-bound init and decode
    l3_run = start_l3()
    run_examples(torch)
    l3 = path_l3(l3_run)
    since(t_start, "examples, path L3")

    # ---- path F: embedding serving with churn, step kernel per superstep
    f = path_f(np, torch, K, store_a, table_c)
    since(t_start, "path F")
    del store_a, table_c
    torch.cuda.empty_cache()

    # ---- path G2: the training launcher on an on-disk edge list --------
    scratch = ROOT / "build" / "chip_smoke_g2"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    try:
        g2 = path_g2(np, torch, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    since(t_start, "path G2")
    g1_cpu_gates(torch, g1)
    since(t_start, "G1's CPU readings")

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
         "library_ms": None, "launches_row_entry": g1["launches"],
         "launches_launcher": g2["launches"],
         "launches_world2_per_rank": h["launches"],
         "ms_host": sg["ms_host"],
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
        {"name": "threefry2x32", "route": "cuda", "source": THREEFRY_SOURCE,
         "replaces": "none (jax.random threefry)",
         "launches_per_superstep": tf_launches["exact"],
         "launches_per_superstep_approx": tf_launches["approx"],
         "max_abs_err": 0, "ms": tf["fold_in"]["ms"],
         "ms_host": tf["fold_in"]["ms_host"],
         "plain_ms": tf["fold_in"]["plain_ms"],
         "bound_ms": max(tf["fold_in"]["bound_ms_bytes"],
                         tf["fold_in"]["bound_ms_ops"]),
         "bound_by": "bytes" if tf["fold_in"]["bound_ms_bytes"]
         >= tf["fold_in"]["bound_ms_ops"] else "operations",
         "library_ms": None, "calls": tf},
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
         "launches_j2_prefill": j2["launches"],
         "launches_tc_j2_prefill": j2["launches_tc"],
         "max_abs_err_j2_prefill": j2["flash_err"],
         "bound_ms_32k": fl["bound_32k"][0],
         "bound_by_32k": fl["bound_32k"][1],
         "launches_k1_prefill": k1["launches"],
         "launches_tc_k1_prefill": k1["launches_tc"],
         "launches_noncausal_k1_prefill": k1["launches_noncausal"],
         "launches_k2_prefill": k2["launches"],
         "launches_tc_k2_prefill": k2["launches_tc"],
         "launches_l2_prefill": l2["launches"],
         "launches_tc_l2_prefill": l2["launches_tc"],
         "max_abs_err_l2_prefill": l2["flash_err"],
         **{f"{key}_{site}": r[key] if key != "bound_ms" else r["bound"][0]
            for site, r in (("k1_encoder", k1["flash"]["encoder"]),
                            ("k1_decoder", k1["flash"]["decoder"]),
                            ("k2_decoder", k2["flash"]["decoder"]))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "tflops")},
         **{f"max_abs_err_{site}": r["err"]
            for site, r in (("k1_encoder", k1["flash"]["encoder"]),
                            ("k1_decoder", k1["flash"]["decoder"]),
                            ("k2_decoder", k2["flash"]["decoder"]))}},
    ]
    log(f"I (LM training, {E_ARCH}'s widths, {I_LAYERS} layers, "
        f"B={I_BATCH} S={I_SEQ}): {lm['ms_step']:.2f} ms/step, "
        f"{lm['tokens_s']:.6g} tokens/s, device busy {lm['busy']:.3f}, "
        f"peak {lm['peak_gb']:.2f} GB; card vs CPU {lm['loss_gap']:.3g} "
        f"(loss), {lm['gnorm_gap']:.3g} (grad norm)")
    log(f"J ({j_secs:.1f} s): {J_MAMBA} whole prefill "
        f"{j1['prefill_tokens_s']:.6g} tokens/s (warm "
        f"{j1['warm_tokens_s']:.6g}), decode "
        f"{j1['decode_ms']:.4f} ms/token, busy {j1['prefill_busy']:.3f} / "
        f"{j1['decode_busy']:.3f}, peak {j1['peak_gb']:.2f} GB; {J_MOE} "
        f"{J_MOE_LAYERS} layers prefill {j2['prefill_tokens_s']:.6g} "
        f"tokens/s (warm {j2['warm_tokens_s']:.6g}), decode {j2['decode_ms']:.4f} ms/token, busy "
        f"{j2['prefill_busy']:.3f} / {j2['decode_busy']:.3f}, peak "
        f"{j2['peak_gb']:.2f} GB, dropped {j2['drop_prefill']} / "
        f"{j2['drop_decode']}; training {j3['ms_step']:.2f} ms/step, "
        f"{j3['tokens_s']:.6g} tokens/s; card vs CPU {j1['cpu_gap']:.3g} / "
        f"{j2['cpu_gap']:.3g}, chunked vs stepwise {j1['step_gap']:.3g}, "
        f"near-ties {j2['near_ties']}")
    for label, k in (("K1", k1), ("K2", k2)):
        log(f"{label} ({k_secs:.1f} s for K): prefill "
            f"{k['prefill_tokens_s']:.6g} tokens/s (warm "
            f"{k['warm_tokens_s']:.6g}), decode {k['decode_ms']:.4f} "
            f"ms/token, busy {k['prefill_busy']:.3f} / "
            f"{k['decode_busy']:.3f}, peak {k['peak_gb']:.2f} GB (init "
            f"{k['init_peak_gb']:.2f} GB for {k['params_gb']:.2f} GB of "
            f"params), flash launches {k['launches']} "
            f"({k['launches_noncausal']} causal=False), card vs CPU "
            f"{k['cpu_gap']:.3g}, another memory moves the logits "
            f"{k['other_memory_gap']:.4g}")
    log(f"K3 ({K_SEAMLESS} training, B={K3_BATCH} S={K3_SEQ}): "
        f"{k3['ms_step']:.2f} ms/step, {k3['tokens_s']:.6g} tokens/s, busy "
        f"{k3['busy']:.3f}, peak {k3['peak_gb']:.2f} GB")
    log(f"L1, L2 ({l_secs:.1f} s): shares " + ", ".join(
        f"{k} {v['share']:.4f} (resident {v['resident_bytes'] / 1e9:.3f} / "
        f"peak {v['peak_bytes'] / 1e9:.3f} GB)" for k, v in l1.items())
        + f"; L2 jamba superblock init peak {l2['init_peak'] / 1e9:.3f} GB "
        f"for {l2['params_bytes'] / 1e9:.3f} GB of bf16 params, prefill "
        f"{l2['prefill_tokens_s']:.6g} tokens/s, decode "
        f"{l2['decode_ms']:.4f} ms/token, peak {l2['peak_bytes'] / 1e9:.3f} "
        f"GB vs resident {l2['resident_bytes'] / 1e9:.3f}; L3 "
        f"{l3['seconds']:.2f} s beside the examples, {l3['bottleneck']}")
    log(f"card: {smi}")       # again, where the output's tail keeps it
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()

"""Shared second-order sampling layer — port of ``repro.engine.sampler``.

Every walk backend draws the next step through this module. RNG contract,
identical to the JAX package's, given the per-(walker, step) key
``k = fold_in(fold_in(seed, walker), step)``:

    k_exact, k_approx = split(k)
    r          = uniform(k_exact)                     # one uniform per walker
    slot_exact = count((prefix_sum(alpha * w) <= r * total) & valid)
    slot_alias = alias_sample(k_approx, ...)          # O(1) fast path

``prefix_sum`` reproduces the order in which XLA's CPU backend evaluates
``jnp.cumsum`` (a blocked scan with base 16), so slots, and hence whole
walks, equal the JAX package's integer for integer. ``torch.cumsum`` rounds
differently and is never used on this path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as jr
from repro_torch.core.alias import alias_pick, alias_uniforms
from repro_torch.core.graph import PAD_ID
from repro_torch.core.transition import approx_gap, unnormalized_probs
from repro_torch.tracing import span

MODES = ("exact", "approx", "approx_always")
SCAN_BASE = 16


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 scan of the last axis, strictly left to right."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the last axis in the base-16 blocked order:

    1. a sequential float32 scan inside each block of 16 lanes;
    2. the block totals scanned by the same rule, recursively;
    3. each block's exclusive carry added to its in-block prefixes.

    This equals ``jnp.cumsum`` on the CPU bit for bit.
    """
    d = x.shape[-1]
    if d <= SCAN_BASE:
        return _sequential_scan(x)
    nb = -(-d // SCAN_BASE)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BASE - d))
    within = _sequential_scan(xp.reshape(*x.shape[:-1], nb, SCAN_BASE))
    inc = prefix_sum(within[..., -1])
    carry = torch.nn.functional.pad(inc[..., :-1], (1, 0))
    out = within + carry[..., None]
    return out.reshape(*x.shape[:-1], nb * SCAN_BASE)[..., :d]


def split_keys(keys: torch.Tensor):
    """Per-walker (k_exact, k_approx) from a [W, 2] batch of step keys."""
    sub = jr.split(keys)
    return sub[:, 0], sub[:, 1]


def exact_slots(cand_ids: torch.Tensor, cand_w: torch.Tensor,
                u: torch.Tensor, prev_rows: torch.Tensor, rand: torch.Tensor,
                p: float, q: float) -> torch.Tensor:
    """Batched exact second-order draw — the definition both CUDA kernels
    implement. cand_ids/cand_w [W, D] (PAD_ID / 0 padded), u [W],
    prev_rows [W, DP] (sorted N(u)), rand [W] in [0, 1). Returns the
    sampled candidate slot per walker, [W] int32."""
    probs = unnormalized_probs(cand_ids, cand_w, u, prev_rows, p, q)
    cum = prefix_sum(probs)
    target = rand[:, None] * cum[:, -1:]
    valid = cand_ids != PAD_ID
    slot = ((cum <= target) & valid).sum(dim=-1)
    return torch.clamp(slot, max=cand_ids.shape[-1] - 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class HotContext:
    """Per-walker inputs of the approx fast path; values matter only where
    ``is_hot_v`` is true."""
    is_hot_v: torch.Tensor   # [W] bool — current vertex is popular
    is_hot_u: torch.Tensor   # [W] bool — previous vertex is popular
    deg_u: torch.Tensor      # [W] int32 true degree of u
    deg_v: torch.Tensor      # [W] int32 true degree of v
    w_min_v: torch.Tensor    # [W] float32
    w_max_v: torch.Tensor    # [W] float32
    alias_p: torch.Tensor    # [W, Da] first-order alias rows of v
    alias_i: torch.Tensor    # [W, Da]
    alias_deg: torch.Tensor  # [W] live width of the alias rows


@dataclasses.dataclass(frozen=True)
class StepChoice:
    """Outcome of one superstep's sampling."""
    slot_exact: torch.Tensor
    slot_alias: Optional[torch.Tensor] = None
    use_alias: Optional[torch.Tensor] = None

    def slot(self) -> torch.Tensor:
        """Combined slot, [W] int64 (ready for ``gather``)."""
        if self.use_alias is None:
            return self.slot_exact.long()
        return torch.where(self.use_alias, self.slot_alias,
                           self.slot_exact.long())


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Second-order step strategy: exact / approx / approx_always.

    ``fused=True`` computes the exact slot with the ``node2vec_step`` CUDA
    kernel (on CPU tensors its plain version, :func:`exact_slots`)."""
    p: float = 1.0
    q: float = 1.0
    mode: str = "exact"
    eps: float = 1e-3
    fused: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def exact(self, rand, cand_ids, cand_w, u, prev_rows) -> torch.Tensor:
        if self.fused:
            from repro_torch.kernels.node2vec_step import node2vec_step
            return node2vec_step(cand_ids, cand_w, u, prev_rows, rand,
                                 self.p, self.q)
        return exact_slots(cand_ids, cand_w, u, prev_rows, rand, self.p,
                           self.q)

    def choose(self, keys, cand_ids, cand_w, u, prev_rows,
               hot: Optional[HotContext] = None) -> StepChoice:
        """One superstep draw for a [W] batch of walkers."""
        with span("walk.rng", keys.device):
            k_exact, k_approx = split_keys(keys)
            rand = jr.uniform(k_exact)
        slot_exact = self.exact(rand, cand_ids, cand_w, u, prev_rows)
        return self.with_alias(slot_exact, k_approx, hot)

    def with_alias(self, slot_exact, k_approx,
                   hot: Optional[HotContext] = None) -> StepChoice:
        """The step's choice given its exact slot: in the approx modes, the
        O(1) alias draw under ``k_approx`` and where it is taken."""
        if self.mode == "exact" or hot is None:
            return StepChoice(slot_exact)
        with span("walk.rng", k_approx.device):
            uniforms = alias_uniforms(k_approx)
        slot_alias = alias_pick(*uniforms, hot.alias_p, hot.alias_i,
                                hot.alias_deg)
        if self.mode == "approx":
            gap = approx_gap(hot.deg_u, hot.deg_v, hot.w_min_v, hot.w_max_v,
                             self.p, self.q)
            eps = torch.tensor(self.eps, dtype=torch.float32,
                               device=gap.device)      # f32, as in JAX
            use = hot.is_hot_v & (~hot.is_hot_u) & (gap < eps)
        else:  # approx_always — O(1) path at every hot vertex
            use = hot.is_hot_v
        return StepChoice(slot_exact, slot_alias, use)

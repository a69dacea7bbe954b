// Exact second-order node2vec draws on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/node2vec_step.py:
//   node2vec_step_live_kernel, node2vec_step_layout_kernel
//                         <- node2vec_step (_step_kernel): one draw per walker
//   node2vec_walk_kernel  <- node2vec_walk (_walk_kernel): steps 1..L-1 of an
//                            exact walk, the prev row carried on chip
//
// What one draw computes (the contract of repro_torch.engine.sampler.
// exact_slots, bit for bit, over a row padded to width D):
//   member[j] = cand[j] in the sorted prev row
//   alpha[j]  = cand[j] == u ? 1/p : member[j] ? 1 : 1/q
//   prob[j]   = cand[j] != PAD_ID ? alpha[j] * w[j] : 0
//   cum       = inclusive prefix sum of prob in the base-16 blocked order
//   slot      = min(#{j : cum[j] <= r * cum[D-1] and cand[j] != PAD_ID}, D-1)
//
// The prefix sum must round exactly as XLA's CPU cumsum does: a sequential
// float32 scan inside each block of 16 lanes, the block totals scanned by the
// same rule (recursively while there are more than 16), then each block's
// exclusive carry added to its in-block prefixes. Every float operation is an
// explicit __fadd_rn / __fmul_rn (and the build passes --fmad=false), so no
// multiply-add is ever contracted into an FMA.
//
// The live-lane draw (draw_live), which all three kernels run. A row's lanes
// past its live length L hold PAD_ID and weight 0, and are never read: only L
// ids and weights of v's row and the live prefix of u's row are. A warp
// serves one walker. Its lanes load v's ids and weights lane-strided
// (coalesced), test each id's membership in u's row with branchless binary
// searches, two stepped together a lane so their loads overlap, and write
// the probabilities to a per-warp chunk buffer of up to 512 lanes (skewed,
// element i at i + i/16, so lanes reading neighbouring blocks hit different
// banks). Lane k then owns level-0 block k (16 lanes) in registers and scans
// it with a serial __fadd_rn chain; block totals go to a per-warp level
// buffer whose levels are scanned by the same rule; each lane adds its carry
// and counts. Rows of more than 512 live lanes take a second pass that
// recomputes each chunk instead of holding them. Two facts of the padded contract are kept:
//   * the total is cum[D-1] of the padded row, not cum[L-1]: the zero lanes
//     change how the last live block's carry is grouped at the upper levels
//     (at D = 913 the two differ in about a fifth of rows), so the total is
//     evaluated with D's level structure over the live block totals
//     (scan_levels). The live prefixes themselves are the same at any width;
//   * the slot is clamped to D-1, not L-1: when r * total rounds up past
//     cum[L-1], slot == L and the padded row's id there is PAD_ID.
//
// The step kernels (one draw per walker, a warp each): a row entry over
// [W, D] candidate rows (L found on the card by a warp-wide search for the
// first PAD_ID) and a layout entry that reads v's and u's rows in place from
// the FN-Base / FN-Cache layout (cold rows of width cap, hot rows of width
// hot_cap, L = min(deg, width)) and also returns the next vertex. u's live
// row is staged in shared memory with cp.async beside the loads of v's row.
//
// The walk kernel (node2vec_walk_kernel): one warp a walker for all its
// steps, L = min(deg[v], D). What it does about each cost of a step:
//   * u's row is never read again: the draw writes v's live ids, as it
//     loads them, into one half of a per-walker double buffer in shared
//     memory, which is the next step's prev row (the halves swap each
//     step), and the next vertex is read from there. Where two rows of
//     width D and the draw's buffers do not fit the shared budget (D in
//     the thousands), u's row is searched in place in the layout, where
//     the step before read it, and the next vertex read from v's row;
//   * deg[v] and the first lanes of v's row (128 for D <= 256, else 64)
//     are loaded together (each row is D wide and PAD-padded, so the loads
//     stay in bounds), then masked by L;
//   * lane k loads the uniform of step s0 + k once per 32 steps and the
//     lanes broadcast it; lane s mod 32 keeps step s's vertex, and the
//     warp writes 32 steps in one coalesced store;
//   * rows of D <= 256 (path B's 147) take draw_small, which is built for
//     instruction count, the kernel's limit there (at 32 warps an SM the
//     schedulers, not the bytes, set the pace): membership searches of
//     fixed depth, one load, compare and predicated add a step; no masks
//     in the scans (dead lanes hold 0); one lane scans the block totals;
//     a 5-step search of a block's prefixes for its count. Wider rows run
//     draw_live, its chunk buffer sized to D when D is below 512 lanes.
// A walker whose v lies outside [0, n) (PAD_ID after a slot past the live
// lanes) stays there and reads nothing, as the JAX package's walk does (its
// take fills deg with INT_MIN there); a u0 outside [0, n) has no prev row.
//
// Level buffers live in shared memory when they fit, else in a global
// scratch the wrapper allocates (node2vec_live_scratch_floats and
// node2vec_walk_scratch_floats say how much). The kernels are bound by
// device-memory bytes: each live id and weight of v's row and each live id
// of u's row (the walk kernel: only u0's) is read once per draw.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 0x7fffffff;
constexpr int kBase = 16;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemBudget = 96 * 1024;  // per block, of the 227 KB
constexpr int kWarpsPerBlock = 4;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int skew(int i) { return i + i / kBase; }

// Floats of a scan buffer for d entries: every level stored skewed.
__host__ __device__ inline int scan_floats(int d) {
  int total = 0, n = d;
  while (true) {
    total += (kBase + 1) * cdiv(n, kBase);
    if (n <= kBase) break;
    n = cdiv(n, kBase);
  }
  return total;
}

constexpr int kChunk = kWarp * kBase;  // lanes of v's row a pass holds
constexpr int kChunkFloats = kChunk + kWarp;  // a chunk's buffer, skewed
constexpr int kBatch = 2;  // candidates a lane searches together

// One walker's draw: v's row (its live length lv, the padded width d that
// fixes the total's level structure and the clamp), u and u's row (lu live
// ids), the uniform r and the two scalars.
struct Draw {
  const int* cand;
  const float* w;
  int lv, d, u;
  const int* prev;
  int lu;
  float r, p_inv, q_inv;
};

// The first batch of v's row, loaded before lv is known (the walk kernel).
template <int B>
struct Batch {
  int x[B];
  float w[B];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Probabilities of lanes [c0, c0 + kChunk) of v's row, live ones only, into
// probs (chunk-relative, skewed): lane-strided, so the loads of ids and
// weights are coalesced. Membership: kBatch branchless lower-bound searches
// of the sorted prev row a lane, stepped together so their loads overlap.
// wait: first wait for this lane's copy of u's row (after the first
// batch's loads are in flight) and sync the warp. keep: where v's live ids
// are written (nullptr: nowhere). pre: the chunk's first batch, already
// loaded (when has_pre).
__device__ __forceinline__ void chunk_probs(const Draw& dr, const int* prev,
                                            int c0, float* probs, bool wait,
                                            int* keep,
                                            const Batch<kBatch>& pre,
                                            bool has_pre, int lane) {
  const int hi = min(dr.lv - c0, kChunk);
  for (int m0 = 0; m0 < hi; m0 += kWarp * kBatch) {
    int x[kBatch], pos[kBatch];
    float wt[kBatch];
    const bool first = has_pre && m0 == 0;
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int i = m0 + t * kWarp + lane;
      const bool live = i < hi;
      if (first) {
        x[t] = live ? pre.x[t] : kPad;
        wt[t] = live ? pre.w[t] : 0.0f;
      } else {
        x[t] = live ? dr.cand[c0 + i] : kPad;
        wt[t] = live ? dr.w[c0 + i] : 0.0f;
      }
      if (keep && live) keep[c0 + i] = x[t];
      pos[t] = 0;
    }
    if (wait && m0 == 0) {
      cp_async_wait_all();
      __syncwarp();
    }
    for (int n = dr.lu; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        if (m0 + t * kWarp < hi)  // the same for every lane
          pos[t] = prev[pos[t] + half] < x[t] ? pos[t] + half : pos[t];
      n -= half;
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int i = m0 + t * kWarp + lane;
      if (i < hi) {
        bool member = false;
        if (dr.lu > 0) {  // the lower bound is pos[t] or pos[t] + 1
          const int a = prev[pos[t]];
          member = a == x[t] || (a < x[t] && pos[t] + 1 < dr.lu &&
                                 prev[pos[t] + 1] == x[t]);
        }
        const float alpha =
            x[t] == dr.u ? dr.p_inv : (member ? 1.0f : dr.q_inv);
        probs[skew(i)] = __fmul_rn(alpha, wt[t]);
      }
    }
  }
}

// Level-0 block b (chunk-relative index bc) scanned in registers: within[j]
// becomes the in-block inclusive prefix (a serial __fadd_rn chain over the
// live lanes, 0 past them); returns the block total.
__device__ __forceinline__ float scan_block(const Draw& dr, const float* probs,
                                            int b, int bc,
                                            float (&within)[kBase]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kBase; ++j) {
    const float prob =
        b * kBase + j < dr.lv ? probs[skew(bc * kBase + j)] : 0.0f;
    acc = __fadd_rn(acc, prob);
    within[j] = acc;
  }
  return acc;
}

// Floats of a live-lane draw's level buffer: level 1 (one total per 16-lane
// block of the padded width d) and the levels above it, skewed.
__host__ __device__ inline int level_floats(int d) {
  return d > kBase ? scan_floats(cdiv(d, kBase)) : 0;
}

// Offset in the level buffer of level l + 1 (l = 0: level 1) for padded
// width d.
__device__ __forceinline__ int level_off(int d, int l) {
  int off = 0, n = cdiv(d, kBase);
  for (int k = 0; k < l; ++k) {
    off += (kBase + 1) * cdiv(n, kBase);
    n = cdiv(n, kBase);
  }
  return off;
}

// Levels >= 1 of the blocked scan, over the live entries only but with the
// level structure of the padded width d. buf holds level 1 (nl1 live block
// totals of level 0, skewed); t_last is level 0's last live block total.
// Scans the live entries in place and returns cum[d - 1] of the padded row:
// evaluated before the carries go down, from the in-block prefixes W of each
// level, as P_l(i) = W_l(i) + P_{l+1}(i / 16 - 1) (no carry in a level's
// first block, a plain prefix at the top), starting at i = d - 1 of level 0.
// A W past the live entries is the last live block's total when i falls in
// that block, else 0; adding 0 is exact, so no dead lane is touched.
__device__ float scan_levels(float* buf, int d, int nl1, float t_last,
                             int lane) {
  int levels = 0, off = 0, n = cdiv(d, kBase), nl = nl1;
  while (n > kBase) {  // up: scan inside each live block
    const int nb = cdiv(n, kBase), nbl = cdiv(nl, kBase);
    const int next = off + (kBase + 1) * nb;
    for (int b = lane; b < nbl; b += kWarp) {
      float acc = 0.0f;
      const int hi = min(kBase, nl - b * kBase);
      float* blk = buf + off + b * (kBase + 1);
      for (int j = 0; j < hi; ++j) {
        acc = __fadd_rn(acc, blk[j]);
        blk[j] = acc;
      }
      buf[next + skew(b)] = acc;
    }
    __syncwarp();
    ++levels;
    off = next;
    n = nb;
    nl = nbl;
  }
  if (lane == 0) {  // top level (<= 16 entries): one sequential scan
    float acc = 0.0f;
    for (int j = 0; j < nl; ++j) {
      acc = __fadd_rn(acc, buf[off + j]);
      buf[off + j] = acc;
    }
  }
  __syncwarp();
  float total = 0.0f;
  if (lane == 0) {
    const int n1 = cdiv(d, kBase);
    // the chain of indices: i = n1 - 2 at level 1, i / 16 - 1 a level up,
    // until a level's first block (no carry) or the top
    int last = 1, i = n1 - 2;
    while (last <= levels && i >= kBase) {
      i = i / kBase - 1;
      ++last;
    }
    if (last == levels + 1)  // the top: a plain prefix
      total = nl > 0 ? buf[off + min(i, nl - 1)] : 0.0f;
    for (int k = min(last, levels); k >= 1; --k) {  // W_k, deepest first
      int ik = n1 - 2, lk = nl1;
      for (int s = 1; s < k; ++s) {
        ik = ik / kBase - 1;
        lk = cdiv(lk, kBase);
      }
      const int lo = level_off(d, k - 1);
      float w = 0.0f;
      if (ik < lk)
        w = buf[lo + skew(ik)];
      else if (lk > 0 && ik / kBase == (lk - 1) / kBase)
        w = buf[lo + skew(lk - 1)];
      total = __fadd_rn(w, total);
    }
    total = __fadd_rn(nl1 == n1 ? t_last : 0.0f, total);  // W_0(d - 1)
  }
  total = __shfl_sync(kFull, total, 0);
  // down: add each live block's exclusive carry
  for (int l = levels - 1; l >= 0; --l) {
    int sz = nl1;
    for (int k = 0; k < l; ++k) sz = cdiv(sz, kBase);
    const int lo = level_off(d, l), up = level_off(d, l + 1);
    for (int i = lane + kBase; i < sz; i += kWarp) {
      const int b = i / kBase;
      buf[lo + skew(i)] = __fadd_rn(buf[lo + skew(i)], buf[up + skew(b - 1)]);
    }
    __syncwarp();
  }
  return total;
}

// One exact draw over the live lanes; every lane returns the slot. stage:
// shared memory to copy u's live row into (nullptr: search dr.prev where it
// is); probs: this warp's chunk buffer; lvl: its level buffer of
// level_floats(d) floats; keep, pre, has_pre: as chunk_probs's. Lane k owns
// level-0 blocks k, k + 32, ... of each chunk of kChunk lanes; the
// registers hold the last chunk's, so a row of more than one chunk is
// recomputed chunk by chunk for the count.
__device__ __forceinline__ int draw_live(const Draw& dr, int* stage,
                                         float* probs, float* lvl, int* keep,
                                         const Batch<kBatch>& pre,
                                         bool has_pre, int lane) {
  const int nb0 = cdiv(dr.lv, kBase);
  const int chunks = cdiv(dr.lv, kChunk);
  const int* prev = dr.prev;
  if (stage) {
    for (int j = lane; j < dr.lu; j += kWarp) cp_async4(stage + j, prev + j);
    prev = stage;
  }
  float within[kBase];
  float t_mine = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    chunk_probs(dr, prev, c * kChunk, probs, stage && c == 0, keep, pre,
                has_pre && c == 0, lane);
    __syncwarp();
    const int b = c * kWarp + lane;
    if (b < nb0) {
      t_mine = scan_block(dr, probs, b, lane, within);
      if (dr.d > kBase) lvl[skew(b)] = t_mine;
    }
    __syncwarp();  // probs is refilled by the next chunk
  }
  if (stage && chunks == 0) {
    cp_async_wait_all();
    __syncwarp();
  }
  const float t_last =
      nb0 ? __shfl_sync(kFull, t_mine, (nb0 - 1) % kWarp) : 0.0f;
  const float total =
      dr.d > kBase ? scan_levels(lvl, dr.d, nb0, t_last, lane) : t_last;
  const float target = __fmul_rn(dr.r, total);
  int count = 0;
  for (int c = 0; c < chunks; ++c) {
    if (chunks > 1) {
      chunk_probs(dr, prev, c * kChunk, probs, false, nullptr, pre, false,
                  lane);
      __syncwarp();
    }
    const int b = c * kWarp + lane;
    if (b < nb0) {
      if (chunks > 1) scan_block(dr, probs, b, lane, within);
      const float carry = b > 0 ? lvl[skew(b - 1)] : 0.0f;
#pragma unroll
      for (int j = 0; j < kBase; ++j) {
        const float cum = b > 0 ? __fadd_rn(within[j], carry) : within[j];
        count += (b * kBase + j < dr.lv && cum <= target) ? 1 : 0;
      }
    }
    if (chunks > 1) __syncwarp();
  }
  count = __reduce_add_sync(kFull, count);
  __syncwarp();  // the buffers are reused by the next draw
  return min(count, dr.d - 1);
}

// Index of the first PAD_ID in a sorted row of width d (d if none): a
// 32-way search, one probe a lane per round, ~log32(d) rounds.
__device__ int first_pad(const int* row, int d, int lane) {
  int lo = 0, hi = d;  // the answer is in [lo, hi]; row[hi] counts as PAD
  while (lo < hi) {
    const int step = cdiv(hi - lo, kWarp);
    const int at = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, at >= hi || row[at] == kPad);
    if (m & 1u) return lo;
    const int k = m ? __ffs(m) - 1 : kWarp;  // first probe at a PAD
    const int lo_next = lo + (k - 1) * step + 1;
    hi = m ? min(lo + k * step, hi) : hi;
    lo = lo_next;
  }
  return lo;
}

// ------------------------------------------------------------ step kernels --

// Per-warp shared memory of a step launch, in 4-byte words: u's row staged
// (stage words; 0 when it is searched in place), the chunk of probabilities
// and the level buffer (in shared memory unless it goes to global scratch).
struct LivePlan {
  int stage, levels;
  bool global_levels;
};

LivePlan live_plan(int d, int dp) {
  const int lv = level_floats(d);
  if ((size_t)kWarpsPerBlock * 4 * (dp + kChunkFloats + lv) <= kSmemBudget)
    return {dp, lv, false};
  if ((size_t)kWarpsPerBlock * 4 * (kChunkFloats + lv) <= kSmemBudget)
    return {0, lv, false};
  return {0, lv, true};
}

size_t live_smem(const LivePlan& pl) {
  return (size_t)kWarpsPerBlock * 4 *
         (pl.stage + kChunkFloats + (pl.global_levels ? 0 : pl.levels));
}

// This warp's buffers: u's row staged (nullptr if not), the chunk's
// probabilities, the level buffer (in global scratch if given).
__device__ __forceinline__ void live_buffers(float* smem, int warp, int wk,
                                             int stage, int levels,
                                             float* scratch, int** stg,
                                             float** probs, float** lvl) {
  const int per = stage + kChunkFloats + (scratch ? 0 : levels);
  float* mine = smem + warp * per;
  *stg = stage ? reinterpret_cast<int*>(mine) : nullptr;
  *probs = mine + stage;
  *lvl = scratch ? scratch + (size_t)wk * levels
                 : mine + stage + kChunkFloats;
}

// Row entry: cand_ids/cand_w [W, D], prev_ids [W, DP], sorted, PAD_ID
// padded; live lengths found on the card.
__global__ void node2vec_step_live_kernel(
    const int* __restrict__ cand_ids, const float* __restrict__ cand_w,
    const int* __restrict__ u, const int* __restrict__ prev_ids,
    const float* __restrict__ rand, int* __restrict__ slot, int W, int D,
    int DP, float p_inv, float q_inv, int stage, int levels, float* scratch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wk = blockIdx.x * kWarpsPerBlock + warp;
  if (wk >= W) return;
  int* stg;
  float *probs, *lvl;
  live_buffers(smem, warp, wk, stage, levels, scratch, &stg, &probs, &lvl);
  const int* cand = cand_ids + (size_t)wk * D;
  const int* prev = prev_ids + (size_t)wk * DP;
  const Draw dr{cand, cand_w + (size_t)wk * D, first_pad(cand, D, lane), D,
                u[wk], prev, first_pad(prev, DP, lane), rand[wk], p_inv,
                q_inv};
  const int s = draw_live(dr, stg, probs, lvl, nullptr, {}, false, lane);
  if (lane == 0) slot[wk] = s;
}

// Layout entry: v's and u's rows read in place from the padded layout, the
// cold row (width cap) or, for a hot vertex, the hot row (width hot_cap);
// the padded width is hot_cap, as the engine's full-width rows. Writes the
// slot and the next vertex: deg[v] > 0 ? row_v[slot] : v (PAD_ID when the
// slot is past the live lanes). Ids outside [0, n) are clamped for the
// reads (as JAX's gathers clamp); the engine never passes one.
__global__ void node2vec_step_layout_kernel(
    const int* __restrict__ adj, const float* __restrict__ wgt, int cap,
    const int* __restrict__ hot_adj, const float* __restrict__ hot_wgt,
    int hot_cap, const int* __restrict__ hot_pos,
    const int* __restrict__ deg, int n, const int* __restrict__ u_in,
    const int* __restrict__ v_in, const float* __restrict__ rand,
    int* __restrict__ slot, int* __restrict__ nxt, int W, float p_inv,
    float q_inv, int stage, int levels, float* scratch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wk = blockIdx.x * kWarpsPerBlock + warp;
  if (wk >= W) return;
  int* stg;
  float *probs, *lvl;
  live_buffers(smem, warp, wk, stage, levels, scratch, &stg, &probs, &lvl);
  const int u = u_in[wk], v_raw = v_in[wk];
  const int uc = min(max(u, 0), n - 1), v = min(max(v_raw, 0), n - 1);
  const int hv = hot_pos[v], hu = hot_pos[uc];
  const int dv = deg[v], du = deg[uc];
  const int* row_v = hv >= 0 ? hot_adj + (size_t)hv * hot_cap
                             : adj + (size_t)v * cap;
  const float* w_v = hv >= 0 ? hot_wgt + (size_t)hv * hot_cap
                             : wgt + (size_t)v * cap;
  const int* row_u = hu >= 0 ? hot_adj + (size_t)hu * hot_cap
                             : adj + (size_t)uc * cap;
  const int lv = min(dv, hv >= 0 ? hot_cap : cap);
  const int lu = min(du, hu >= 0 ? hot_cap : cap);
  const Draw dr{row_v, w_v, lv, hot_cap, u, row_u, lu, rand[wk], p_inv,
                q_inv};
  const int s = draw_live(dr, stg, probs, lvl, nullptr, {}, false, lane);
  if (lane == 0) {
    slot[wk] = s;
    nxt[wk] = dv > 0 ? (s < lv ? row_v[s] : kPad) : v_raw;
  }
}

// ------------------------------------------------------------- walk kernel --

// Rows of at most kSmallRow lanes (D <= 256: one level above the 16-lane
// blocks) take draw_small, in two halves of kHalf lanes, kSmallLanes a lane;
// wider rows draw_live.
constexpr int kSmallRow = kBase * kBase;
constexpr int kHalf = kSmallRow / 2;
constexpr int kSmallLanes = kHalf / kWarp;

// Per-walker shared memory of a walk launch, in 4-byte words: the two halves
// of the prev-row double buffer (prev words each; 0 when u's row is searched
// in place), the chunk of probabilities and the level buffer (unless it
// goes to global scratch). A small row's halves hold kSmallRow ids, its
// chunk kSmallRow probabilities, and its level buffer the 16 block totals
// (800 words: the float4 reads of the totals stay 16-byte aligned).
struct WalkPlan {
  int prev, probs, levels;
  bool global_levels, small;
};

WalkPlan walk_plan(int d) {
  if (d <= kSmallRow)
    return {kSmallRow, kBase * (kBase + 1), kBase, false, true};
  const int probs = cdiv(min(d, kChunk), kBase) * (kBase + 1);
  const int lv = level_floats(d);
  if ((size_t)kWarpsPerBlock * 4 * (2 * d + probs + lv) <= kSmemBudget)
    return {d, probs, lv, false, false};
  if ((size_t)kWarpsPerBlock * 4 * (probs + lv) <= kSmemBudget)
    return {0, probs, lv, false, false};
  return {0, probs, lv, true, false};
}

size_t walk_smem(const WalkPlan& pl) {
  return (size_t)kWarpsPerBlock * 4 *
         (2 * pl.prev + pl.probs + (pl.global_levels ? 0 : pl.levels));
}

// Lanes [h0, h0 + kHalf) of a small row, held kSmallLanes a lane (b, loaded
// lane-strided; PAD_ID and weight 0 past lv after masking): v's ids into
// next, and each probability into probs. Membership: a branchless
// lower-bound search of prev's first 2^kDepth lanes (u's live ids, then
// PAD_ID), the lane's searches stepped together, each step one load, one
// compare and one predicated add to the probe's address.
template <int kDepth>
__device__ __forceinline__ void small_half(int h0,
                                           const Batch<kSmallLanes>& b,
                                           int lv, int u, const int* prev,
                                           int* next, float* probs,
                                           float p_inv, float q_inv,
                                           int lane) {
  int x[kSmallLanes];
  const int* at[kSmallLanes];
#pragma unroll
  for (int k = 0; k < kSmallLanes; ++k) {
    const int i = h0 + k * kWarp + lane;
    x[k] = i < lv ? b.x[k] : kPad;
    next[i] = x[k];
    at[k] = prev;
  }
#pragma unroll
  for (int h = (1 << kDepth) / 2; h > 0; h >>= 1)
#pragma unroll
    for (int k = 0; k < kSmallLanes; ++k)
      if (at[k][h - 1] < x[k]) at[k] += h;
#pragma unroll
  for (int k = 0; k < kSmallLanes; ++k) {
    const int i = h0 + k * kWarp + lane;
    const float alpha = x[k] == u ? p_inv : (*at[k] == x[k] ? 1.0f : q_inv);
    probs[skew(i)] = i < lv ? __fmul_rn(alpha, b.w[k]) : 0.0f;
  }
}

// Both depths of the search: 7 (prev's first 128 lanes) when u's row has at
// most 128 live lanes, else 8.
__device__ __forceinline__ void small_half_at(int h0,
                                              const Batch<kSmallLanes>& b,
                                              int lv, int u, int lu,
                                              const int* prev, int* next,
                                              float* probs, float p_inv,
                                              float q_inv, int lane) {
  if (lu <= kHalf)
    small_half<7>(h0, b, lv, u, prev, next, probs, p_inv, q_inv, lane);
  else
    small_half<8>(h0, b, lv, u, prev, next, probs, p_inv, q_inv, lane);
}

// One exact draw over a row of padded width D <= 256; returns the slot.
// pre holds the row's first kHalf lanes (loaded with deg[v]); the second
// half is read only when lv passes it. prev holds u's live ids, then PAD_ID
// through lane 127, or through 255 when u has more than 128; next gets v's
// the same way (the next step's prev row). Dead lanes carry probability 0
// exactly. Lane b < ceil(lv/16) scans block b in place (its in-block
// prefixes replace the probabilities); lane 0 scans the 16 block totals in
// tot in order, so tot[b - 1] is block b's carry and tot[ceil(D/16) - 1]
// the total cum[D-1] (the blocks past the live ones add 0); lane b counts
// cum <= target by a 5-step search of its prefixes (cum does not fall
// along a block), capped at the block's live lanes.
__device__ __forceinline__ int draw_small(const int* row, const float* wrow,
                                          int lv, int D, int u, int lu,
                                          const int* prev, int* next,
                                          float* probs, float* tot, float r,
                                          float p_inv, float q_inv,
                                          const Batch<kSmallLanes>& pre,
                                          int lane) {
  small_half_at(0, pre, lv, u, lu, prev, next, probs, p_inv, q_inv, lane);
  if (lv > kHalf) {  // the same for every lane
    Batch<kSmallLanes> b;
    const int* xs = row + kHalf + lane;
    const float* ws = wrow + kHalf + lane;
#pragma unroll
    for (int k = 0; k < kSmallLanes; ++k) {
      const bool in = kHalf + k * kWarp + lane < lv;
      b.x[k] = in ? xs[k * kWarp] : kPad;
      b.w[k] = in ? ws[k * kWarp] : 0.0f;
    }
    small_half_at(kHalf, b, lv, u, lu, prev, next, probs, p_inv, q_inv,
                  lane);
  }
  __syncwarp();
  const bool live = lane < cdiv(lv, kBase);  // lane b owns block b
  float* blk = probs + lane * (kBase + 1);   // skew(16 b + j), j < 16
  float t = 0.0f;
  if (live) {
#pragma unroll
    for (int j = 0; j < kBase; ++j) {
      t = __fadd_rn(t, blk[j]);
      blk[j] = t;
    }
  }
  if (lane < kBase) tot[lane] = t;
  __syncwarp();
  if (lane == 0) {  // level 1: the block totals scanned in order
    float run = 0.0f;
#pragma unroll
    for (int q = 0; q < kBase / 4; ++q) {
      float4 t4 = reinterpret_cast<float4*>(tot)[q];
      t4.x = run = __fadd_rn(run, t4.x);
      t4.y = run = __fadd_rn(run, t4.y);
      t4.z = run = __fadd_rn(run, t4.z);
      t4.w = run = __fadd_rn(run, t4.w);
      reinterpret_cast<float4*>(tot)[q] = t4;
    }
  }
  __syncwarp();
  const float carry = lane > 0 && lane <= kBase ? tot[lane - 1] : 0.0f;
  const float target = __fmul_rn(r, tot[cdiv(D, kBase) - 1]);  // cum[D-1]
  int count = 0;
  if (live) {
    const float* c = blk;  // at blk[count]: the first prefix > target
#pragma unroll
    for (int h = kBase / 2; h > 0; h >>= 1)
      if (__fadd_rn(c[h - 1], carry) <= target) {
        c += h;
        count += h;
      }
    if (__fadd_rn(*c, carry) <= target) ++count;
    count = min(count, lv - lane * kBase);
  }
  count = __reduce_add_sync(kFull, count);
  __syncwarp();  // tot and probs are rewritten by the next draw
  return min(count, D - 1);
}

// adj/wgt [n, D] (row v: its min(deg[v], D) live ids sorted, then PAD_ID
// and weight 0), deg [n], u0/v1 [W], rand [W, S] -> out [W, S]. kSmall:
// D <= 256 (draw_small), else draw_live. The small kernel is held to 64
// registers (8 blocks, 32 warps an SM), where it runs fastest.
template <bool kSmall>
__global__ void __launch_bounds__(kWarpsPerBlock* kWarp, kSmall ? 8 : 1)
    node2vec_walk_kernel(const int* __restrict__ adj,
                         const float* __restrict__ wgt,
                         const int* __restrict__ deg, int n,
                         const int* __restrict__ u0,
                         const int* __restrict__ v1,
                         const float* __restrict__ rand,
                         int* __restrict__ out, int W, int D, int S,
                         float p_inv, float q_inv, WalkPlan pl,
                         float* scratch) {
  // lanes of v's row loaded with deg[v]: a small row's first half, else
  // draw_live's first batch
  constexpr int B = kSmall ? kSmallLanes : kBatch;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wk = blockIdx.x * kWarpsPerBlock + warp;
  if (wk >= W) return;
  const int per = 2 * pl.prev + pl.probs + (pl.global_levels ? 0 : pl.levels);
  int* prev = reinterpret_cast<int*>(smem + warp * per);
  int* next = prev + pl.prev;
  float* probs = smem + warp * per + 2 * pl.prev;
  float* lvl = pl.global_levels ? scratch + (size_t)wk * pl.levels
                                : probs + pl.probs;
  int u = u0[wk], v = v1[wk];
  int lu = (unsigned)u < (unsigned)n ? min(max(deg[u], 0), D) : 0;
  if (pl.prev) {  // u0's live row (a small row PAD-filled to 256)
    for (int j = lane; j < (kSmall ? kSmallRow : lu); j += kWarp)
      prev[j] = j < lu ? adj[(size_t)u * D + j] : kPad;
    __syncwarp();
  }
  const size_t base = (size_t)wk * S;
  for (int s0 = 0; s0 < S; s0 += kWarp) {
    const float r_mine = s0 + lane < S ? rand[base + s0 + lane] : 0.0f;
    const int steps = min(kWarp, S - s0);
    int keep = 0;
    for (int j = 0; j < steps; ++j) {
      const float r = __shfl_sync(kFull, r_mine, j);
      int nxt = v, lv = 0;
      if ((unsigned)v < (unsigned)n) {
        const int* row = adj + (size_t)v * D;
        const float* wrow = wgt + (size_t)v * D;
        const int dv = deg[v];
        Batch<B> pre;
        const int* xs = row + lane;
        const float* ws = wrow + lane;
        if (D >= B * kWarp) {  // every lane in the row: no masks (path B)
#pragma unroll
          for (int t = 0; t < B; ++t) {
            pre.x[t] = xs[t * kWarp];
            pre.w[t] = ws[t * kWarp];
          }
        } else {
#pragma unroll
          for (int t = 0; t < B; ++t) {
            const bool in = t * kWarp + lane < D;
            pre.x[t] = in ? xs[t * kWarp] : kPad;
            pre.w[t] = in ? ws[t * kWarp] : 0.0f;
          }
        }
        lv = min(max(dv, 0), D);
        if (lv > 0) {  // else a dead end: stay (and never draw again)
          int slot;
          if constexpr (kSmall) {
            slot = draw_small(row, wrow, lv, D, u, lu, prev, next, probs,
                              probs + pl.probs, r, p_inv, q_inv, pre, lane);
          } else {
            const int* prev_row =
                pl.prev ? prev : adj + (size_t)min(max(u, 0), n - 1) * D;
            const Draw dr{row, wrow, lv, D, u, prev_row, lu, r, p_inv, q_inv};
            slot = draw_live(dr, nullptr, probs, lvl,
                             pl.prev ? next : nullptr, pre, true, lane);
          }
          nxt = slot < lv ? (pl.prev ? next[slot] : row[slot]) : kPad;
        }
      }
      if (lane == j) keep = nxt;
      u = v;
      v = nxt;
      lu = lv;
      int* done = prev;  // v's live ids become the next step's prev row
      prev = next;
      next = done;
    }
    if (s0 + lane < S) out[base + s0 + lane] = keep;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of global scratch per walker a live-lane draw of padded width d
// (prev rows of width dp) needs, 0 when its buffers fit in shared memory.
int node2vec_live_scratch_floats(int d, int dp) {
  const LivePlan pl = live_plan(d, dp);
  return pl.global_levels ? pl.levels : 0;
}

int node2vec_step_live_launch(const int* cand_ids, const float* cand_w,
                              const int* u, const int* prev_ids,
                              const float* rand, int* slot, int W, int D,
                              int DP, float p_inv, float q_inv,
                              float* scratch, cudaStream_t stream) {
  const LivePlan pl = live_plan(D, DP);
  if (pl.global_levels != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = live_smem(pl);
  cudaError_t err = prepare(node2vec_step_live_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  node2vec_step_live_kernel<<<cdiv(W, kWarpsPerBlock), kWarpsPerBlock * kWarp,
                              smem, stream>>>(cand_ids, cand_w, u, prev_ids,
                                              rand, slot, W, D, DP, p_inv,
                                              q_inv, pl.stage, pl.levels,
                                              scratch);
  return (int)cudaGetLastError();
}

int node2vec_step_layout_launch(const int* adj, const float* wgt, int cap,
                                const int* hot_adj, const float* hot_wgt,
                                int hot_cap, const int* hot_pos,
                                const int* deg, int n, const int* u,
                                const int* v, const float* rand, int* slot,
                                int* nxt, int W, float p_inv, float q_inv,
                                float* scratch, cudaStream_t stream) {
  const LivePlan pl = live_plan(hot_cap, hot_cap);
  if (pl.global_levels != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = live_smem(pl);
  cudaError_t err = prepare(node2vec_step_layout_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  node2vec_step_layout_kernel<<<cdiv(W, kWarpsPerBlock),
                                kWarpsPerBlock * kWarp, smem, stream>>>(
      adj, wgt, cap, hot_adj, hot_wgt, hot_cap, hot_pos, deg, n, u, v, rand,
      slot, nxt, W, p_inv, q_inv, pl.stage, pl.levels, scratch);
  return (int)cudaGetLastError();
}

// Floats of global scratch per walker the walk kernel at row width d
// needs, 0 when its buffers fit in shared memory.
int node2vec_walk_scratch_floats(int d) {
  const WalkPlan pl = walk_plan(d);
  return pl.global_levels ? pl.levels : 0;
}

int node2vec_walk_launch(const int* adj, const float* wgt, const int* deg,
                         int n, const int* u0, const int* v1,
                         const float* rand, int* out, int W, int D, int S,
                         float p_inv, float q_inv, float* scratch,
                         cudaStream_t stream) {
  const WalkPlan pl = walk_plan(D);
  if (pl.global_levels != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(pl);
  auto kernel = pl.small ? node2vec_walk_kernel<true>
                         : node2vec_walk_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<cdiv(W, kWarpsPerBlock), kWarpsPerBlock * kWarp, smem, stream>>>(
      adj, wgt, deg, n, u0, v1, rand, out, W, D, S, p_inv, q_inv, pl,
      scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"

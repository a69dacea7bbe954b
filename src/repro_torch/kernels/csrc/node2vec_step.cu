// Exact second-order node2vec draws on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/node2vec_step.py:
//   node2vec_step_kernel  <- node2vec_step (_step_kernel): one draw per walker
//   node2vec_walk_kernel  <- node2vec_walk (_walk_kernel): steps 1..L-1 of an
//                            exact walk, the prev row carried on chip
//
// What one draw computes (the contract of repro_torch.engine.sampler.
// exact_slots, bit for bit):
//   member[j] = cand[j] in the sorted prev row  (binary search)
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
// Design: one warp per walker. The warp writes the row's probabilities into a
// per-warp scan buffer, scans it level by level (each lane owns one 16-lane
// block at a time), then counts. Level 0 is stored skewed (element i at
// i + i/16) so the 32 lanes scanning 32 blocks hit 32 different banks. The
// buffer lives in shared memory when it fits, else in a global scratch the
// wrapper allocates (node2vec_scratch_floats says which). Both kernels are
// bound by device-memory bytes: each candidate row, weight row and prev row is
// read once per draw (the walk kernel reads its prev row from on chip).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 0x7fffffff;
constexpr int kBase = 16;
constexpr int kWarp = 32;
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr size_t kSmemBudget = 96 * 1024;  // per block, of the 227 KB

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int skew(int i) { return i + i / kBase; }

// Floats of scan buffer for a row of width d: every level stored skewed.
__host__ __device__ inline int scan_floats(int d) {
  int total = 0, n = d;
  while (true) {
    total += (kBase + 1) * cdiv(n, kBase);
    if (n <= kBase) break;
    n = cdiv(n, kBase);
  }
  return total;
}

// Warp-cooperative inclusive scan of buf[skew(0..d-1)] (level 0) in the
// base-16 blocked order. Higher levels follow level 0 in buf.
__device__ void blocked_scan(float* buf, int d, int lane) {
  int offs[kMaxLevels], sizes[kMaxLevels];
  int levels = 0, off = 0, n = d;
  // up: scan inside each block, block totals into the next level
  while (n > kBase) {
    const int nb = cdiv(n, kBase);
    const int next = off + (kBase + 1) * nb;
    for (int b = lane; b < nb; b += kWarp) {
      float acc = 0.0f;
      const int hi = min(kBase, n - b * kBase);
      float* blk = buf + off + b * (kBase + 1);
      for (int j = 0; j < hi; ++j) {
        acc = __fadd_rn(acc, blk[j]);
        blk[j] = acc;
      }
      buf[next + skew(b)] = acc;
    }
    __syncwarp();
    offs[levels] = off;
    sizes[levels] = n;
    ++levels;
    off = next;
    n = nb;
  }
  // top level (<= 16 entries): one sequential scan
  if (lane == 0) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      acc = __fadd_rn(acc, buf[off + j]);
      buf[off + j] = acc;
    }
  }
  __syncwarp();
  // down: add each block's exclusive carry (the previous block's inclusive
  // total, from the finished level above)
  for (int l = levels - 1; l >= 0; --l) {
    const int lo = offs[l], sz = sizes[l];
    const int up = (l + 1 < levels) ? offs[l + 1] : off;
    for (int i = lane + kBase; i < sz; i += kWarp) {
      const int b = i / kBase;
      buf[lo + skew(i)] = __fadd_rn(buf[lo + skew(i)], buf[up + skew(b - 1)]);
    }
    __syncwarp();
  }
}

__device__ inline bool in_sorted(const int* row, int n, int x) {
  int lo = 0, hi = n;  // lower_bound
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return row[min(lo, n - 1)] == x;
}

// One exact draw for the walker this warp serves; every lane returns the slot.
__device__ int draw_slot(const int* cand, const float* w, int u,
                         const int* prev, int dp, int d, float r, float p_inv,
                         float q_inv, float* buf, int lane) {
  for (int j = lane; j < d; j += kWarp) {
    const int x = cand[j];
    float prob = 0.0f;
    if (x != kPad) {
      const float alpha = (x == u) ? p_inv
                          : (in_sorted(prev, dp, x) ? 1.0f : q_inv);
      prob = __fmul_rn(alpha, w[j]);
    }
    buf[skew(j)] = prob;
  }
  __syncwarp();
  blocked_scan(buf, d, lane);
  const float target = __fmul_rn(r, buf[skew(d - 1)]);
  int count = 0;
  for (int j = lane; j < d; j += kWarp)
    count += (cand[j] != kPad && buf[skew(j)] <= target) ? 1 : 0;
  count = __reduce_add_sync(kFull, count);
  __syncwarp();  // buf is reused by the next draw
  return min(count, d - 1);
}

__global__ void node2vec_step_kernel(const int* __restrict__ cand_ids,
                                     const float* __restrict__ cand_w,
                                     const int* __restrict__ u,
                                     const int* __restrict__ prev_ids,
                                     const float* __restrict__ rand,
                                     int* __restrict__ slot, int W, int D,
                                     int DP, float p_inv, float q_inv,
                                     float* scratch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wk = blockIdx.x * kWarpsPerBlock + warp;
  if (wk >= W) return;
  const int per = scan_floats(D);
  float* buf = scratch ? scratch + (size_t)wk * per : smem + warp * per;
  const int s = draw_slot(cand_ids + (size_t)wk * D, cand_w + (size_t)wk * D,
                          u[wk], prev_ids + (size_t)wk * DP, DP, D, rand[wk],
                          p_inv, q_inv, buf, lane);
  if (lane == 0) slot[wk] = s;
}

__global__ void node2vec_walk_kernel(const int* __restrict__ adj,
                                     const float* __restrict__ wgt,
                                     const int* __restrict__ deg,
                                     const int* __restrict__ u0,
                                     const int* __restrict__ v1,
                                     const float* __restrict__ rand,
                                     int* __restrict__ out, int W, int D,
                                     int S, float p_inv, float q_inv,
                                     float* scratch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wk = blockIdx.x * kWarpsPerBlock + warp;
  if (wk >= W) return;
  const int per = scan_floats(D) + D;  // scan buffer, then the prev row
  float* buf = scratch ? scratch + (size_t)wk * per : smem + warp * per;
  int* prev = reinterpret_cast<int*>(buf + scan_floats(D));
  int u = u0[wk], v = v1[wk];
  for (int j = lane; j < D; j += kWarp) prev[j] = adj[(size_t)u * D + j];
  __syncwarp();
  for (int s = 0; s < S; ++s) {
    const int* cand = adj + (size_t)v * D;
    const int slot = draw_slot(cand, wgt + (size_t)v * D, u, prev, D, D,
                               rand[(size_t)wk * S + s], p_inv, q_inv, buf,
                               lane);
    const int nxt = deg[v] > 0 ? cand[slot] : v;  // dead end: stay
    for (int j = lane; j < D; j += kWarp) prev[j] = cand[j];
    __syncwarp();
    if (lane == 0) out[(size_t)wk * S + s] = nxt;
    u = v;
    v = nxt;
  }
}

// Shared memory a block needs, or 0 when a warp's buffer does not fit and
// the launch must use global scratch.
size_t smem_bytes(int per_warp_floats) {
  const size_t bytes = (size_t)kWarpsPerBlock * per_warp_floats * 4;
  return bytes <= kSmemBudget ? bytes : 0;
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

// Floats of global scratch per walker the kernel needs, 0 when it works in
// shared memory. with_prev: 1 for node2vec_walk (the prev row rides along).
int node2vec_scratch_floats(int d, int with_prev) {
  const int per = scan_floats(d) + (with_prev ? d : 0);
  return smem_bytes(per) ? 0 : per;
}

int node2vec_step_launch(const int* cand_ids, const float* cand_w,
                         const int* u, const int* prev_ids, const float* rand,
                         int* slot, int W, int D, int DP, float p_inv,
                         float q_inv, float* scratch, cudaStream_t stream) {
  const size_t smem = scratch ? 0 : smem_bytes(scan_floats(D));
  if (!scratch && smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(node2vec_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = cdiv(W, kWarpsPerBlock);
  node2vec_step_kernel<<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      cand_ids, cand_w, u, prev_ids, rand, slot, W, D, DP, p_inv, q_inv,
      scratch);
  return (int)cudaGetLastError();
}

int node2vec_walk_launch(const int* adj, const float* wgt, const int* deg,
                         const int* u0, const int* v1, const float* rand,
                         int* out, int W, int D, int S, float p_inv,
                         float q_inv, float* scratch, cudaStream_t stream) {
  const size_t smem = scratch ? 0 : smem_bytes(scan_floats(D) + D);
  if (!scratch && smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(node2vec_walk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = cdiv(W, kWarpsPerBlock);
  node2vec_walk_kernel<<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      adj, wgt, deg, u0, v1, rand, out, W, D, S, p_inv, q_inv, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"

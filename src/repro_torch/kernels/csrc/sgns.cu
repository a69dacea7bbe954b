// Fused SGNS forward + backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.sgns.sgns_fused
// (src/repro/kernels/sgns.py, body _sgns_kernel). For gathered rows
// ci, po [B, D], no [B, K, D] and a row mask valid [B] it computes, per row,
//
//   x_p = ci . po              x_k = ci . no_k
//   loss   = valid * (softplus(-x_p) + sum_k softplus(x_k))
//   g_po   = (sigmoid(x_p) - 1) * valid * ci
//   g_no_k = sigmoid(x_k) * valid * ci
//   g_ci   = (sigmoid(x_p) - 1) * valid * po + sum_k sigmoid(x_k) * valid * no_k
//
// and the loss summed over rows. softplus(x) = max(x, 0) + log1p(exp(-|x|)),
// which is logaddexp(0, x). Any B >= 0, K >= 1, D >= 1: the TPU's 128-lane
// and block-multiple padding does not carry over.
//
// What bounds it: bytes. Each of ci, po, no is read once and each grad
// written once, 8 * B * D * (2 + K) bytes in all (7.3 MB at the main path's
// B = 1024, K = 5, D = 128: about 2.2 us at 3.35 TB/s), against ~5 K D flops
// a row. At that batch one launch is latency-bound, not bandwidth-bound.
//
// Design. One warp per row, eight rows per block, so every block has
// enough independent loads in flight; each lane strides over D, so a warp's
// loads are coalesced. A lane reads ci, po and each no_k for the 1 + K dot
// products, which reduce with a fixed __shfl_xor_sync tree (the same order
// every run). The grads are written in a second pass over the same
// addresses by the same lane, which reads the row again: those reads are
// meant to hit the cache the first pass filled, so that device memory sees
// each input once (chip_smoke.py's B = 65,536 time beside its bound says
// how near that comes). The negatives' coefficients sigmoid(x_k) * valid sit in a 32-float
// slot of shared memory per warp, so negatives are taken in chunks of 32:
// one chunk (one pass pair) for K <= 32; past that, each chunk adds to g_ci
// where the one before left it, in the same order. Nothing depends on D or
// K beyond that, so any shape takes the one path. The Pallas kernel carried
// the loss across its sequential grid; here blocks run in no order, so each
// block writes a partial sum and a second one-block pass sums the partials
// in a fixed order: the loss is bit-stable from run to run, with no atomics.
// Built with --fmad=false, so nothing contracts to FMA.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                 // rows per block
constexpr int kSumThreads = 256;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void sgns_fused_kernel(const float* __restrict__ ci,
                                  const float* __restrict__ po,
                                  const float* __restrict__ no,
                                  const float* __restrict__ valid,
                                  float* __restrict__ partial,
                                  float* __restrict__ g_ci,
                                  float* __restrict__ g_po,
                                  float* __restrict__ g_no,
                                  int b_rows, int k, int d) {
  __shared__ float coef_s[kWarps][kWarp];   // sigmoid(x_k) * valid, a chunk
  __shared__ float warp_loss[kWarps];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  float* coef = coef_s[warp];
  const long long b = (long long)blockIdx.x * kWarps + warp;
  float loss = 0.0f;
  if (b < b_rows) {
    const float* ci_b = ci + b * d;
    const float* po_b = po + b * d;
    const float* no_b = no + b * (long long)k * d;
    float* gci_b = g_ci + b * d;
    float* gpo_b = g_po + b * d;
    float* gno_b = g_no + b * (long long)k * d;
    const float v = valid[b];

    float acc = 0.0f;
    for (int j = lane; j < d; j += kWarp) acc += ci_b[j] * po_b[j];
    const float x_p = warp_sum(acc);
    loss = softplus(-x_p);
    const float coef_p = (sigmoid(x_p) - 1.0f) * v;
    for (int n0 = 0; n0 < k; n0 += kWarp) {
      const int kc = min(kWarp, k - n0);
      // pass 1: this chunk's dot products
      for (int n = 0; n < kc; ++n) {
        const float* no_n = no_b + (long long)(n0 + n) * d;
        acc = 0.0f;
        for (int j = lane; j < d; j += kWarp) acc += ci_b[j] * no_n[j];
        const float x_n = warp_sum(acc);
        loss += softplus(x_n);
        if (lane == 0) coef[n] = sigmoid(x_n) * v;
      }
      __syncwarp();
      // pass 2: the grads of this chunk, each written once
      for (int j = lane; j < d; j += kWarp) {
        const float c = ci_b[j];
        float g;
        if (n0 == 0) {
          g = coef_p * po_b[j];
          gpo_b[j] = coef_p * c;
        } else {
          g = gci_b[j];
        }
        for (int n = 0; n < kc; ++n) {
          const long long at = (long long)(n0 + n) * d + j;
          const float w = coef[n];
          g += w * no_b[at];
          gno_b[at] = w * c;
        }
        gci_b[j] = g;
      }
      __syncwarp();
    }
    loss *= v;
  }
  if (lane == 0) warp_loss[warp] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_loss[w];
    partial[blockIdx.x] = s;
  }
}

// One block: each thread sums a strided slice in order, then a fixed tree.
__global__ void sgns_loss_sum_kernel(const float* __restrict__ partial,
                                     int n, float* __restrict__ out) {
  __shared__ float buf[kSumThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

}  // namespace

extern "C" {

// Number of per-block partial sums a launch over B rows writes: the size of
// the scratch the caller allocates.
int sgns_fused_blocks(int b_rows) { return (b_rows + kWarps - 1) / kWarps; }

// loss [1] receives the masked loss sum; partial holds
// sgns_fused_blocks(B) floats of scratch. Returns cudaGetLastError().
int sgns_fused_launch(const float* ci, const float* po, const float* no,
                      const float* valid, float* partial, float* loss,
                      float* g_ci, float* g_po, float* g_no, int b_rows,
                      int k, int d, void* stream) {
  const int blocks = sgns_fused_blocks(b_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    sgns_fused_kernel<<<blocks, kWarps * kWarp, 0, s>>>(
        ci, po, no, valid, partial, g_ci, g_po, g_no, b_rows, k, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  sgns_loss_sum_kernel<<<1, kSumThreads, 0, s>>>(partial, blocks, loss);
  return (int)cudaGetLastError();
}

}  // extern "C"

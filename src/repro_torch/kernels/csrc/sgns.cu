// Fused SGNS forward + backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.sgns.sgns_fused
// (src/repro/kernels/sgns.py, body _sgns_kernel). For rows ci, po [B, D],
// no [B, K, D] and a row mask valid [B] it computes, per row,
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
// Two entries, one body (sgns_kernel<kTables>):
//   * rows: ci, po, no given as [B, D] / [B, K, D] tensors (the JAX kernel's
//     contract);
//   * tables: the rows read in place, ci = emb_in[center[b]],
//     po = emb_out[pos[b]], no_k = emb_out[negs[b, k]] (int32 indices), and
//     every output (the three grads and the loss sum) divided by the device
//     scalar denom with IEEE division: the same bits as gathering the rows,
//     running the row entry and dividing after it, with no gather copies and
//     no division passes.
//
// What bounds it: bytes. Each row of ci, po, no is read once and each grad
// written once, 8 * B * D * (2 + K) bytes in all (7.3 MB at the main path's
// B = 1024, K = 5, D = 128: about 2.2 us at 3.35 TB/s), against ~5 K D flops
// a row. At that batch one launch is latency-bound: 128 blocks, one wave.
//
// Design. One warp per row, eight rows per block, four blocks an SM (64
// registers a thread); each lane strides over D, so a warp's loads are
// coalesced. The dot products of po and of up to eight negatives are taken
// in one sweep over D with one accumulator each, unrolled four lanes deep,
// so the loads of all those rows are in flight together (each accumulator
// still sums its lanes in the same order). They reduce with a fixed
// __shfl_xor_sync tree. The grads are written in a second pass over the
// same addresses by the same lane, which reads the rows again from the
// cache the first pass filled. The negatives' coefficients
// sigmoid(x_k) * valid and their rows' addresses sit in 32-entry slots of
// shared memory per warp (no index is loaded again in the second pass), so
// the second pass takes the negatives in chunks of 32, each adding to g_ci
// where the one before left it (divided by denom only after the last). Each
// block writes a partial loss sum; the last block to finish (a counter that
// it resets) sums the partials in a fixed order, so the loss is bit-stable
// from run to run with no float atomics. Built with --fmad=false, so
// nothing contracts to FMA.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                 // rows per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kGroup = 8;                 // negatives per sweep over D

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

struct Args {
  const float* ci;      // rows: [B, D]; tables: emb_in [V, D]
  const float* po;      // rows: [B, D]; tables: emb_out [V, D]
  const float* no;      // rows: [B, K, D]; tables: emb_out
  const int* center;    // tables only
  const int* pos;
  const int* negs;      // [B, K]
  const float* valid;
  const float* denom;   // tables only: a device scalar
  float* partial;       // one per block
  unsigned* counter;    // blocks finished; 0 between launches
  float* loss;
  float* g_ci;
  float* g_po;
  float* g_no;
  int b_rows, k, d;
};

template <bool kTables>
__device__ __forceinline__ const float* neg_row(const Args& a, long long b,
                                                int n) {
  return kTables ? a.no + (long long)a.negs[b * a.k + n] * a.d
                 : a.no + (b * a.k + n) * (long long)a.d;
}

template <bool kTables>
__device__ __forceinline__ float scaled(float x, float den) {
  return kTables ? __fdiv_rn(x, den) : x;
}

// The loss partials of every block, summed by the last block to finish in
// a fixed order: each thread a strided slice in order, then a fixed tree.
__device__ void sum_partials(const Args& a, float den, bool tables) {
  __shared__ float buf[kThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    s += __ldcg(a.partial + i);
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.loss[0] = tables ? __fdiv_rn(buf[0], den) : buf[0];
    *a.counter = 0u;
  }
}

template <bool kTables>
__global__ void __launch_bounds__(kThreads, 4) sgns_kernel(Args a) {
  __shared__ float coef_s[kWarps][kWarp];   // sigmoid(x_k) * valid, a chunk
  __shared__ const float* nrow_s[kWarps][kWarp];  // the chunk's rows of no
  __shared__ float warp_loss[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int d = a.d, k = a.k;
  float* coef = coef_s[warp];
  const float** nrow = nrow_s[warp];
  const long long b = (long long)blockIdx.x * kWarps + warp;
  const float den = kTables ? *a.denom : 1.0f;
  float loss = 0.0f;
  if (b < a.b_rows) {
    const float* ci_b = kTables ? a.ci + (long long)a.center[b] * d
                                : a.ci + b * d;
    const float* po_b = kTables ? a.po + (long long)a.pos[b] * d
                                : a.po + b * d;
    float* gci_b = a.g_ci + b * d;
    float* gpo_b = a.g_po + b * d;
    float* gno_b = a.g_no + b * (long long)k * d;
    const float v = a.valid[b];
    float coef_p = 0.0f;
    for (int n0 = 0; n0 < k; n0 += kWarp) {
      const int kc = min(kWarp, k - n0);
      // pass 1: this chunk's dot products, kGroup negatives a sweep (po
      // rides along in the first)
      for (int g0 = 0; g0 < kc; g0 += kGroup) {
        const bool with_p = n0 == 0 && g0 == 0;
        const int gk = min(kGroup, kc - g0);
        const float* rows[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          rows[i] = i < gk ? neg_row<kTables>(a, b, n0 + g0 + i) : nullptr;
          if (lane == 0 && i < gk) nrow[g0 + i] = rows[i];
        }
        float acc_p = 0.0f, acc[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
#pragma unroll 4
        for (int j = lane; j < d; j += kWarp) {
          const float c = ci_b[j];
          if (with_p) acc_p += c * po_b[j];
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
            if (i < gk) acc[i] += c * rows[i][j];
        }
        if (with_p) {
          const float x_p = warp_sum(acc_p);
          loss = softplus(-x_p);
          coef_p = (sigmoid(x_p) - 1.0f) * v;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < gk) {
            const float x_n = warp_sum(acc[i]);
            loss += softplus(x_n);
            if (lane == 0) coef[g0 + i] = sigmoid(x_n) * v;
          }
        }
      }
      __syncwarp();
      // pass 2: the grads of this chunk, each written once
      const bool final_chunk = n0 + kWarp >= k;
      for (int j = lane; j < d; j += kWarp) {
        const float c = ci_b[j];
        float g;
        if (n0 == 0) {
          g = coef_p * po_b[j];
          gpo_b[j] = scaled<kTables>(coef_p * c, den);
        } else {
          g = gci_b[j];
        }
        for (int n = 0; n < kc; ++n) {
          const float w = coef[n];
          g += w * nrow[n][j];
          gno_b[(long long)(n0 + n) * d + j] = scaled<kTables>(w * c, den);
        }
        gci_b[j] = final_chunk ? scaled<kTables>(g, den) : g;
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
    a.partial[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    sum_partials(a, den, kTables);
  }
}

cudaError_t launch(bool tables, const Args& a, void* stream) {
  const int blocks = (a.b_rows + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables)
    sgns_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    sgns_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of per-block partial sums a launch over B rows writes: scratch the
// caller allocates beside the outputs.
int sgns_fused_blocks(int b_rows) { return (b_rows + kWarps - 1) / kWarps; }

// Row entry. loss [1] receives the masked loss sum; partial holds
// sgns_fused_blocks(B) floats; counter is one unsigned that is 0 between
// launches (the launch leaves it 0). B >= 1. Returns cudaGetLastError().
int sgns_fused_launch(const float* ci, const float* po, const float* no,
                      const float* valid, float* partial, unsigned* counter,
                      float* loss, float* g_ci, float* g_po, float* g_no,
                      int b_rows, int k, int d, void* stream) {
  const Args a{ci, po, no, nullptr, nullptr, nullptr, valid, nullptr,
               partial, counter, loss, g_ci, g_po, g_no, b_rows, k, d};
  return (int)launch(false, a, stream);
}

// Table entry: rows read in place from emb_in / emb_out at int32 indices
// center [B], pos [B], negs [B, K]; the loss sum and the grads divided by
// denom [1] (a device scalar). The rest as the row entry.
int sgns_fused_tables_launch(const float* emb_in, const float* emb_out,
                             const int* center, const int* pos,
                             const int* negs, const float* valid,
                             const float* denom, float* partial,
                             unsigned* counter, float* loss, float* g_ci,
                             float* g_po, float* g_no, int b_rows, int k,
                             int d, void* stream) {
  const Args a{emb_in, emb_out, emb_out, center, pos, negs, valid, denom,
               partial, counter, loss, g_ci, g_po, g_no, b_rows, k, d};
  return (int)launch(true, a, stream);
}

}  // extern "C"

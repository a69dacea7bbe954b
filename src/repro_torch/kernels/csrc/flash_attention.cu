// Causal / sliding-window flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py, body _flash_kernel) together with
// its padding wrapper repro.kernels.ops.flash_attention_op. On the model
// layout q [B, S, H, dh], k, v [B, S, KV, dh] (float32 or bfloat16; H a
// multiple of KV) it computes, for each (b, h, query row i),
//
//   s_j = (q_i . k_j) * dh^-0.5 over the keys j the mask lets through:
//         j <= i when causal, and j > i - window when window > 0,
//   o_i = sum_j softmax(s)_j v_j
//
// with head h reading KV head h / (H / KV) in place: no GQA repeat, no
// [B*H, S, dh] transpose, and no padding of S to the block or of dh to 128
// lanes (the TPU's tiling; rows past S and lanes past dh are zero-filled in
// shared memory and never written). All arithmetic is float32 whatever the
// input type: scores, the online softmax's running max m, denominator l and
// accumulator, and o = acc / max(l, 1e-30) at the end, cast to q's type
// once. A masked score never contributes (its weight is 0), which gives the
// reference's -1e30 semantics on every row that has an unmasked key (every
// causal row has its own position).
//
// What bounds it: operations. The causal work is 4 * dh flops per unmasked
// (query, key) pair; at the serving path's B = 4, S = 4096, H = 32, dh = 128
// that is ~5.5e11 flops against ~0.3 GB of q, k, v and o. This first
// version does them on the float32 SIMT cores (fused multiply-adds written
// out, since the build passes --fmad=false), not on the tensor cores, so it
// sits far above the bf16 tensor-core bound; wgmma, TMA and warp
// specialisation are a later change.
//
// Design. One block of 256 threads per (q tile of 64 rows, b * H + h); the
// tiles of the longest causal rows are started first. The block keeps its
// scaled q tile, one 64-key tile of k and of v, and the tile's softmax
// weights in shared memory (float32, rows padded by one float so that the
// column reads below do not conflict), and walks the key tiles from the
// window's lower bound to the causal frontier only, as the Pallas kernel
// does. Thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3:
// it computes their scores against keys tx + 16 j (j < 4), reduces the rows'
// max and sum across the 16 threads of its half-warp with a fixed
// __shfl_xor_sync tree, and accumulates output lanes tx + 16 c (c < D / 16)
// of the same rows in registers. Every sum runs in a fixed order, so a
// launch repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBq = 64;           // query rows a block
constexpr int kBk = 64;           // keys a tile
constexpr int kThreads = 256;
constexpr int kRows = 4;          // query rows a thread
constexpr int kCols = 4;          // keys a thread, per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return kBq * (D + 1) + 2 * kBk * (D + 1) + kBq * (kBk + 1);
}

// Copy rows [row0, row0 + n_rows) of one head into a [n_rows][D + 1] float
// tile, scaled; rows past s_len and lanes past dh are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int row0,
                                          int n_rows, int s_len, int dh,
                                          float scale) {
  for (int i = threadIdx.x; i < n_rows * D; i += kThreads) {
    const int r = i / D, c = i % D, s = row0 + r;
    float x = 0.0f;
    if (s < s_len && c < dh) x = load_f(base + s * row_stride + c) * scale;
    tile[r * (D + 1) + c] = x;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s_len,
                       int heads, int kv_heads, int dh, float scale,
                       int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int LP = kBk + 1;
  constexpr int kOut = D / 16;     // output lanes a thread
  extern __shared__ float smem[];
  float* qs = smem;                // [kBq][LD], scaled by dh^-0.5
  float* ks = qs + kBq * LD;       // [kBk][LD]
  float* vs = ks + kBk * LD;       // [kBk][LD]
  float* ps = vs + kBk * LD;       // [kBq][LP], the tile's weights

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;   // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const long long q_stride = (long long)heads * dh;    // one sequence step
  const long long kv_stride = (long long)kv_heads * dh;
  const T* q_bh = q + ((long long)b * s_len * heads + h) * dh;
  const T* k_bh = k + ((long long)b * s_len * kv_heads + kvh) * dh;
  const T* v_bh = v + ((long long)b * s_len * kv_heads + kvh) * dh;
  T* o_bh = o + ((long long)b * s_len * heads + h) * dh;

  load_tile<D>(qs, q_bh, q_stride, q0, kBq, s_len, dh, scale);

  // the key tiles any row of this block can see
  const int q_last = min(q0 + kBq - 1, s_len - 1);
  const int k_hi = causal ? q_last : s_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = k_lo / kBk; kt <= k_hi / kBk; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();               // the last tile's k, v and weights are used
    load_tile<D>(ks, k_bh, kv_stride, k0, kBk, s_len, dh, 1.0f);
    load_tile<D>(vs, v_bh, kv_stride, k0, kBk, s_len, dh, 1.0f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < s_len && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of the row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty * kRows + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();               // every row's weights are in ps

#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float p[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty * kRows + i) * LP + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) vv[c] = vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty * kRows + i;
    if (s >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store_f(o_bh + s * q_stride + col, acc[i][c] / denom);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s_len, int heads, int kv_heads, int dh, float scale, int causal,
           int window, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kernel = flash_attention_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s_len + kBq - 1) / kBq, b * heads);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s_len, heads, kv_heads,
      dh, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b,
              int s_len, int heads, int kv_heads, int dh, float scale,
              int causal, int window, cudaStream_t stream) {
  // dh is rounded up to the next tile width; the extra lanes are zero
  if (dh <= 16)
    return launch<16, T>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale,
                         causal, window, stream);
  if (dh <= 32)
    return launch<32, T>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale,
                         causal, window, stream);
  if (dh <= 64)
    return launch<64, T>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale,
                         causal, window, stream);
  if (dh <= 128)
    return launch<128, T>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale,
                          causal, window, stream);
  return launch<256, T>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale,
                        causal, window, stream);
}

}  // namespace

extern "C" {

// q [B, S, H, dh], k, v [B, S, KV, dh], o [B, S, H, dh], all contiguous and
// of one type: bf16 != 0 for bfloat16, else float32. B * H <= 65535,
// 1 <= dh <= 256, S >= 1. Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int s_len, int heads, int kv_heads,
                           int dh, float scale, int causal, int window,
                           int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, b, s_len, heads, kv_heads, dh,
                                    scale, causal, window, st);
  return launch_dh<float>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale,
                          causal, window, st);
}

}  // extern "C"

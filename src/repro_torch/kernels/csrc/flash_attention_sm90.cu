// Causal / sliding-window flash attention, forward, in bf16 on the tensor
// cores of Hopper (sm_90a): the bf16 route of the port's flash_attention.
//
// Replaces, with flash_attention.cu (the float32 SIMT route), the Pallas TPU
// kernel repro.kernels.flash_attention.flash_attention (body _flash_kernel)
// and its padding wrapper repro.kernels.ops.flash_attention_op. On the
// model layout q [B, S, H, dh], k, v [B, S, KV, dh], all bfloat16, dh a
// multiple of 16 up to 256, H a multiple of KV, it computes for each
// (b, h, query row i)
//
//   s_j = (q_i . k_j) * dh^-0.5 over the keys j the mask lets through:
//         j <= i when causal, and j > i - window when window > 0,
//   o_i = sum_j softmax(s)_j v_j
//
// with head h reading KV head h / (H / KV) in place. Numerics: q . k in
// float32 on the tensor cores (bf16 products, f32 sums), the scale applied
// in float32 after the product, the online softmax (running max m, sum l)
// in float32 with exp2 and log2(e) * scale folded in, a masked score weight
// exactly 0. The float32 weights P enter the P . V product as two bf16
// parts, hi = bf16(p) and lo = bf16(p - hi), which sum to p within about
// 2^-16 of it, and two products: one bf16 rounding of P moves outputs of
// the serving path's first layer past its (atol 2e-3, rtol 1e-2) check
// against the plain version (chip_smoke.py counts them). l sums the
// float32 weights. o = acc / max(l, 1e-30), cast to bf16 once. Rows past
// S and lanes past dh are never written.
//
// What bounds it: operations. The function needs 4 * dh flops per
// unmasked (query, key) pair, ~5.5e11 at the serving path's B = 4,
// S = 4,096, H = 32, dh = 128 against ~0.3 GB of q, k, v and o: 0.56 ms at
// the bf16 tensor-core peak, 0.09 ms at the memory rate. The kernel does
// 6 * dh (the second P . V product) on whole tiles.
//
// Design. One block per (b * H + h, 128-row q tile), the tiles of the
// longest causal rows first. 384 threads: two consumer warpgroups of 64 q
// rows each and one producer warpgroup, which hands most of its registers
// to them (setmaxnreg). The producer's first thread loads the q
// tile once, then streams the key tiles from the window's lower bound to
// the causal frontier through a two-stage ring of K and V tiles (128 keys
// at dh <= 128, 64 at dh = 256), each filled by TMA from rank-4 tensor
// maps over (dh, heads, S, B): rows past S and lanes past dh arrive as
// zeros, never from the next sequence. Each stage has a full barrier for K
// and one for V (TMA bytes) and one empty barrier (an arrival from each
// consumer warp). The head is padded to D = 64, 128 or 256 lanes in shared
// memory, in 64-lane (128-byte) column blocks with the 128-byte swizzle.
// A consumer warpgroup computes S = Q K^T with wgmma (both operands in
// shared memory, K-major), masks only the tiles that the causal frontier,
// the window or S cut, does the online softmax on the accumulator
// registers (each row's max and sum across the quad of threads that hold
// it, two shuffles), rescales its output accumulator, packs P to bf16 in
// registers (the accumulator's layout is wgmma's register-A fragment) and
// accumulates O += P V with wgmma (V from shared memory through the
// transpose bit). The two warpgroups run independently, so one's softmax
// overlaps the other's products. Every sum runs in a fixed order and no
// atomics are used, so a launch repeats bit for bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBq = 128;                  // q rows a block
constexpr int kGroups = 2;                // consumer warpgroups, 64 rows each
constexpr int kThreads = (kGroups + 1) * 128;   // + the producer warpgroup
constexpr int kProducerRegs = 24;         // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;        // 128 * (24 + 2 * 240) <= 65,536
constexpr int kStages = 2;                // ring of K and V tiles
constexpr int kRowBytes = 128;            // one swizzled row: 64 bf16

template <int D>
struct Tiles {
  static constexpr int kBk = D <= 128 ? 128 : 64;    // keys a tile
  static constexpr int kBlocks = D / 64;             // 64-lane column blocks
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kKVBytes = kBk * D * 2;       // one K or V tile
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two weights as bf16 pairs hi and lo with a = hi.x + lo.x and b = hi.y +
// lo.y to about 2^-16 of each (a - hi.x is exact in float32).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// S = Q K^T for one warpgroup: q_wg its 64 rows of the q tile, kt a key
// tile; lanes 16 kk .. 16 kk + 15 are column block kk / 4, 32 bytes a step
// within its rows (the swizzle applies to the absolute address). Started
// as one committed wgmma group, not waited for.
template <int D>
__device__ __forceinline__ void async_qk(float* s, const uint8_t* q_wg,
                                         const uint8_t* kt) {
  constexpr int Bk = Tiles<D>::kBk;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    const uint64_t da =
        desc_sw128(q_wg + (kk / 4) * kBq * kRowBytes + off, 16, 1024);
    const uint64_t db =
        desc_sw128(kt + (kk / 4) * Bk * kRowBytes + off, 16, 1024);
    if constexpr (Bk == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc += P V as P_hi V + P_lo V: P from registers (pa[0] the hi parts,
// pa[1] the lo parts), vt a value tile, whose keys 16 kk .. + 15 are two
// 8-row groups 1,024 bytes apart and whose column blocks are Bk * 128
// bytes apart. Started as one committed wgmma group, not waited for.
template <int D, int Bk = Tiles<D>::kBk>
__device__ __forceinline__ void async_pv(float* acc,
                                         uint32_t (*pa)[Bk / 16][4],
                                         const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < Bk / 16; ++kk) {
    const uint8_t* vk = vt + 16 * kk * kRowBytes;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      if constexpr (D == 64) {
        wgmma_rs_n64(acc, pa[part][kk],
                     desc_sw128(vk, Bk * kRowBytes, 1024), 1);
      } else {
#pragma unroll
        for (int n = 0; n < D / 128; ++n)
          wgmma_rs_n128(acc + 64 * n, pa[part][kk],
                        desc_sw128(vk + 2 * n * Bk * kRowBytes,
                                   Bk * kRowBytes, 1024), 1);
      }
    }
  }
  wgmma_commit();
}

// A consumer warpgroup: rows r_lo .. r_lo + 63 of the q tile, against the
// block's n_tiles key tiles from tile kt0 on.
template <int D>
__device__ __forceinline__ void consume(
    const uint8_t* qs, const uint8_t* ks, const uint8_t* vs,
    uint64_t* full_q, uint64_t* full_k, uint64_t* full_v, uint64_t* empty,
    __nv_bfloat16* __restrict__ o, int wg, int b, int h, int q0, int kt0,
    int n_tiles, int s_len, int heads, int dh, float scale_log2, int causal,
    int window) {
  using T = Tiles<D>;
  constexpr int Bk = T::kBk;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;
  const int row0 = r_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);                // + 8 j + c in a tile
  const uint8_t* q_wg = qs + 64 * wg * kRowBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  mbar_wait(full_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (kt0 + i) * Bk;
    // a warpgroup past S, or wholly before this tile, has nothing to add,
    // but still waits for the tile: an arrival on `empty` may not run
    // ahead of the other warpgroup's by a whole ring
    mbar_wait(full_k + st, phase);
    if (r_lo >= s_len || (causal && k0 > r_hi)) {
      mbar_wait(full_v + st, phase);
    } else {
      float s[Bk / 2];
      wgmma_fence();
      async_qk<D>(s, q_wg, ks + st * T::kKVBytes);
      wgmma_wait();
      fence_regs<Bk / 2>(s);

      // mask only a tile that the frontier, the window or S cuts
      const bool masked = (causal && k0 + Bk - 1 > r_lo) ||
                          (window > 0 && k0 <= r_hi - window) ||
                          k0 + Bk > s_len;
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < Bk / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * j + 2 * r + c];
            if (masked) {
              const int kpos = k0 + 8 * j + col0 + c;
              const bool ok = kpos < s_len && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
              if (!ok) x = -INFINITY;
            }
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        // a row with no visible key yet keeps weights 0 (exp2(-inf))
        const float m_use = m_new == -INFINITY ? 0.0f : m_new * scale_log2;
        alpha[r] = ex2(m[r] * scale_log2 - m_use);
        m[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < Bk / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * j + 2 * r + c];
            x = ex2(fmaf(x, scale_log2, -m_use));
            sum += x;
          }
        }
        l[r] = fmaf(l[r], alpha[r], sum);   // this thread's share of the row
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      // P as wgmma's A fragment: k-slab kk is S's columns 16 kk .. + 15,
      // i.e. its accumulator registers 8 kk .. + 7, in the order (row r0,
      // cols 2q, 2q + 1), (r0 + 8, same), (r0, cols + 8), (r0 + 8, + 8)
      uint32_t pa[2][Bk / 16][4];   // hi, lo
#pragma unroll
      for (int kk = 0; kk < Bk / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], pa[0][kk][f],
                     pa[1][kk][f]);

      mbar_wait(full_v + st, phase);
      fence_regs<D / 2>(acc);
      wgmma_fence();
      async_pv<D>(acc, pa, vs + st * T::kKVBytes);
      wgmma_wait();
      fence_regs<D / 2>(acc);
    }
    if (lane == 0) mbar_arrive(empty + st);   // this warp is done with st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + (((long long)b * s_len + row) * heads + h) * dh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, int s_len, int heads,
                  int kv_heads, int dh, float scale_log2, int causal,
                  int window) {
  using T = Tiles<D>;
  constexpr int Bk = T::kBk;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;
  // tiles start on 1,024-byte boundaries (the swizzle atom)
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + T::kQBytes;               // [stage][block][Bk][64]
  uint8_t* vs = ks + kStages * T::kKVBytes;    // [stage][block][Bk][64]

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;   // longest rows first
  const int k_hi = causal ? min(q0 + kBq - 1, s_len - 1) : s_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_lo / Bk;
  const int n_tiles = k_hi / Bk - kt0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full_k + i, 1);
      mbar_init(full_v + i, 1);
      mbar_init(empty + i, kGroups * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's index, read from lane 0 so that the compiler knows it
  // is the same across the warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kGroups) {                         // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kGroups * 128) {
      mbar_expect_tx(full_q, T::kQBytes);
      for (int c = 0; c < T::kBlocks; ++c)
        tma_load_4d(qs + c * kBq * kRowBytes, &tm_q, full_q, 64 * c, h, q0,
                    b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
        const int k0 = (kt0 + i) * Bk;
        uint8_t* kd = ks + st * T::kKVBytes;
        uint8_t* vd = vs + st * T::kKVBytes;
        mbar_expect_tx(full_k + st, T::kKVBytes);
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load_4d(kd + c * Bk * kRowBytes, &tm_k, full_k + st, 64 * c,
                      kvh, k0, b);
        mbar_expect_tx(full_v + st, T::kKVBytes);
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load_4d(vd + c * Bk * kRowBytes, &tm_v, full_v + st, 64 * c,
                      kvh, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    consume<D>(qs, ks, vs, full_q, full_k, full_v, empty, o, wg, b, h,
               q0, kt0, n_tiles, s_len, heads, dh, scale_log2, causal,
               window);
  }
}

// cuTensorMapEncodeTiled, looked up at run time (the library links no
// libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Rank-4 map over a [B, S, heads, dh] bf16 tensor, innermost first, with
// boxes of 64 lanes x 1 head x `rows` rows x 1 sequence, swizzled by 128
// bytes; elements past S or dh read as zero. Returns a CUresult.
int make_map(CUtensorMap* map, const void* ptr, int b, int s_len, int heads,
             int dh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)s_len, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)s_len * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kMapError = 10000;   // + the CUresult of a failed encode

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s_len, int heads, int kv_heads, int dh, float scale_log2,
           int causal, int window, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  int r = make_map(&tq, q, b, s_len, heads, dh, kBq);
  if (r == 0) r = make_map(&tk, k, b, s_len, kv_heads, dh, T::kBk);
  if (r == 0) r = make_map(&tv, v, b, s_len, kv_heads, dh, T::kBk);
  if (r != 0) return kMapError + r;
  auto kernel = flash_sm90_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * heads, (s_len + kBq - 1) / kBq);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, s_len, heads, kv_heads, dh, scale_log2,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S, H, dh], k, v [B, S, KV, dh], o [B, S, H, dh], all contiguous
// bfloat16 on 16-byte boundaries; dh a multiple of 16 in [16, 256],
// S >= 1, ceil(S / 128) <= 65535. scale_log2 = dh^-0.5 * log2(e). Returns
// cudaGetLastError() after the launch, or 10000 + the CUresult of a
// tensor map that cuTensorMapEncodeTiled refused.
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, int b, int s_len, int heads,
                                int kv_heads, int dh, float scale_log2,
                                int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh <= 64)
    return launch<64>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale_log2,
                      causal, window, st);
  if (dh <= 128)
    return launch<128>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale_log2,
                       causal, window, st);
  return launch<256>(q, k, v, o, b, s_len, heads, kv_heads, dh, scale_log2,
                     causal, window, st);
}

}  // extern "C"

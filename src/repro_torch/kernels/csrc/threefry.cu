// threefry2x32-20 on Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel. It replaces jax.random's threefry2x32 (JAX's
// threefry_2x32 primitive), which XLA compiles into one fused loop, and which
// the port's repro_torch/random.py evaluated as ~170 eager int64 ops (each
// uint32 add, shift, or, xor and mask a launch of its own): that eager code
// stays as random.threefry2x32_plain, the CPU's version and the reference the
// tests hold this kernel to, bit for bit.
//
// One launch is one evaluation over an output shape of up to kMaxDims dims.
// Each of the four operands (key words k0, k1; counter words x0, x1) is
//   * a tensor of int64 (its low 32 bits) or int32 (its bits), read by sizes
//     and element strides, stride 0 on a broadcast dim: an expanded key or a
//     non-contiguous view is read where it lies, never copied; or
//   * a word computed from the element's coordinates: bits 0..31 or 32..63 of
//     base + sum(coord[d] * coef[d]) (a constant has every coef 0; split's
//     counter is the coordinate along its last dim; a shaped draw's counter
//     is its flat index plus the chunk's offset, split into (hi, lo)).
// Index arithmetic is in int64. The epilogue writes one of
//   key     (o0, o1) interleaved into a [..., 2] int64 key (fold_in, split),
//   xor     o0 ^ o1 as int64 (a shaped draw's bits),
//   uniform f32((o0 ^ o1) >> 9 | 0x3F800000) - 1 (uniform).
//
// What bounds it: the bytes it writes, 4 to 16 an element (the operands are
// small or broadcast and read once), against ~80 uint32 operations an
// element: 20 rounds of add, rotate and xor and 5 key injections. The
// arithmetic is native uint32_t, with no masks; each rotation is one
// __funnelshift_l. A grid-stride loop of 256-thread blocks writes
// consecutive elements from consecutive threads (a key as one 16-byte
// store), so the stores are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr int kOperands = 4;  // k0, k1, x0, x1
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

enum Kind : int { kInt64 = 0, kInt32 = 1, kLow = 2, kHigh = 3 };
enum Out : int { kKey = 0, kXor = 1, kUniform = 2 };

struct Operand {
  const void* ptr;            // a tensor's data (kInt64, kInt32), else null
  int64_t base;               // a computed word's base
  int64_t stride[kMaxDims];   // element strides, or a computed word's coefs
  int kind;
};

struct Args {
  int64_t n;                  // elements
  int64_t size[kMaxDims];     // the output's sizes, outermost first
  int ndim;
  Operand op[kOperands];
  void* out;
};

__device__ __forceinline__ uint32_t word(const Operand& o, int64_t at) {
  switch (o.kind) {
    case kInt64: return (uint32_t)static_cast<const int64_t*>(o.ptr)[at];
    case kInt32: return (uint32_t)static_cast<const int32_t*>(o.ptr)[at];
    case kLow: return (uint32_t)(uint64_t)(o.base + at);
    default: return (uint32_t)((uint64_t)(o.base + at) >> 32);
  }
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, bool odd) {
  if (odd) {
    mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  } else {
    mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  }
}

// Salmon et al.'s threefry2x32 with 20 rounds, as jax.random computes it.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    rounds4(x0, x1, i % 2);
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// kDims > 0: exactly that many dims (the main paths' one and two); 0: a.ndim
// of them.
template <int kDims, int kOut>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const __grid_constant__ Args a) {
  const int ndim = kDims > 0 ? kDims : a.ndim;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += step) {
    int64_t at[kOperands] = {0, 0, 0, 0};
    int64_t rest = i;
#pragma unroll
    for (int d = (kDims > 0 ? kDims : kMaxDims) - 1; d >= 0; --d) {
      if (d >= ndim) continue;
      // the outermost coordinate is what is left: no division
      const int64_t c = d > 0 ? rest % a.size[d] : rest;
      rest = d > 0 ? rest / a.size[d] : 0;
#pragma unroll
      for (int k = 0; k < kOperands; ++k) at[k] += c * a.op[k].stride[d];
    }
    const uint32_t k0 = word(a.op[0], at[0]), k1 = word(a.op[1], at[1]);
    uint32_t x0 = word(a.op[2], at[2]), x1 = word(a.op[3], at[3]);
    threefry(k0, k1, x0, x1);
    if (kOut == kKey) {
      static_cast<longlong2*>(a.out)[i] =
          make_longlong2((long long)x0, (long long)x1);
    } else if (kOut == kXor) {
      static_cast<int64_t*>(a.out)[i] = x0 ^ x1;
    } else {
      const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
      static_cast<float*>(a.out)[i] = __fsub_rn(__uint_as_float(bits), 1.0f);
    }
  }
}

template <int kOut>
cudaError_t launch_out(const Args& a, cudaStream_t stream) {
  const int64_t want = (a.n + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(want < kMaxBlocks ? want : kMaxBlocks));
  switch (a.ndim) {
    case 1: threefry_kernel<1, kOut><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: threefry_kernel<2, kOut><<<grid, kThreads, 0, stream>>>(a); break;
    default: threefry_kernel<0, kOut><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One evaluation. desc holds, as int64: ndim (1..kMaxDims), n (>= 1), the
// ndim sizes (outermost first, their product n), then for each operand k0,
// k1, x0, x1 its kind (Kind), its base and its ndim strides or coefs. ptrs
// holds the four operands' data (null where computed). epilogue selects
// what is written to out (Out). Returns cudaGetLastError().
int threefry2x32_launch(const int64_t* desc, const void* const* ptrs,
                        int epilogue, void* out, void* stream) {
  Args a = {};
  a.ndim = (int)desc[0];
  a.n = desc[1];
  if (a.ndim < 1 || a.ndim > kMaxDims || a.n < 1 || epilogue < kKey ||
      epilogue > kUniform)
    return (int)cudaErrorInvalidValue;
  const int64_t* p = desc + 2;
  for (int d = 0; d < a.ndim; ++d) a.size[d] = *p++;
  for (int k = 0; k < kOperands; ++k) {
    Operand& o = a.op[k];
    o.ptr = ptrs[k];
    o.kind = (int)*p++;
    o.base = *p++;
    for (int d = 0; d < a.ndim; ++d) o.stride[d] = *p++;
    const bool tensor = o.kind == kInt64 || o.kind == kInt32;
    if (o.kind < kInt64 || o.kind > kHigh || tensor != (o.ptr != nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kKey: return (int)launch_out<kKey>(a, s);
    case kXor: return (int)launch_out<kXor>(a, s);
    default: return (int)launch_out<kUniform>(a, s);
  }
}

}  // extern "C"

// Causal FIR filter, y[i] = sum_t h[t] * x[i - t], zero history before x[0].
//
// Replaces the TPU kernel src/repro/kernels/fir/fir.py:_fir_kernel (launched
// by fir_pallas), which reads the previous block as a halo and unrolls the
// taps loop over VMEM.
//
// Bits: the float path adds the taps in order t = 0..taps-1 with every
// product and sum rounded on its own (__fmul_rn, __fadd_rn, never a fused
// multiply-add), which is exactly what the plain PyTorch version computes.
// The integer path multiplies and adds in uint32 (wraparound, defined
// behaviour), reads the sum back as int32, shifts it right arithmetically by
// the Q15 shift and narrows it to the output type: the int32 wraparound of
// the JAX kernel and of the plain version.  A tap that does not exist adds
// no product (the taps are never padded with zeros: 0 * inf would be NaN).
//
// What bounds it on the H100: these bits forbid the fused multiply-add, so
// each tap of each output is an FMUL and an FADD, 2 * n * taps FP32
// instructions at 128 a clock per SM (or n * taps IMADs at 64 a clock): at
// TinyBio's 65,536 samples and 128 taps about 0.5 us over 132 SMs at
// 1980 MHz, with the bytes (0.5 MB) far below it and the launch (about 1 us)
// above it.  A kernel that reads a tap and a sample from shared memory for
// every product is held by shared memory's one wavefront a clock instead.
// The design:
// * Register blocking: a thread owns kR consecutive outputs (kR in 1, 2, 4,
//   8; kR and the threads a block from plan_fir, kernels/fir/fir.py) and
//   keeps a window of kR + 4 samples in registers.  Four taps at a time
//   arrive as one broadcast 16-byte shared-memory load and the window slides
//   by four samples, one 16-byte load where kR is a multiple of 4 (four
//   4-byte loads otherwise), so shared memory serves well under one
//   wavefront per 32 products and the FP32 (or IMAD) pipe is the limit.
// * Any number of taps: they and the window they need stream through shared
//   memory in chunks of kChunk taps, each output's sum carried in registers
//   from chunk to chunk, so the order of the sums stays t = 0..taps-1.
// * The window comes in as 16-byte loads where the signal and the output
//   are 16-byte aligned and a whole vector lies inside [0, n), element by
//   element at the edges (zeros before x[0] and past x[n-1]); outputs leave
//   four at a time where they are whole and aligned.
// * The plan changes no bit: each output's sum is the same sequence of
//   roundings whatever kR, the threads or the chunking.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 512;        // taps staged in shared memory at a time
constexpr int kMaxThreads = 256;   // threads a block
constexpr int kBatch = 4;          // loads a thread issues before it waits

template <typename S> struct Quad;  // four S as one 16-byte value
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<int32_t> { using type = int4; };

template <typename S>
__device__ __forceinline__ void load4(const S* p, S* out) {  // p 16-byte aligned
  const typename Quad<S>::type q = *reinterpret_cast<const typename Quad<S>::type*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

template <typename S>
__device__ __forceinline__ void store4(S* p, const S* v) {  // p 16-byte aligned
  *reinterpret_cast<typename Quad<S>::type*>(p) = {v[0], v[1], v[2], v[3]};
}

// acc + h * v with the path's arithmetic
__device__ __forceinline__ float madd(float acc, float h, float v) {
  return __fadd_rn(acc, __fmul_rn(h, v));
}
__device__ __forceinline__ uint32_t madd(uint32_t acc, int32_t h, int32_t v) {
  return acc + static_cast<uint32_t>(h) * static_cast<uint32_t>(v);
}

// tap k of the taps as S
template <typename S>
__device__ __forceinline__ S load_tap(const void* h, int h16, int k) {
  if constexpr (std::is_floating_point<S>::value)
    return __ldg(static_cast<const float*>(h) + k);
  else
    return h16 ? static_cast<S>(__ldg(static_cast<const int16_t*>(h) + k))
               : __ldg(static_cast<const int32_t*>(h) + k);
}

// Stage a chunk: its taps h[c0 .. c0 + tc) into hs[0 .. tc) (zeros up to
// hs[slots), never used in a sum), and the window x[ws .. ws + len) as S into xs,
// zeros outside [0, n).  ws and len are multiples of V = 16 / sizeof(T),
// so with `vec` every vector is 16-byte aligned.  Each thread issues the
// loads of kBatch taps and kBatch vectors before it stores any of them, so
// a block waits on one round trip to memory, not one per load.
template <typename T, typename S>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ x,
                                            const void* __restrict__ h,
                                            int h16, int n, int c0, int tc,
                                            int slots, long long ws, int len,
                                            bool vec, S* hs, S* xs) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = len / V;
  for (int k0 = threadIdx.x; k0 < max(nvec, slots); k0 += kBatch * blockDim.x) {
    uint4 raw[kBatch];
    S tap[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = k0 + b * blockDim.x;
      const long long g = ws + static_cast<long long>(k) * V;
      if (k < nvec && vec && g >= 0 && g + V <= n)
        raw[b] = __ldg(reinterpret_cast<const uint4*>(x + g));
      tap[b] = k < tc ? load_tap<S>(h, h16, c0 + k) : S(0);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = k0 + b * blockDim.x;
      if (k < slots) hs[k] = tap[b];
      if (k >= nvec) continue;
      const long long g = ws + static_cast<long long>(k) * V;
      S v[V];
      if (vec && g >= 0 && g + V <= n) {
        const T* e = reinterpret_cast<const T*>(&raw[b]);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = static_cast<S>(e[j]);
      } else {                                  // the edges, element by element
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[j] = (g + j >= 0 && g + j < n) ? static_cast<S>(x[g + j]) : S(0);
      }
#pragma unroll
      for (int j = 0; j < V; j += 4) store4(xs + k * V + j, v + j);
    }
  }
}

// One group of `nt` taps (nt <= 4, in order) on a thread's kR outputs:
// output r takes tap u times w[r + 4 - u].
template <int kR, typename S, typename A>
__device__ __forceinline__ void taps_on_window(A* acc, const S* w, const S* hq,
                                               int nt) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < nt) {
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = madd(acc[r], hq[u], w[r + 4 - u]);
    }
  }
}

// xw[i] = x[A + i] in shared memory; loads x[A + i .. A + i + 3]
template <int kR, typename S>
__device__ __forceinline__ void load_quad(const S* xw, int i, S* q) {
  if constexpr (kR % 4 == 0) {
    load4(xw + i, q);             // 16-byte aligned: see fir_kernel
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = xw[i + j];
  }
}

template <typename T, typename S, int kR>
__global__ void __launch_bounds__(kMaxThreads)
fir_kernel(const T* __restrict__ x, const void* __restrict__ h, int h16,
           T* __restrict__ y, int n, int taps, int shift, int vec) {
  using A = typename std::conditional<std::is_floating_point<S>::value,
                                      float, uint32_t>::type;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  // a chunk's taps, rounded up to 4, and four more that the last group's
  // prefetch reads (zeros, never used)
  const int span = 4 * ((min(taps, kChunk) + 3) / 4) + 4;
  S* hs = reinterpret_cast<S*>(smem);                  // [span]: a chunk's taps
  S* xs = hs + span;                                   // its window
  const int outs = blockDim.x * kR;
  const long long base = static_cast<long long>(blockIdx.x) * outs;
  const int first = threadIdx.x * kR;                  // this thread's outputs, from base

  A acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = A(0);

  for (int c0 = 0; c0 < taps; c0 += kChunk) {
    const int tc = min(kChunk, taps - c0);
    const int groups = (tc + 3) / 4;
    // the chunk's window: x[lo .. base + outs - c0), lo = base - c0 -
    // 4 * groups - 4, widened down to a multiple of V
    const long long lo = base - c0 - 4LL * groups - 4;
    const long long ws = lo - (((lo % V) + V) % V);
    const int len = static_cast<int>(((base + outs - c0 - ws) + V - 1) / V * V);
    if (c0 > 0) __syncthreads();                       // the last chunk is read
    stage_chunk<T, S>(x, h, h16, n, c0, tc, 4 * groups + 4, ws, len, vec != 0, hs, xs);
    __syncthreads();

    // xw[i] = x[A + i] with A = base + first - c0, a multiple of 4 when kR
    // is (so are base and first, c0 is a multiple of kChunk, ws of V), so
    // xw + 4k is 16-byte aligned.  The window at the group of taps 4g .. 4g + 3 of the
    // chunk: w[k] = x[A - 4g - 4 + k].
    const S* xw = xs + (base + first - c0 - ws);
    S w[kR + 4];
    if constexpr (kR % 4 == 0) {
#pragma unroll
      for (int k = 0; k < kR + 4; k += 4) load4(xw + k - 4, w + k);
    } else {
#pragma unroll
      for (int k = 0; k < kR + 4; ++k) w[k] = xw[k - 4];
    }
    // The loads for group g + 1 (its four taps, a broadcast, and the four
    // samples the window slides by) are issued while group g computes.
    const int full = tc / 4;
    S hq[4];
    load4(hs, hq);
#pragma unroll 6
    for (int g = 0; g < full; ++g) {
      S q[4], hn[4];
      load_quad<kR>(xw, -4 * g - 8, q);
      load4(hs + 4 * g + 4, hn);
      taps_on_window<kR>(acc, w, hq, 4);
#pragma unroll
      for (int k = kR + 3; k >= 4; --k) w[k] = w[k - 4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = q[k];
        hq[k] = hn[k];
      }
    }
    if (tc % 4) taps_on_window<kR>(acc, w, hq, tc % 4);  // the last chunk's tail
  }

#pragma unroll
  for (int r0 = 0; r0 < kR; r0 += 4) {
    alignas(16) T out[4];
#pragma unroll
    for (int j = 0; j < 4 && r0 + j < kR; ++j) {
      if constexpr (std::is_floating_point<S>::value)
        out[j] = acc[r0 + j];
      else
        out[j] = static_cast<T>(static_cast<int32_t>(acc[r0 + j]) >> shift);
    }
    const long long i = base + first + r0;
    if (kR % 4 == 0 && vec && i + 4 <= n) {
      if constexpr (sizeof(T) == 4) {
        store4(reinterpret_cast<S*>(y + i), reinterpret_cast<const S*>(out));
      } else {
        *reinterpret_cast<uint2*>(y + i) = *reinterpret_cast<const uint2*>(out);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4 && r0 + j < kR; ++j)
        if (i + j < n) y[i + j] = out[j];
    }
  }
}

template <typename T, typename S>
int launch_fir(const T* x, const void* h, int h16, T* y, int n, int taps,
               int shift, int rows, int threads, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (n <= 0) return 0;
  if (taps < 1 || threads < 1 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const long long outs = static_cast<long long>(threads) * rows;
  const int blocks = static_cast<int>((n + outs - 1) / outs);
  const long long groups = (std::min(taps, kChunk) + 3) / 4;
  // 4 * groups + 4 taps, then a window of at most outs + 4 * groups + 4 +
  // 2V - 2 samples
  const size_t smem = sizeof(S) * static_cast<size_t>(8 * groups + outs + 8 + 2 * V);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: fir_kernel<T, S, 1><<<blocks, threads, smem, s>>>(x, h, h16, y, n, taps, shift, vec); break;
    case 2: fir_kernel<T, S, 2><<<blocks, threads, smem, s>>>(x, h, h16, y, n, taps, shift, vec); break;
    case 4: fir_kernel<T, S, 4><<<blocks, threads, smem, s>>>(x, h, h16, y, n, taps, shift, vec); break;
    case 8: fir_kernel<T, S, 8><<<blocks, threads, smem, s>>>(x, h, h16, y, n, taps, shift, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// rows: outputs a thread (1, 2, 4 or 8); threads: a block's, 1 to 256 (any
// count: nothing in the kernel needs whole warps).  Taps: float32 for the float signal; int16 (h16 = 1) or
// int32 (h16 = 0) Q15 taps for the integer signals.
REPRO_API int repro_fir_f32(const void* x, const void* h, void* y, int n,
                            int taps, int rows, int threads, int device,
                            void* stream) {
  return launch_fir<float, float>(static_cast<const float*>(x), h, 0,
                                  static_cast<float*>(y), n, taps, 0, rows,
                                  threads, device, stream);
}

REPRO_API int repro_fir_i16(const void* x, const void* h, int h16, void* y,
                            int n, int taps, int shift, int rows, int threads,
                            int device, void* stream) {
  return launch_fir<int16_t, int32_t>(static_cast<const int16_t*>(x), h, h16,
                                      static_cast<int16_t*>(y), n, taps, shift,
                                      rows, threads, device, stream);
}

REPRO_API int repro_fir_i32(const void* x, const void* h, int h16, void* y,
                            int n, int taps, int shift, int rows, int threads,
                            int device, void* stream) {
  return launch_fir<int32_t, int32_t>(static_cast<const int32_t*>(x), h, h16,
                                      static_cast<int32_t*>(y), n, taps, shift,
                                      rows, threads, device, stream);
}

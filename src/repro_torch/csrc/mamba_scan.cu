// Mamba (S6) selective scan: x/delta (B, T, Dm), a (Dm, N), b/c (B, T, N),
// optional state0 (B, Dm, N) -> y (B, T, Dm) in x's dtype, WITHOUT the
// D * x skip term (the wrapper adds it), and the final state (B, Dm, N) f32:
//
//     h_t = exp(delta_t * a) * h_{t-1} + delta_t * x_t * b_t      (Dm, N)
//     y_t = h_t . c_t                                              (Dm,)
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py:
// _mamba_kernel (launched by mamba_scan_pallas), which walks a
// (B, Dm / 128, T / 64) grid with time innermost and sequential, keeping
// the (128, N) state plane in VMEM and running each chunk's steps as a
// fori_loop of FMAs on tiles already in VMEM.
//
// What bounds it on the H100, at jamba's width (Dm = 16384, N = 16, B = 4,
// T = 256, x bf16 and delta f32 as the jamba block passes them):
// * bytes: x, delta and y are 134 MB, 42 us at 3.35 TB/s;
// * the special-function unit: one exponential per step, channel and state,
//   268 M of them, 64 us at 16 a clock per SM (132 SMs, 1.98 GHz);
// * and, close behind, the FP32 pipe's issue slots: 4 FP32 instructions
//   per exponential (delta * a', the increment, the state's FMA, y's FMA)
//   and about 2 more a state for the loads of b and c, x and delta, the
//   store and the loop.  The two pipes do not overlap fully: the kernel
//   runs near 1.5x the special-function floor (PERF.md, Findings).
// A first version (one thread per channel, x and delta loaded in the step
// loop) waited on device memory at every step and ran 5.3x its byte bound.
//
// The design:
// * Nothing in the chain waits on device memory.  A block of 128 threads
//   owns C = 128 / L channels of one batch row and streams runs of kRun
//   steps through a ring of kStages stages in shared memory: x and delta
//   as (kRun, C) tiles, b and c as (kRun, N) rows.  While the block runs
//   the steps of one stage, the next kStages - 1 are in flight (cp.async,
//   one cp.async.wait_group and one __syncthreads a stage).  x and delta
//   go as 16-byte copies when both have 16-byte aligned rows
//   (copy16, decided by the wrapper's rule mamba_scan.py:rows_16b); else
//   (a bf16 row of an odd multiple of 2 bytes, say) the threads load each
//   element and store it into the stage kStages - 1 runs ahead: plain
//   loads, so on that path each thread stalls on device memory once a
//   stage (every kRun steps), though never within a run's steps.
//   b and c, read as f32 words, always take 4-byte copies.  Copies past T
//   or Dm fill zeros, so nothing is padded in device memory.  y is written
//   straight from the registers, coalesced across the block's channels.
// * Exponentials at the special-function unit's rate: da = 2^(delta * a')
//   with a' = a * log2(e) computed once, one ex2.approx.ftz.f32 each, with
//   no range reduction around it.  A share of them on the FMA pipe (a
//   Cody-Waite polynomial) was slower at every share measured, since the
//   FP32 pipe is nearly as busy as the special-function unit (PERF.md,
//   Findings), so every exponential takes the unit.
// * A grid that fills the card at a small batch.  L lanes (1, 2 or 4,
//   at least min(N, 8) states each; plan_mamba in mamba_scan.py) share a
//   channel's N states, S = N / L each; each lane sums its S terms of y
//   in order n = 0 .. S - 1, and the L partial sums meet by a butterfly
//   of __shfl_xor_sync (same value in every lane, whatever the order of
//   the two operands of each add).  The plan depends on the shapes and the
//   SM count alone, so two calls with the same shapes give the same bits;
//   there are no atomics.
//
// Arithmetic per step and state, f32: da = 2^(delta * a'_n), h_n =
// fma(da, h_n, (delta * x) * b_n), partial y = fma(h_n, c_n, partial y).
// Any T >= 0 and Dm work unpadded; the state starts from state0 or zeros.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

// PERF.md, Findings, has the times of the other unrolls and ring depths.
constexpr int kThreads = 128;  // threads per block: C channels x L lanes
constexpr int kRun = 16;       // time steps per stage
constexpr int kStages = 3;     // stages of the ring
constexpr int kUnroll = 4;     // steps of the step loop unrolled
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// 2^z on the special-function unit (MUFU.EX2); 0 below 2^-126.
__device__ __forceinline__ float ex2_sfu(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in_bounds) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(in_bounds ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in_bounds) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(in_bounds ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// S consecutive floats of shared memory (16-, 8- or 4-byte aligned as S
// is a multiple of 4, 2 or neither) into registers.
template <int S>
__device__ __forceinline__ void load_row(const float* p, float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int j = 0; j < S; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (S % 2 == 0) {
#pragma unroll
    for (int j = 0; j < S; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x; v[j + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) v[j] = p[j];
  }
}

struct Args {
  const void* x;         // (B, T, Dm)
  const void* delta;     // (B, T, Dm)
  const float* a;        // (Dm, N)
  const float* bm;       // (B, T, N)
  const float* cm;       // (B, T, N)
  const float* h0;       // (B, Dm, N) or null for zeros
  void* y;               // (B, T, Dm), x's dtype
  float* h_out;          // (B, Dm, N)
  int t, dm;
  int copy16;            // x and delta rows take 16-byte copies
};

template <typename TX, typename TD, int N, int L>
struct Tile {
  static constexpr int kS = N / L;            // states per thread
  static constexpr int kC = kThreads / L;     // channels per block
  static constexpr int kXBytes = kRun * kC * static_cast<int>(sizeof(TX));
  static constexpr int kDBytes = kRun * kC * static_cast<int>(sizeof(TD));
  static constexpr int kRowBytes = kRun * N * 4;   // b or c of one stage
  static constexpr int kStageBytes = kXBytes + kDBytes + 2 * kRowBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kS >= 1 && kS <= 16 && kS * L == N, "1 to 16 states a lane");
  static_assert(kXBytes % 16 == 0 && kDBytes % 16 == 0, "16-byte stages");
};

// Rows [row, row + rows) of a (B * T, dm) tensor, channels [ch0, ch0 + C),
// into a (kRun, C) stage: 16-byte copies (dm * sizeof(T) a multiple of 16,
// 16-byte aligned base), zeros past the rows and past dm.
template <typename T, int C>
__device__ __forceinline__ void stage16(T* dst, const T* src, long long row,
                                        int rows, int ch0, int dm) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = C / kPer;
  for (int i = threadIdx.x; i < kRun * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool ok = r < rows && ch0 + c < dm;
    cp_async16(dst + r * C + c, ok ? src + (row + r) * dm + ch0 + c : src, ok);
  }
}

// The same stage for rows that no 16-byte copy describes: one element a
// load and a shared store, so the thread waits here for its loads.
template <typename T, int C>
__device__ __forceinline__ void stage_each(T* dst, const T* src, long long row,
                                           int rows, int ch0, int dm) {
  for (int i = threadIdx.x; i < kRun * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dst[i] = r < rows && ch0 + c < dm ? src[(row + r) * dm + ch0 + c]
                                      : zero<T>();
  }
}

template <typename TX, typename TD, int N, int L>
__global__ void __launch_bounds__(kThreads, 4) mamba_kernel(Args a) {
  using G = Tile<TX, TD, N, L>;
  constexpr int S = G::kS, C = G::kC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int part = threadIdx.x % L;            // states [part S, part S + S)
  const int cl = threadIdx.x / L;              // channel within the block
  const int ch0 = blockIdx.x * C;
  const int ch = ch0 + cl;
  const bool live = ch < a.dm;
  const bool writer = live && part == 0;       // stores y
  const long long row0 = static_cast<long long>(blockIdx.y) * a.t;  // (b, 0)
  const TX* x = static_cast<const TX*>(a.x);
  const TD* dl = static_cast<const TD*>(a.delta);
  TX* y = static_cast<TX*>(a.y) + row0 * a.dm + ch;
  const long long hrow =
      (static_cast<long long>(blockIdx.y) * a.dm + ch) * N + part * S;

  float h[S], ap[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    ap[j] = live ? a.a[static_cast<long long>(ch) * N + part * S + j] * kLog2e
                 : 0.f;
    h[j] = live && a.h0 ? a.h0[hrow + j] : 0.f;
  }

  const int runs = (a.t + kRun - 1) / kRun;
  auto load = [&](int r) {
    unsigned char* st = smem + (r % kStages) * G::kStageBytes;
    TX* xs = reinterpret_cast<TX*>(st);
    TD* ds = reinterpret_cast<TD*>(st + G::kXBytes);
    float* bs = reinterpret_cast<float*>(st + G::kXBytes + G::kDBytes);
    float* cs = bs + kRun * N;
    const int t0 = r * kRun;
    const int rows = min(kRun, a.t - t0);
    if (a.copy16) {
      stage16<TX, C>(xs, x, row0 + t0, rows, ch0, a.dm);
      stage16<TD, C>(ds, dl, row0 + t0, rows, ch0, a.dm);
    } else {
      stage_each<TX, C>(xs, x, row0 + t0, rows, ch0, a.dm);
      stage_each<TD, C>(ds, dl, row0 + t0, rows, ch0, a.dm);
    }
    const long long off = (row0 + t0) * N;
    for (int i = threadIdx.x; i < kRun * N; i += kThreads) {
      const bool ok = i < rows * N;
      cp_async4(bs + i, ok ? a.bm + off + i : a.bm, ok);
      cp_async4(cs + i, ok ? a.cm + off + i : a.cm, ok);
    }
  };

#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    if (r < runs) load(r);
    cp_async_commit();
  }
  for (int r = 0; r < runs; ++r) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage r landed
    __syncthreads();                // everyone's, and stage r - 1 is free
    if (r + kStages - 1 < runs) load(r + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (r % kStages) * G::kStageBytes;
    const TX* xs = reinterpret_cast<const TX*>(st);
    const TD* ds = reinterpret_cast<const TD*>(st + G::kXBytes);
    const float* bs =
        reinterpret_cast<const float*>(st + G::kXBytes + G::kDBytes) + part * S;
    const float* cs = bs + kRun * N;
    const int t0 = r * kRun;
    const int steps = min(kRun, a.t - t0);
    TX* yp = y + static_cast<long long>(t0) * a.dm;
#pragma unroll kUnroll
    for (int tt = 0; tt < steps; ++tt) {
      const float dt = to_f32(ds[tt * C + cl]);
      const float dx = dt * to_f32(xs[tt * C + cl]);
      float bv[S], cv[S];
      load_row<S>(bs + tt * N, bv);
      load_row<S>(cs + tt * N, cv);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float da = ex2_sfu(dt * ap[j]);
        h[j] = fmaf(da, h[j], dx * bv[j]);
        acc = fmaf(h[j], cv[j], acc);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (writer) store_as(yp, acc);
      yp += a.dm;
    }
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < S; ++j) a.h_out[hrow + j] = h[j];
  }
}

template <typename TX, typename TD, int N, int L>
int launch_tile(const Args& a, int b, cudaStream_t stream) {
  using G = Tile<TX, TD, N, L>;
  auto kernel = mamba_kernel<TX, TD, N, L>;
  if (G::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  const dim3 grid((a.dm + G::kC - 1) / G::kC, b);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// lanes in {1, 2, 4} with min(N, 8) <= N / lanes <= 16 (mamba_scan.py:
// lane_choices): 1 for N <= 8, 1 or 2 for N = 16, 2 or 4 for N = 32.
template <typename TX, typename TD, int N>
int launch_lanes(const Args& a, int b, int lanes, cudaStream_t stream) {
  if (lanes == 1) {
    if constexpr (N <= 16) return launch_tile<TX, TD, N, 1>(a, b, stream);
  } else if (lanes == 2) {
    if constexpr (N == 16 || N == 32) return launch_tile<TX, TD, N, 2>(a, b, stream);
  } else if (lanes == 4) {
    if constexpr (N == 32) return launch_tile<TX, TD, N, 4>(a, b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX, typename TD>
int launch_mamba(const Args& a, int b, int n, int lanes, cudaStream_t stream) {
  switch (n) {
    case 2: return launch_lanes<TX, TD, 2>(a, b, lanes, stream);
    case 4: return launch_lanes<TX, TD, 4>(a, b, lanes, stream);
    case 8: return launch_lanes<TX, TD, 8>(a, b, lanes, stream);
    case 16: return launch_lanes<TX, TD, 16>(a, b, lanes, stream);
    case 32: return launch_lanes<TX, TD, 32>(a, b, lanes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool rows_16b(const void* p, int dm, int itemsize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (static_cast<long long>(dm) * itemsize) % 16 == 0;
}

template <typename TX, typename TD>
int mamba_entry(const void* x, const void* delta, const float* a_mat,
                const float* bm, const float* cm, const float* h0, void* y,
                float* h_out, int b, int t, int dm, int n, int lanes,
                int copy16, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || dm <= 0) return 0;
  if (t < 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (copy16 && !(rows_16b(x, dm, sizeof(TX)) && rows_16b(delta, dm, sizeof(TD))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, delta, a_mat, bm, cm, h0, y, h_out, t, dm, copy16};
  return launch_mamba<TX, TD>(a, b, n, lanes, static_cast<cudaStream_t>(stream));
}

}  // namespace

// N in {2, 4, 8, 16, 32}; lanes as launch_lanes takes them;
// copy16 only when x and delta have 16-byte aligned bases and rows; every
// tensor is contiguous; a, b, c (and state0, which may be null) are
// float32.  _f32: x and delta float32; _bf16: x bfloat16, delta float32
// (what the jamba block passes under bfloat16); _bf16d: x and delta
// bfloat16.
REPRO_API int repro_mamba_scan_f32(const void* x, const void* delta,
                                   const float* a, const float* bm,
                                   const float* cm, const float* h0, void* y,
                                   float* h_out, int b, int t, int dm, int n,
                                   int lanes, int copy16, int device,
                                   void* stream) {
  return mamba_entry<float, float>(x, delta, a, bm, cm, h0, y, h_out, b, t,
                                   dm, n, lanes, copy16, device, stream);
}

REPRO_API int repro_mamba_scan_bf16(const void* x, const void* delta,
                                    const float* a, const float* bm,
                                    const float* cm, const float* h0, void* y,
                                    float* h_out, int b, int t, int dm, int n,
                                    int lanes, int copy16, int device,
                                    void* stream) {
  return mamba_entry<__nv_bfloat16, float>(x, delta, a, bm, cm, h0, y, h_out,
                                           b, t, dm, n, lanes, copy16, device,
                                           stream);
}

REPRO_API int repro_mamba_scan_bf16d(const void* x, const void* delta,
                                     const float* a, const float* bm,
                                     const float* cm, const float* h0, void* y,
                                     float* h_out, int b, int t, int dm, int n,
                                     int lanes, int copy16, int device,
                                     void* stream) {
  return mamba_entry<__nv_bfloat16, __nv_bfloat16>(
      x, delta, a, bm, cm, h0, y, h_out, b, t, dm, n, lanes, copy16, device,
      stream);
}

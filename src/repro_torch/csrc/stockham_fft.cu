// Batched Stockham FFT: one complex transform of length n (a power of two)
// per row of re/im shaped (batch, n), output in natural order, and, on
// request, its power spectrum re^2 + im^2 in the same launch.
//
// Replaces the TPU kernel src/repro/kernels/stockham_fft/stockham_fft.py:
// _fft_kernel (launched by fft_pallas), which keeps both planes in VMEM for
// all log2(n) stages and computes the twiddles from an iota.
//
// What bounds it on the H100: one launch.  TinyBio transforms 128 windows
// of 512: 256 KB in, 512 KB out (about 0.23 us at 3.35 TB/s) against 2.9 M
// flops (about 0.04 us at 67 TFLOP/s), all far below the launch floor of
// about 1 us.  What a block adds to that floor is a chain of latencies:
// the row's copy in (or the twiddles, whichever takes longer), then every
// pass, a short run of dependent shared-memory loads, arithmetic and
// stores with few warps to hide it.  So the design shortens the chain:
// one block per signal keeps the transform in shared memory between
// stages, as the TPU kernel keeps it in VMEM, and
// * computes each twiddle once: a table of the n - 1 values of all stages
//   in shared memory (stage l at offset l - 1), filled while the row's
//   copies into shared memory are in flight, from the n / 2 values of the
//   last stage alone (every other stage's angles are among them, bit for
//   bit), one sincosf a thread at n = 512;
// * does two radix-2 stages per pass in registers (one barrier a pass,
//   plus a last radix-2 pass where log2 n is odd: 5 barriers at n = 512,
//   not 9), writing the last pass straight to device memory;
// * writes |X|^2 in that last pass when the caller asks for it (the
//   power spectrum as one launch, not four) and then, unless asked for
//   them too, neither plane.
//
// The arithmetic is the Van Loan recurrence of stockham_fft/ref.py, stage
// by stage: stage l (l = 1, 2, 4, .., n/2) views X as (2r, l), r = n / 2l;
// butterfly k < n/2 has j = k mod l, reads a = X[k] and b = X[k + n/2],
// and writes a + w_j b to 2k - j and a - w_j b to 2k - j + l, with
// w_j = exp(-i pi j / l).  A pass does stages l and 2l: thread k < n/4,
// j = k mod l, g = k div l, reads X[k], X[k + n/4], X[k + n/2] and
// X[k + 3n/4]; stage l pairs (X[k], X[k + n/2]) and (X[k + n/4],
// X[k + 3n/4]) with w_j into Y[2gl + j], Y[(2g+1)l + j], Y[2gl + j + n/2]
// and Y[(2g+1)l + j + n/2]; stage 2l pairs (Y[2gl + j], Y[2gl + j + n/2])
// with w'_j and (Y[(2g+1)l + j], Y[(2g+1)l + j + n/2]) with w'_(l+j) into
// Z[4gl + j + {0, 2l}] and Z[4gl + j + {l, 3l}].
// Twiddles follow the JAX kernel: the fp32 angle float(-pi / l) * j, then
// its cosine and sine (sincosf, the bits of cosf and sinf; no fast math).
// Products and sums are rounded one by one (no fused multiply-add),
// exactly as the plain PyTorch version computes them, so the output has
// the bits of the radix-2 kernel this one replaced.
// tests/test_torch_fft_design.py holds this schedule, in plain PyTorch,
// bit for bit against the plain version for n = 1 .. 8192.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxN = 8192;   // 4 n floats of planes + n - 1 float2 twiddles

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

struct Plane {
  float re, im;
};

// a + w b and a - w b, each product and sum rounded on its own
__device__ __forceinline__ void butterfly(Plane a, Plane b, float2 w,
                                          Plane& lo, Plane& hi) {
  const float tr = __fsub_rn(__fmul_rn(w.x, b.re), __fmul_rn(w.y, b.im));
  const float ti = __fadd_rn(__fmul_rn(w.x, b.im), __fmul_rn(w.y, b.re));
  lo = {__fadd_rn(a.re, tr), __fadd_rn(a.im, ti)};
  hi = {__fsub_rn(a.re, tr), __fsub_rn(a.im, ti)};
}

// Where the last pass writes: re/im planes and |X|^2, each may be NULL.
struct Out {
  float* re;
  float* im;
  float* power;
};

__device__ __forceinline__ void emit(const Out& o, size_t i, Plane z) {
  if (o.re != nullptr) o.re[i] = z.re;
  if (o.im != nullptr) o.im[i] = z.im;
  if (o.power != nullptr)
    o.power[i] = __fadd_rn(__fmul_rn(z.re, z.re), __fmul_rn(z.im, z.im));
}

__device__ __forceinline__ Plane at(const float* s, int n, int i) {
  return {s[i], s[n + i]};
}

// Stages l and 2l (l = 2^s) from shared src into shared dst or, for the
// last pass, into device memory at row offset `row`.
template <bool kLast>
__device__ __forceinline__ void radix4_pass(const float* src, float* dst,
                                            const float2* tw, int n, int s,
                                            const Out& o, size_t row) {
  const int l = 1 << s, quarter = n >> 2, half = n >> 1;
  for (int k = threadIdx.x; k < quarter; k += blockDim.x) {
    const int j = k & (l - 1);
    const int base = ((k >> s) << (s + 2)) + j;   // 4gl + j
    const float2 w = tw[l - 1 + j];
    Plane y0, y1, y2, y3, z0, z1, z2, z3;
    butterfly(at(src, n, k), at(src, n, k + half), w, y0, y1);
    butterfly(at(src, n, k + quarter), at(src, n, k + half + quarter), w, y2,
              y3);
    butterfly(y0, y2, tw[2 * l - 1 + j], z0, z2);
    butterfly(y1, y3, tw[3 * l - 1 + j], z1, z3);
    if constexpr (kLast) {
      emit(o, row + base, z0);
      emit(o, row + base + l, z1);
      emit(o, row + base + 2 * l, z2);
      emit(o, row + base + 3 * l, z3);
    } else if (l == 1) {   // Z[4k .. 4k + 3]: one 16-byte store a plane
      reinterpret_cast<float4*>(dst)[k] = make_float4(z0.re, z1.re, z2.re, z3.re);
      reinterpret_cast<float4*>(dst + n)[k] = make_float4(z0.im, z1.im, z2.im, z3.im);
    } else {
      dst[base] = z0.re;
      dst[n + base] = z0.im;
      dst[base + l] = z1.re;
      dst[n + base + l] = z1.im;
      dst[base + 2 * l] = z2.re;
      dst[n + base + 2 * l] = z2.im;
      dst[base + 3 * l] = z3.re;
      dst[n + base + 3 * l] = z3.im;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    stockham_fft_kernel(const float* __restrict__ re_in,
                        const float* __restrict__ im_in, Out o, int n,
                        int log2n, int copy16) {
  extern __shared__ __align__(16) float smem[];
  // two buffers of re | im planes, then the n - 1 twiddles
  const float* src = smem;
  float* dst = smem + 2 * n;
  float2* tw = reinterpret_cast<float2*>(smem + 4 * n);
  const size_t row = static_cast<size_t>(blockIdx.x) * n;

  // the row into smem, while the twiddles are computed
  if (copy16) {
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) {
      cp_async16(smem + 4 * k, re_in + row + 4 * k);
      if (im_in != nullptr) cp_async16(smem + n + 4 * k, im_in + row + 4 * k);
    }
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      cp_async4(smem + k, re_in + row + k);
      if (im_in != nullptr) cp_async4(smem + n + k, im_in + row + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (im_in == nullptr)
    for (int k = threadIdx.x; k < n; k += blockDim.x) smem[n + k] = 0.f;
  // Entry j of the last stage (l = n / 2) has the angle of entry
  // j / 2^i of stage l / 2^i wherever 2^i divides j: float(-pi / l) is
  // float(-pi) / l exactly (a power of two), so both angles are the same
  // real number rounded once.  One sincosf per entry of the last stage
  // fills every stage.
  if (log2n > 0) {
    const int half = n >> 1;
    const float step = __fdiv_rn(static_cast<float>(-3.141592653589793),
                                 static_cast<float>(half));
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      float2 w;
      sincosf(__fmul_rn(step, static_cast<float>(j)), &w.y, &w.x);
      for (int l = half, i = j; l > 0; l >>= 1, i >>= 1) {
        tw[l - 1 + i] = w;
        if (i & 1) break;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  int s = 0;
  for (; s + 2 < log2n; s += 2) {
    radix4_pass<false>(src, dst, tw, n, s, o, row);
    __syncthreads();
    float* const next = const_cast<float*>(src);
    src = dst;
    dst = next;
  }
  if (s + 2 == log2n) {
    radix4_pass<true>(src, nullptr, tw, n, s, o, row);
  } else if (s + 1 == log2n) {   // the last stage, l = n / 2, alone
    const int half = n >> 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      Plane lo, hi;
      butterfly(at(src, n, k), at(src, n, k + half), tw[half - 1 + k], lo, hi);
      emit(o, row + k, lo);
      emit(o, row + half + k, hi);
    }
  } else if (threadIdx.x == 0) {   // n = 1
    emit(o, row, at(src, n, 0));
  }
}

}  // namespace

// im may be NULL (a real input).  re_out, im_out and power may each be
// NULL (not written).  n must be a power of two up to 8192, whose 4 fp32
// planes and n - 1 twiddles fit in a block's shared memory.
REPRO_API int repro_stockham_fft_f32(const void* re, const void* im,
                                     void* re_out, void* im_out, void* power,
                                     int batch, int n, int device,
                                     void* stream) {
  REPRO_SET_DEVICE(device);
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int log2n = 31 - __builtin_clz(static_cast<unsigned>(n));
  const size_t smem = sizeof(float) * 4 * n + sizeof(float2) * (n - 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stockham_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool copy16 = n % 4 == 0 && reinterpret_cast<uintptr_t>(re) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(im) % 16 == 0;
  int threads = n / 2;   // one twiddle of the last stage a thread at n = 512
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  const Out o{static_cast<float*>(re_out), static_cast<float*>(im_out),
              static_cast<float*>(power)};
  stockham_fft_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im), o, n,
      log2n, copy16);
  return REPRO_LAUNCH_STATUS();
}

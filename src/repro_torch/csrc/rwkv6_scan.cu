// RWKV-6 (Finch) WKV scan: r/k/v/w (B, H, T, D), u (H, D), optional state0
// (B, H, D, D) -> y (B, H, T, D) in r's dtype and the final state
// (B, H, D, D) in f32:
//
//     y_t[j]   = sum_i r_t[i] * (S_{t-1}[i, j] + u[i] * k_t[i] * v_t[j])
//     S_t[i,j] = w_t[i] * S_{t-1}[i, j] + k_t[i] * v_t[j]
//
// Replaces the TPU kernel
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py:_rwkv6_kernel (launched by
// rwkv6_scan_pallas), which walks a (B, H, T / 32) grid with time innermost
// and sequential, carrying the D x D state across grid steps in VMEM and
// turning each chunk of 32 steps into matmuls in the log-decay form.  It
// also replaces the XLA chunked path of ops.rwkv6_scan, which is what the
// JAX package runs whenever a state is passed (its prefill and decode do):
// this kernel takes state0 or starts from zeros, the same function as the
// TPU kernel's state0 = None.
//
// What bounds it on the H100 (bounds at the card's published peaks, H100
// SXM at 700 W): for rwkv6-3b's prefill (B = 4, H = 40, T = 256, D = 64)
// the 5 D^2 flops per step and head are 0.84 GFLOP, 12.5 us at 67 TFLOP/s,
// against about 34 MB of inputs and outputs (10 us at 3.35 TB/s): the
// FFMA rate.  A decode step (T = 1) reads and writes 5.2 MB of state: bytes,
// 1.6 us.  A chunk is a chain of dependent phases (stage, A, decays,
// cluster exchange, y, S), each a few hundred instructions a warp with a
// barrier after it, and an SM holds two or three blocks: what bounds the
// kernel is the latency of that chain, not the FFMA rate.  The design
// cuts the work a chunk puts on its critical path and keeps the card full.
//
// * A grid that fills the card.  Column j of S evolves on its own (S[:, j]
//   needs only v_t[j]), so a block owns a slab of 32 columns of one (b, h)
//   for the whole sequence: B * H * D / 32 blocks (320 at the prefill
//   shape, under three blocks an SM, one wave), none needing another's
//   state.
// * The chunked form of the TPU kernel, C = 32 steps a chunk, so that a
//   chunk is three small matrix products instead of 32 dependent steps:
//       y      = A v_slab + (r * P_prev) S_slab
//       S_slab = P_C * S_slab + (k * Q)^T v_slab
//   with P_prev[t] = prod_{q<t} w_q, P_C = prod_q w_q, Q[s] =
//   prod_{q>s} w_q, A[t][s] = sum_i r_t[i] k_s[i] prod_{s<q<t} w_q[i]
//   for s < t and A[t][t] = sum_i r_t[i] u[i] k_t[i].  Every factor is a
//   product of decays in (0, 1), so none exceeds 1 and nothing overflows
//   for any w; the decays are running products (one multiply per pair and
//   channel down each column s of A), not an exp per pair.
// * A thread-block cluster per (b, h) instead of recomputing.  The D / 32
//   slab blocks of a head form a cluster; block c stages channels
//   [32c, 32c + 32) of r, k and w (the channels its slab's v columns have),
//   computes their decays and their share of A, and the blocks gather each
//   other's through distributed shared memory after one cluster barrier a
//   chunk (A summed in rank order), so no block recomputes another's work.
// * Loads the compute does not wait on.  While a chunk computes, the next
//   chunk's rows of the block's channels (r, k, w and v) come in with
//   16-byte cp.async into a staging buffer, the second stage beside the f32
//   copy the chunk computes from.  Views whose rows are not 16-byte aligned
//   are read straight from device memory instead.
// * The chunk's two products that carry the state, y = A v + (r P_prev) S
//   and S = P_C S + (k Q)^T v, on the tensor cores: mma.sync m16n8k8 in
//   TF32, each operand split in a TF32 high part and its TF32 rounding
//   error, three products a step (hi hi + hi lo + lo hi), which keeps f32
//   accuracy (the dropped lo lo term is about 2^-22 of a product).  The
//   slab's state stays in the MMA accumulators of its warps for the whole
//   sequence, with a transposed copy in shared memory as y's operand.
//   The rows of k and v the MMAs read are padded so that a fragment's 32
//   reads fall in 32 banks.
// * The decays and A stay on the CUDA cores in f32: A's running products
//   are an elementwise chain, not a product of matrices.
//
// T = 1 (a decode step) runs rwkv6_step_kernel: the chunked form of a
// one-step chunk is the recurrence itself (A is the u bonus, the decays are
// w), so a small kernel whose whole grid of B * H * D / 16 blocks is
// resident at once reads and writes each 4 KB state slab once.  Any T
// works and nothing is padded in device memory: the last chunk's missing
// steps are r = k = v = 0 and w = 1 in shared memory (the TPU kernel's
// padding), which neither decays the state nor adds to it.  r, k, v and w
// may be strided views (any strides over b, h and t, the last axis
// contiguous); y and the state are contiguous.
//
// Arithmetic: f32 sums, the products of y and S in three TF32 parts; the
// sums are the chunked form's in another order than the plain version's
// (and without its exp/log round trip), so the two agree to f32 rounding,
// not bit for bit.
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kC = 32;        // steps a chunk
constexpr int kW = 32;        // state columns a block owns = channels it stages
constexpr int kStepW = 16;    // state columns a block of the one-step kernel owns
constexpr int kThreads = 128;
constexpr int kLdC = kC + 4;  // words between rows of A and of v^T

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Four consecutive elements as f32 (element by element: the global rows of
// a view need not be 8- or 16-byte aligned).
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// x = hi + lo in TF32, lo the rounding error of hi (about 2^-11 x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An m16n8k8 operand pair, each split in TF32 hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// c += a b in f32 accuracy from three TF32 products, the small ones first:
// a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, about 2^-22 of a b, is
// dropped).
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;        // (H, D)
  const float* s0;       // (B, H, D, D) or null for zeros
  void* y;               // (B, H, T, D), r's dtype
  float* s_out;          // (B, H, D, D)
  int b, h, t;
  int staged;            // rows 16-byte aligned: stage them with cp.async
  long long st[12];      // (b, h, t) strides of r, k, v, w
};

// Shared memory of one block of the chunk kernel, in words:
// * what the cluster reads, twice (chunk parity): r * P_prev and k * Q of
//   the block's 32 channels (C x 32), their P_C, and A summed over them;
// * the block's own: w and u of its channels, v of its slab;
// * gathered from the cluster: r * P_prev and k * Q of all D channels
//   (rows D + 4 and D + 8 apart, so that the MMA operand reads fall in
//   distinct banks), P_C, A; the state slab transposed;
// * then the staging buffer of raw rows (r, k, w, v: C x 32 each).
template <typename TI, typename TW, int D>
struct Smem {
  static constexpr int kLd = D + 4;                // rows of r and of S^T
  static constexpr int kLdK = D + 8;               // rows of k: MMA A reads
  static constexpr int kLdV = kW + 8;              // rows of v: MMA B reads
  static constexpr int kXR = 0;                   // [2][kC][kW]
  static constexpr int kXK = kXR + 2 * kC * kW;   // [2][kC][kW]
  static constexpr int kXP = kXK + 2 * kC * kW;   // [2][kW]
  static constexpr int kXA = kXP + 2 * kW;        // [2][kC][kC]
  static constexpr int kWo = kXA + 2 * kC * kC;   // [kC][kW]
  static constexpr int kU = kWo + kC * kW;        // [kW]
  static constexpr int kV = kU + kW;              // [kC][kLdV]
  static constexpr int kR = kV + kC * kLdV;       // [kC][kLd]
  static constexpr int kK = kR + kC * kLd;        // [kC][kLdK]
  static constexpr int kP = kK + kC * kLdK;       // [D]
  static constexpr int kA = kP + D;               // [kC][kLdC]
  static constexpr int kS = kA + kC * kLdC;       // [kW][kLd]
  static constexpr int kWords = kS + kW * kLd;
  static constexpr int kRawR = kWords * 4;        // byte offsets
  static constexpr int kRawK = kRawR + kC * kW * sizeof(TI);
  static constexpr int kRawV = kRawK + kC * kW * sizeof(TI);
  static constexpr int kRawW = kRawV + kC * kW * sizeof(TI);
  static constexpr int kBytes = kRawW + kC * kW * sizeof(TW);
  static_assert(kWords % 4 == 0, "the staging buffer must be 16-byte aligned");
};

// Stage rows [t0, t0 + n) of columns [j0, j0 + 32) of r, k, v and w (the
// pointers are offset to j0) with 16-byte cp.async copies; one group.
template <typename TI, typename TW, int D>
__device__ __forceinline__ void stage_chunk(unsigned char* smem, const TI* r,
                                            const TI* k, const TI* v,
                                            const TW* w, const long long* ts,
                                            int t0, int n) {
  using L = Smem<TI, TW, D>;
  constexpr int kRowI = kW * sizeof(TI) / 16, kRowW = kW * sizeof(TW) / 16;
  for (int idx = threadIdx.x; idx < n * kRowI; idx += kThreads) {
    const int tt = idx / kRowI, q = idx % kRowI;
    const long long t = t0 + tt;
    const int off = (tt * kRowI + q) * 16;
    cp_async16(smem + L::kRawR + off,
               reinterpret_cast<const unsigned char*>(r + t * ts[0]) + q * 16);
    cp_async16(smem + L::kRawK + off,
               reinterpret_cast<const unsigned char*>(k + t * ts[1]) + q * 16);
    cp_async16(smem + L::kRawV + off,
               reinterpret_cast<const unsigned char*>(v + t * ts[2]) + q * 16);
  }
  for (int idx = threadIdx.x; idx < n * kRowW; idx += kThreads) {
    const int tt = idx / kRowW, q = idx % kRowW;
    cp_async16(smem + L::kRawW + (tt * kRowW + q) * 16,
               reinterpret_cast<const unsigned char*>(w + (t0 + tt) * ts[3]) + q * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// x[t] *= e_t for the half chunk of steps t = kFirst, kFirst + kStep, ...
// of channel ch, e_t being f times the product of w over the run's steps
// before t; returns f times the product over the whole run.  The run's
// values are read before any is written back, so no load waits on a store.
template <int kFirst, int kStep>
__device__ __forceinline__ float decay_run(float* x, const float (&wv)[kC],
                                           float f, int ch) {
  constexpr int kH = kC / 2;
  float xv[kH];
#pragma unroll
  for (int i = 0; i < kH; ++i) xv[i] = x[(kFirst + kStep * i) * kW + ch];
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    xv[i] *= f;
    f *= wv[kFirst + kStep * i];
  }
#pragma unroll
  for (int i = 0; i < kH; ++i) x[(kFirst + kStep * i) * kW + ch] = xv[i];
  return f;
}

// The chunk kernel: a cluster of D / 32 blocks per (b, h); block c owns
// columns [32c, 32c + 32) of the state and stages channels [32c, 32c + 32)
// of r, k and w.
template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(kThreads, 3) rwkv6_kernel(Args a) {
  using L = Smem<TI, TW, D>;
  constexpr int kLd = L::kLd, kLdK = L::kLdK, kLdV = L::kLdV;
  constexpr int kNB = D / kW;          // blocks of a cluster
  constexpr int kTiles = D / 16;       // 16 x 8 state tiles a warp keeps
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sf = reinterpret_cast<float*>(smem);
  float* const wo = sf + L::kWo;
  float* const us = sf + L::kU;
  float* const vs = sf + L::kV;
  float* const rf = sf + L::kR;
  float* const kf = sf + L::kK;
  float* const pf = sf + L::kP;
  float* const af = sf + L::kA;
  float* const st = sf + L::kS;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // MMA fragment coordinates
  const int bh = blockIdx.x / kNB;
  const int j0 = static_cast<int>(cluster.block_rank()) * kW;
  const int b = bh / a.h, h = bh % a.h;

  const TI* r = static_cast<const TI*>(a.r) + b * a.st[0] + h * a.st[1] + j0;
  const TI* k = static_cast<const TI*>(a.k) + b * a.st[3] + h * a.st[4] + j0;
  const TI* v = static_cast<const TI*>(a.v) + b * a.st[6] + h * a.st[7] + j0;
  const TW* w = static_cast<const TW*>(a.w) + b * a.st[9] + h * a.st[10] + j0;
  const long long ts[4] = {a.st[2], a.st[5], a.st[8], a.st[11]};
  TI* y = static_cast<TI*>(a.y) + static_cast<long long>(bh) * a.t * D + j0;

  // The warp's share of the state slab (D x 32), as MMA accumulators:
  // rows 16 * sm + g (+ 8) and columns 8 * (sn + n) + 2 * t4 (+ 1).
  const int sm = warp * kTiles / 4, sn = warp * kTiles % 4;
  const long long sbase = static_cast<long long>(bh) * D * D + j0;
  auto s_at = [&](int n, int e) {  // (row, column) of accumulator e of tile n
    return make_int2(16 * sm + g + 8 * (e >> 1), 8 * (sn + n) + 2 * t4 + (e & 1));
  };
  float sc[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 ij = s_at(n, e);
      sc[n][e] = a.s0 ? a.s0[sbase + ij.x * D + ij.y] : 0.f;
      st[ij.y * kLd + ij.x] = sc[n][e];
    }
  if (tid < kW) us[tid] = a.u[h * D + j0 + tid];

  const int n_chunks = (a.t + kC - 1) / kC;
  if (a.staged && n_chunks > 0)
    stage_chunk<TI, TW, D>(smem, r, k, v, w, ts, 0, min(kC, a.t));

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC;
    const int n = min(kC, a.t - t0);
    float* const xr = sf + L::kXR + (c & 1) * kC * kW;
    float* const xk = sf + L::kXK + (c & 1) * kC * kW;
    float* const xp = sf + L::kXP + (c & 1) * kW;
    float* const xa = sf + L::kXA + (c & 1) * kC * kC;
    if (a.staged) asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the chunk is staged; the last chunk's reads are done

    // 1. The block's channels and slab in f32, four channels a thread;
    // missing steps r = k = v = 0, w = 1, so that every loop below may run
    // over the whole chunk.  r and k go where the cluster will read them.
    // All reads come before the writes, so that no read waits on a write.
    {
      constexpr int kIt = kC * kW / (4 * kThreads);
      float4 rv[kIt], kv[kIt], vv[kIt], wv[kIt];
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int idx = 4 * (tid + it * kThreads);
        const int tt = idx / kW, d = idx % kW;
        rv[it] = kv[it] = vv[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        wv[it] = make_float4(1.f, 1.f, 1.f, 1.f);
        if (tt < n) {
          if (a.staged) {
            rv[it] = load4(reinterpret_cast<const TI*>(smem + L::kRawR) + idx);
            kv[it] = load4(reinterpret_cast<const TI*>(smem + L::kRawK) + idx);
            vv[it] = load4(reinterpret_cast<const TI*>(smem + L::kRawV) + idx);
            wv[it] = load4(reinterpret_cast<const TW*>(smem + L::kRawW) + idx);
          } else {
            const long long t = t0 + tt;
            rv[it] = load4(r + t * ts[0] + d);
            kv[it] = load4(k + t * ts[1] + d);
            vv[it] = load4(v + t * ts[2] + d);
            wv[it] = load4(w + t * ts[3] + d);
          }
        }
      }
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int idx = 4 * (tid + it * kThreads);
        const int tt = idx / kW, d = idx % kW;
        *reinterpret_cast<float4*>(xr + idx) = rv[it];
        *reinterpret_cast<float4*>(xk + idx) = kv[it];
        *reinterpret_cast<float4*>(wo + idx) = wv[it];
        *reinterpret_cast<float4*>(vs + tt * kLdV + d) = vv[it];
      }
    }
    __syncthreads();
    if (a.staged && c + 1 < n_chunks)  // the staging buffer is free again
      stage_chunk<TI, TW, D>(smem, r, k, v, w, ts, t0 + kC,
                             min(kC, a.t - t0 - kC));

    // 2. A over the block's 32 channels.  Thread (sp, q) takes columns
    // sa = sp and sb = C - 1 - sp together (so every warp walks C steps,
    // each row of r and w read once for both) over channels 4q .. 4q + 3;
    // the 8 threads of a column reduce-scatter their partial rows.  Rows
    // past the chunk's length have r = 0 and give zeros.
    {
      const int q = lane & 7, sp = tid >> 3;
      const int sa = sp, sb = kC - 1 - sp;
      const float4 uq = ld4(us + 4 * q);
      const float4 ra = ld4(xr + sa * kW + 4 * q), rb = ld4(xr + sb * kW + 4 * q);
      float4 ka = ld4(xk + sa * kW + 4 * q), kb = ld4(xk + sb * kW + 4 * q);
      const float diag_a = ra.x * uq.x * ka.x + ra.y * uq.y * ka.y +
                           ra.z * uq.z * ka.z + ra.w * uq.w * ka.w;
      const float diag_b = rb.x * uq.x * kb.x + rb.y * uq.y * kb.y +
                           rb.z * uq.z * kb.z + rb.w * uq.w * kb.w;
      float pa[kC], pb[kC / 2];  // column sa's rows; column sb's rows 16 ..
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float4 rv = ld4(xr + t * kW + 4 * q);
        const float4 wv = ld4(wo + t * kW + 4 * q);
        // k_s * prod_{s<q<t} w_q, a running product down each column
        pa[t] = t == sa ? diag_a : 0.f;
        if (t > sa) {
          pa[t] = dot4(rv, ka, 0.f);
          ka.x *= wv.x;
          ka.y *= wv.y;
          ka.z *= wv.z;
          ka.w *= wv.w;
        }
        if (t >= kC / 2) {
          float& p = pb[t - kC / 2];
          p = t == sb ? diag_b : 0.f;
          if (t > sb) {
            p = dot4(rv, kb, 0.f);
            kb.x *= wv.x;
            kb.y *= wv.y;
            kb.z *= wv.z;
            kb.w *= wv.w;
          }
        }
      }
      // reduce-scatter over the 8 lanes of the column pair (xor 4, 2, 1):
      // lane q keeps rows 4q .. 4q + 3 of column sa and 16 + 2q, 17 + 2q of sb
      float a16[16], a8[8], a4[4], b8[8], b4[4], b2[2];
      {
        const bool up = q & 4;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float send = up ? pa[e] : pa[e + 16];
          a16[e] = (up ? pa[e + 16] : pa[e]) + __shfl_xor_sync(0xffffffffu, send, 4);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float send = up ? pb[e] : pb[e + 8];
          b8[e] = (up ? pb[e + 8] : pb[e]) + __shfl_xor_sync(0xffffffffu, send, 4);
        }
      }
      {
        const bool up = q & 2;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float send = up ? a16[e] : a16[e + 8];
          a8[e] = (up ? a16[e + 8] : a16[e]) + __shfl_xor_sync(0xffffffffu, send, 2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = up ? b8[e] : b8[e + 4];
          b4[e] = (up ? b8[e + 4] : b8[e]) + __shfl_xor_sync(0xffffffffu, send, 2);
        }
      }
      {
        const bool up = q & 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = up ? a8[e] : a8[e + 4];
          a4[e] = (up ? a8[e + 4] : a8[e]) + __shfl_xor_sync(0xffffffffu, send, 1);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = up ? b4[e] : b4[e + 2];
          b2[e] = (up ? b4[e + 2] : b4[e]) + __shfl_xor_sync(0xffffffffu, send, 1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[(4 * q + e) * kC + sa] = a4[e];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        xa[(2 * q + e) * kC + sb] = 0.f;  // above column sb's diagonal
        xa[(kC / 2 + 2 * q + e) * kC + sb] = b2[e];
      }
    }
    __syncthreads();

    // 3. The decays of the block's channels as running products over the
    // whole chunk (w = 1 past its length), lane = channel, each warp a half
    // of the steps: r *= P_prev (warps 0, 1) and P_C, k *= Q (warps 2, 3).
    // The second half's products start from the first half's total.
    {
      constexpr int kH = kC / 2;
      float wv[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) wv[t] = wo[t * kW + lane];
      float f = 1.f;
      if (warp == 1) {
#pragma unroll
        for (int t = 0; t < kH; ++t) f *= wv[t];
      } else if (warp == 3) {
#pragma unroll
        for (int t = kH; t < kC; ++t) f *= wv[t];
      }
      if (warp == 0) decay_run<0, 1>(xr, wv, f, lane);
      if (warp == 1) xp[lane] = decay_run<kH, 1>(xr, wv, f, lane);
      if (warp == 2) decay_run<kC - 1, -1>(xk, wv, f, lane);
      if (warp == 3) decay_run<kH - 1, -1>(xk, wv, f, lane);
    }
    cluster.sync();  // every block's channels and partial A are ready

    // 4. Gather the cluster's channels and sum its partial A in rank order,
    // all remote reads before the local writes.
    {
      constexpr int kV4 = kC * kW / 4;   // float4 of one block's r or k
      constexpr int kIt = kNB * kV4 / kThreads, kItA = kC * kC / (4 * kThreads);
      float4 rv[kIt], kv[kIt], av[kItA];
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int idx = tid + it * kThreads;
        const int rank = idx / kV4, e = (idx % kV4) * 4;
        rv[it] = ld4(cluster.map_shared_rank(xr, rank) + e);
        kv[it] = ld4(cluster.map_shared_rank(xk, rank) + e);
      }
      const float p = tid < D ? cluster.map_shared_rank(xp, tid / kW)[tid % kW] : 0.f;
#pragma unroll
      for (int it = 0; it < kItA; ++it) {
        const int e = (tid + it * kThreads) * 4;
        av[it] = ld4(cluster.map_shared_rank(xa, 0) + e);
#pragma unroll
        for (int rank = 1; rank < kNB; ++rank) {
          const float4 x = ld4(cluster.map_shared_rank(xa, rank) + e);
          av[it].x += x.x;
          av[it].y += x.y;
          av[it].z += x.z;
          av[it].w += x.w;
        }
      }
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int idx = tid + it * kThreads;
        const int rank = idx / kV4, e = (idx % kV4) * 4;
        const int tt = e / kW, d = e % kW;
        *reinterpret_cast<float4*>(rf + tt * kLd + rank * kW + d) = rv[it];
        *reinterpret_cast<float4*>(kf + tt * kLdK + rank * kW + d) = kv[it];
      }
      if (tid < D) pf[tid] = p;
#pragma unroll
      for (int it = 0; it < kItA; ++it) {
        const int e = (tid + it * kThreads) * 4;
        *reinterpret_cast<float4*>(af + (e / kC) * kLdC + e % kC) = av[it];
      }
    }
    __syncthreads();

    // 5. y = A v + (r * P_prev) S on the tensor cores, f32-accurate in three
    // TF32 products: warp w takes rows 16 * (w / 2) .. + 15 and columns
    // 16 * (w % 2) .. + 15 of the chunk's 32 x 32 block.  A is zero above
    // its diagonal, so the rows of the first half stop at column 15.
    {
      const int ym = warp >> 1, yn = 2 * (warp & 1);
      float yc[2][4] = {}, yo[2][4] = {};  // even and odd k-steps: two chains
#pragma unroll
      for (int ks = 0; ks < kC / 8; ++ks) {
        if (ks >= 2 * (ym + 1)) break;  // above A's diagonal
        const float* ar = af + (16 * ym + g) * kLdC + 8 * ks + t4;
        FragA fa;
        fa.set(ar[0], ar[8 * kLdC], ar[4], ar[8 * kLdC + 4]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const float* br = vs + (8 * ks + t4) * kLdV + 8 * (yn + nn) + g;
          FragB fb;
          fb.set(br[0], br[4 * kLdV]);
          mma3(ks & 1 ? yo[nn] : yc[nn], fa, fb);
        }
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const float* ar = rf + (16 * ym + g) * kLd + 8 * ks + t4;
        FragA fa;
        fa.set(ar[0], ar[8 * kLd], ar[4], ar[8 * kLd + 4]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const float* br = st + (8 * (yn + nn) + g) * kLd + 8 * ks + t4;
          FragB fb;
          fb.set(br[0], br[4]);
          mma3(ks & 1 ? yo[nn] : yc[nn], fa, fb);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * ym + g + 8 * hh;
          if (row < n) {
            TI* yt = y + static_cast<long long>(t0 + row) * D + 8 * (yn + nn) + 2 * t4;
            store_as(yt, yc[nn][2 * hh] + yo[nn][2 * hh]);
            store_as(yt + 1, yc[nn][2 * hh + 1] + yo[nn][2 * hh + 1]);
          }
        }
    }

    // 6. The state on the tensor cores: S = P_C * S + (k * Q)^T v.
    {
#pragma unroll
      for (int nn = 0; nn < kTiles; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nn][e] *= pf[s_at(nn, e).x];
#pragma unroll
      for (int ks = 0; ks < kC / 8; ++ks) {
        const float* ar = kf + (8 * ks + t4) * kLdK + 16 * sm + g;
        FragA fa;
        fa.set(ar[0], ar[8], ar[4 * kLdK], ar[4 * kLdK + 8]);
#pragma unroll
        for (int nn = 0; nn < kTiles; ++nn) {
          const float* br = vs + (8 * ks + t4) * kLdV + 8 * (sn + nn) + g;
          FragB fb;
          fb.set(br[0], br[4 * kLdV]);
          mma3(sc[nn], fa, fb);
        }
      }
      __syncthreads();  // every warp's y has read the old slab
#pragma unroll
      for (int nn = 0; nn < kTiles; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int2 ij = s_at(nn, e);
          st[ij.y * kLd + ij.x] = sc[nn][e];
        }
    }
  }
  cluster.sync();  // no block leaves while another may read its memory
#pragma unroll
  for (int nn = 0; nn < kTiles; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 ij = s_at(nn, e);
      a.s_out[sbase + ij.x * D + ij.y] = sc[nn][e];
    }
}

// One step (T = 1, a decode step): the chunk form of a one-step chunk,
// which is the recurrence itself.  Block (b, h, slab of 16 columns) of 128
// threads, each with D / 8 rows of one slab column; the partial y of the
// 8 row groups of a column is summed in a fixed order.  Small enough that
// the whole grid is resident at once.
template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(kThreads) rwkv6_step_kernel(Args a) {
  constexpr int kNB = D / kStepW;
  constexpr int kRows = D / 8;
  __shared__ float rs[D], ks[D], ws[D], ru[D], vs[kStepW];
  __shared__ float red[kThreads / 32][kStepW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / kNB, j0 = (blockIdx.x % kNB) * kStepW;
  const int b = bh / a.h, h = bh % a.h;
  for (int i = tid; i < D; i += kThreads) {
    const float ri = to_f32(static_cast<const TI*>(a.r)[b * a.st[0] + h * a.st[1] + i]);
    rs[i] = ri;
    ks[i] = to_f32(static_cast<const TI*>(a.k)[b * a.st[3] + h * a.st[4] + i]);
    ws[i] = to_f32(static_cast<const TW*>(a.w)[b * a.st[9] + h * a.st[10] + i]);
    ru[i] = ri * a.u[h * D + i];
  }
  if (tid < kStepW)
    vs[tid] = to_f32(static_cast<const TI*>(a.v)[b * a.st[6] + h * a.st[7] + j0 + tid]);
  const int j = lane & 15;
  const int i0 = kRows * (2 * warp + (lane >> 4));
  const long long sbase = static_cast<long long>(bh) * D * D + j0 + j;
  float s[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) s[q] = a.s0 ? a.s0[sbase + (i0 + q) * D] : 0.f;
  __syncthreads();
  const float vj = vs[j];
  float acc = 0.f, bonus = 0.f;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i0 + q;
    acc = fmaf(rs[i], s[q], acc);
    bonus = fmaf(ru[i], ks[i], bonus);
    a.s_out[sbase + i * D] = fmaf(ws[i], s[q], ks[i] * vj);
  }
  acc = fmaf(bonus, vj, acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (lane < 16) red[warp][j] = acc;
  __syncthreads();
  if (tid < kStepW) {
    float yv = red[0][tid];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) yv += red[q][tid];
    store_as(static_cast<TI*>(a.y) + static_cast<long long>(bh) * D + j0 + tid, yv);
  }
}

bool aligned16(const void* p, const long long* st, int esz) {
  if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  for (int i = 0; i < 3; ++i)
    if ((st[i] * esz) % 16) return false;
  return true;
}

template <typename TI, typename TW, int D>
int launch_d(Args& a, cudaStream_t stream) {
  constexpr int kNB = D / kW;
  if (a.t == 1) {
    rwkv6_step_kernel<TI, TW, D><<<a.b * a.h * (D / kStepW), kThreads, 0, stream>>>(a);
    return REPRO_LAUNCH_STATUS();
  }
  using L = Smem<TI, TW, D>;
  auto kernel = rwkv6_kernel<TI, TW, D>;
  constexpr int kBytes = L::kBytes;
  if (kBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 32 channels of each row (and of v's slab) start 16-byte aligned
  a.staged = aligned16(a.r, a.st, sizeof(TI)) &&
             aligned16(a.k, a.st + 3, sizeof(TI)) &&
             aligned16(a.v, a.st + 6, sizeof(TI)) &&
             aligned16(a.w, a.st + 9, sizeof(TW));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.h * kNB);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kNB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return REPRO_LAUNCH_STATUS();
}

template <typename TI, typename TW>
int rwkv6_entry(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* s0, void* y, float* s_out, int b,
                int h, int t, int d, const long long* strides, int device,
                void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0) return 0;
  if (t < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, w, u, s0, y, s_out, b, h, t, 0, {}};
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<TI, TW, 32>(a, s);
    case 64:
      return launch_d<TI, TW, 64>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// D in {32, 64} (clusters of D / 32 blocks); strides: 12 element strides,
// (batch, head, time) of r, then k, v and w; s0 may be null (a zero state).
// _f32: r, k, v, w float32; _bf16: r, k, v bfloat16 and w float32 (as the
// model passes them); _bf16w: all bfloat16.
REPRO_API int repro_rwkv6_scan_f32(const void* r, const void* k, const void* v,
                                   const void* w, const float* u,
                                   const float* s0, void* y, float* s_out,
                                   int b, int h, int t, int d,
                                   const long long* strides, int device,
                                   void* stream) {
  return rwkv6_entry<float, float>(r, k, v, w, u, s0, y, s_out, b, h, t, d,
                                   strides, device, stream);
}

REPRO_API int repro_rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                                    const void* w, const float* u,
                                    const float* s0, void* y, float* s_out,
                                    int b, int h, int t, int d,
                                    const long long* strides, int device,
                                    void* stream) {
  return rwkv6_entry<__nv_bfloat16, float>(r, k, v, w, u, s0, y, s_out, b, h,
                                           t, d, strides, device, stream);
}

REPRO_API int repro_rwkv6_scan_bf16w(const void* r, const void* k,
                                     const void* v, const void* w,
                                     const float* u, const float* s0, void* y,
                                     float* s_out, int b, int h, int t, int d,
                                     const long long* strides, int device,
                                     void* stream) {
  return rwkv6_entry<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, w, u, s0, y, s_out, b, h, t, d, strides, device, stream);
}

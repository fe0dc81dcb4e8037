// The gradient of the RWKV-6 WKV scan (csrc/rwkv6_scan.cu) with no state in
// and no gradient into the final state, the training path's case: r/k/v/w
// (B, H, T, D), u (H, D) and the output's gradient dy (B, H, T, D) ->
// dr, dk, dv (B, H, T, D) in r's dtype, dw (B, H, T, D) f32, du (H, D) f32.
//
// Replaces no TPU kernel: the JAX package trains rwkv6-3b through jax.grad
// of its XLA path (src/repro/kernels/rwkv6_scan/ops.py:_chunk_body under
// jax.lax.scan), and the TPU kernel _rwkv6_kernel has no VJP.
//
// The math, per (b, h), with S_t = diag(w_t) S_{t-1} + k_t v_t^T (S_{-1} = 0)
// and y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T); G_t = dL/dS_t, G_{T-1} = 0:
//
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//     dr_t    = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t    = G_t v_t + u * r_t (v_t . dy_t)
//     dv_t    = G_t^T k_t + (r_t . (u * k_t)) dy_t
//     dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//     du      = sum_t r_t * k_t (v_t . dy_t)
//
// What bounds it on the H100: at rwkv6-3b's training shape (B = 8, H = 40,
// T = 128, D = 64) it reads r, k, v, dy (bf16) and w (f32) and writes dr,
// dk, dv (bf16) and dw (f32), about 58 MB (17 us at 3.35 TB/s), against 6
// FMAs a state entry a step by the per-step recurrences (2.0 GFLOP, 30 us
// at 67 TFLOP/s).  What bounds a kernel that walks the steps one at a time
// is the latency of each step's chain; this one takes the forward's chunked
// form, run backwards, so that a chunk of kC = 32 steps is a few small
// matrix products on the tensor cores and a few running products a channel.
//
// A chunk's gradients, with S0 the state before it, G_end = dL/dS after
// its last step, B = V dY^T (C x C), P_prev[t] = prod_{q<t} w_q,
// Q[t] = prod_{q>t} w_q, P_C = prod_q w_q and A the forward's chunk matrix
// (A[t][s] = sum_i r_t k_s prod_{s<q<t} w_q below the diagonal, the u
// bonus on it):
//
//     dL/dS0 = P_C * G_end + (r * P_prev)^T dY          (the carry)
//     dv     = (k * Q) G_end + A^T dY
//     P1 = dY S0^T,  P2 = V G_end^T,  c_i = <S0_i, G_end,i>
//
// and per channel i three running recurrences, each factor a decay in
// [0, 1]: Y[q] = (S_{t-1} dy_q)_i ascending in t (Y = P1 at t = 0,
// Y[q] <- w_t Y[q] + k_t B[t][q]) gives dr_t = Y[t] + u k_t B[t][t];
// H[s] = (G_t v_s)_i and U = <G_t,i, S0_i> descending in t (H = P2 and
// U = c at t = C - 1, H[s] <- w_t H[s] + r_t B[s][t], U <- w_t U + r_t P1[t])
// give dk_t = H[t] + u r_t B[t][t] and
//
//     dw_t = P_prev,t U + sum_{s<t} (prod_{s<q<t} w_q) k_s H[s],
//
// which is dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j] expanded, never a
// difference of cumulative log w nor a division by w: that form (the
// chunked XLA path's jax.grad, the plain version's autograd) loses dw where
// w is small (ROADMAP.md queue 3), while this one is exact to f32 rounding
// for any w in [0, 1], w = 0 included.  tests/test_torch_rwkv_bwd_design.py
// holds the algorithm step by step against jax.grad and the float64
// gradient.
//
// The design:
// * One block of 8 D threads (512 at D = 64) per (b, h), holding the whole
//   D x D carry G in the MMA accumulators of its warps from chunk to chunk:
//   every sum over the state's columns is a product inside the block, with
//   no exchange between blocks and no atomics.
// * The chunk states by a forward sweep of the chunked update
//   S = P_C * S + (k * Q)^T V inside the same launch, kept in shared memory
//   (3 x 17 KB at the training shape, 169 KB in all: one block an SM);
//   only a T whose states do not fit (T > 224 at D = 64) keeps them in a
//   scratch buffer of the wrapper's.
// * The products (the carry, dv, B, P1, P2, the sweep's S) on the tensor
//   cores: mma.sync m16n8k8 in TF32, each operand split in a TF32 high part
//   and its rounding error, three products a step (the forward kernel's
//   f32-accurate scheme); a bf16 input (r, k, v, dy) is exact in TF32, so
//   its low part and the products with it are not taken.  A warp takes a
//   strip of 16 rows by up to four 8-column tiles, one A fragment split for
//   all of them.  A, the decays and the walks on the CUDA cores in f32.
// * The walks take every thread: 8 a channel, each holding 4 consecutive
//   steps of Y and of H in registers (the owner of a step and its slot are
//   known at compile time, so nothing is indexed at run time), dr's and dk's
//   and dw's chains side by side in one loop, without branches.  dr, dk and
//   dw wait in shared memory and go to device memory in whole rows after
//   the chunk; the next chunk's rows are fetched into L2 meanwhile.
// * r, k, v, w and dy are read in place: any strides over b, h and t, the
//   last axis contiguous (the model passes transposed views); dr, dk, dv
//   and dw are written through their own strides.
// * Every sum has a fixed order: two calls give the same bits (remat
//   recomputes, and its gradients must not move).  du is a per-(b, h)
//   partial, summed over b in order by rwkv6_du_sum_kernel.
//
// What holds it at the training shape (clock64 at the barriers, H100):
// the walks, O(D C^2) running products a chunk on the CUDA cores, about
// half of a block's cycles, latency-bound; and one block an SM (the chunk
// states and the staged chunk take 169 KB) over 320 blocks: three waves.
//
// Any T works: the last chunk's missing steps are r = k = v = dy = 0 and
// w = 1 in shared memory, which add nothing, and are never stored.
#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kC = 32;          // steps a chunk (the forward kernel's)
// threads a channel: a block has 8 D threads (512 at D = 64)
constexpr int kThreadsPerChannel = 8;
template <int D>
constexpr int kThreadsOf = kThreadsPerChannel * D;
constexpr int kLdC = kC + 8;    // words between rows of A and of B

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

// c (a strip of NT 16 x 8 tiles: rows g and g + 8, columns 8 n + 2 t4 and
// 8 n + 2 t4 + 1 of tile n) += the product over kK k-steps of 8 of a(m, k)
// (16 rows) and b(k, col) (8 NT columns), in f32 accuracy from three TF32
// products a step, the small ones first (a_lo b_lo, about 2^-22 of a b, is
// dropped).  An operand that TF32 holds exactly (kAExact, kBExact: a
// bf16 input) has no low part, and its product with a low part, exactly
// zero, is not taken.  a's fragment is split once a step for the NT tiles,
// whose accumulators are NT independent chains.
template <int kK, bool kAExact, bool kBExact, int NT, class FA, class FB>
__device__ __forceinline__ void mma_strip(float (&c)[NT][4], FA a, FB b, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < kK; ++ks) {
    const int k0 = 8 * ks + t4;
    const float av[4] = {a(g, k0), a(g + 8, k0), a(g, k0 + 4), a(g + 8, k0 + 4)};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kAExact)
        ah[e] = __float_as_uint(av[e]);
      else
        split_tf32(av[e], ah[e], al[e]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float bv[2] = {b(k0, 8 * n + g), b(k0 + 4, 8 * n + g)};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (kBExact)
          bh[e] = __float_as_uint(bv[e]);
        else
          split_tf32(bv[e], bh[e], bl[e]);
      }
      if constexpr (!kAExact) mma_tf32(c[n], al, bh);
      if constexpr (!kBExact) mma_tf32(c[n], ah, bl);
      mma_tf32(c[n], ah, bh);
    }
  }
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;        // (H, D)
  const void* dy;        // r's dtype
  void* dr;              // r's dtype
  void* dk;
  void* dv;
  float* dw;
  float* hist;           // spilled chunk states (B H, chunks - 1, D, D + 4) or null
  float* du_part;        // (B, H, D)
  float* du;             // (H, D)
  int b, h, t;
  long long st[27];      // (b, h, t) strides of r, k, v, w, dy, dr, dk, dv, dw
};

// Shared memory of a block, in words.
template <int D>
struct Smem {
  static constexpr int kLd = D + 4;    // rows of the staged inputs, G and the states
  static constexpr int kLdP = D + 8;   // rows of r P_prev, k Q, P1 and P2
  static constexpr int kR = 0;         // [kC][kLd] each: r, k, w, v, dy
  static constexpr int kK = kR + kC * kLd;
  static constexpr int kWd = kK + kC * kLd;
  static constexpr int kV = kWd + kC * kLd;
  static constexpr int kDy = kV + kC * kLd;
  static constexpr int kRP = kDy + kC * kLd;   // [kC][kLdP] each: r P_prev, k Q, P1, P2
  static constexpr int kKQ = kRP + kC * kLdP;
  static constexpr int kP1 = kKQ + kC * kLdP;
  static constexpr int kP2 = kP1 + kC * kLdP;
  static constexpr int kPP = kP2 + kC * kLdP;  // [kC][D]: P_prev
  static constexpr int kA = kPP + kC * D;      // [kC][kLdC]
  static constexpr int kB = kA + kC * kLdC;    // [kC][kLdC]
  static constexpr int kBT = kB + kC * kLdC;   // [kC][kLdC]: B transposed
  static constexpr int kG = kBT + kC * kLdC;   // [D][kLd]: G_end
  static constexpr int kPC = kG + D * kLd;     // [D]
  static constexpr int kCc = kPC + D;          // [D]
  static constexpr int kU = kCc + D;           // [D]
  static constexpr int kHist = kU + D;         // [chunks - 1][D][kLd], when they fit
  static constexpr int kState = D * kLd;       // words of one chunk state
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Rows [t0, t0 + n) of k, w, v (and with kAll r and dy) into L2: a thread
// a row of one input, its 128-byte lines.
template <typename TI, typename TW, int D, bool kAll>
__device__ __forceinline__ void prefetch_rows(const TI* r, const TI* k, const TW* w,
                                              const TI* v, const TI* dy,
                                              const long long* ts, int t0, int n) {
  const int row = threadIdx.x % kC, x = threadIdx.x / kC;
  if (x >= 5 || row >= n || (!kAll && (x == 0 || x == 4))) return;
  const long long t = t0 + row;
  const char* line = x == 0   ? reinterpret_cast<const char*>(r + t * ts[0])
                     : x == 1 ? reinterpret_cast<const char*>(k + t * ts[1])
                     : x == 2 ? reinterpret_cast<const char*>(v + t * ts[2])
                     : x == 3 ? reinterpret_cast<const char*>(w + t * ts[3])
                              : reinterpret_cast<const char*>(dy + t * ts[4]);
  const int bytes = D * static_cast<int>(x == 3 ? sizeof(TW) : sizeof(TI));
  for (int o = 0; o < bytes; o += 128) prefetch_l2(line + o);
}

// One chunk's rows of r, k, w, v and dy as f32, kIt values of each a
// thread: element idx = threadIdx.x + it * 8 D is step idx / D, channel
// idx % D.
template <int D>
struct Rows {
  static constexpr int kIt = kC / kThreadsPerChannel;
  float r[kIt], k[kIt], w[kIt], v[kIt], dy[kIt];
};

// Rows [t0, t0 + n) of k, w, v (and with kAll r and dy) from device memory;
// missing steps are zeros (w: ones).
template <typename TI, typename TW, int D, bool kAll>
__device__ __forceinline__ void load_rows(Rows<D>& x, const TI* r, const TI* k,
                                          const TW* w, const TI* v, const TI* dy,
                                          const long long* ts, int t0, int n) {
#pragma unroll
  for (int it = 0; it < Rows<D>::kIt; ++it) {
    const int idx = threadIdx.x + it * kThreadsOf<D>;
    const int tt = idx / D, d = idx % D;
    const bool ok = tt < n;
    const long long t = t0 + tt;
    x.k[it] = ok ? to_f32(k[t * ts[1] + d]) : 0.f;
    x.w[it] = ok ? to_f32(w[t * ts[3] + d]) : 1.f;
    x.v[it] = ok ? to_f32(v[t * ts[2] + d]) : 0.f;
    if constexpr (kAll) {
      x.r[it] = ok ? to_f32(r[t * ts[0] + d]) : 0.f;
      x.dy[it] = ok ? to_f32(dy[t * ts[4] + d]) : 0.f;
    }
  }
}

// ... into the [kC][kLd] buffers.
template <int D, bool kAll>
__device__ __forceinline__ void store_rows(float* sm, const Rows<D>& x) {
  using L = Smem<D>;
#pragma unroll
  for (int it = 0; it < Rows<D>::kIt; ++it) {
    const int idx = threadIdx.x + it * kThreadsOf<D>;
    const int o = (idx / D) * L::kLd + idx % D;
    sm[L::kK + o] = x.k[it];
    sm[L::kWd + o] = x.w[it];
    sm[L::kV + o] = x.v[it];
    if constexpr (kAll) {
      sm[L::kR + o] = x.r[it];
      sm[L::kDy + o] = x.dy[it];
    }
  }
}

// A over all D channels, by half the block (tid2 in [0, 4 D)): thread
// (sp, q) takes columns sa = sp and sb = C - 1 - sp together (so every
// thread walks C steps) over kCh channels from q kCh, a running product
// down each column; the kLanes threads of a column pair reduce-scatter
// their partial rows.
template <int D>
__device__ __forceinline__ void a_matrix(float* sm, int tid2) {
  using L = Smem<D>;
  constexpr int kLd = L::kLd, kLanes = kThreadsOf<D> / 2 / 16, kCh = D / kLanes;
  constexpr int kV = kCh / 4;                 // float4 of a lane's channels
  const float* rs = sm + L::kR;
  const float* ks = sm + L::kK;
  const float* ws = sm + L::kWd;
  const float* us = sm + L::kU;
  float* am = sm + L::kA;
  const int lane = tid2 & 31, q = tid2 % kLanes, sp = tid2 / kLanes;
  const int sa = sp, sb = kC - 1 - sp, c0 = q * kCh;
  auto ld4 = [](const float* p) { return *reinterpret_cast<const float4*>(p); };
  float4 ka[kV], kb[kV];
  float diag_a = 0.f, diag_b = 0.f;
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    ka[c] = ld4(ks + sa * kLd + c0 + 4 * c);
    kb[c] = ld4(ks + sb * kLd + c0 + 4 * c);
    const float4 uq = ld4(us + c0 + 4 * c);
    const float4 ra = ld4(rs + sa * kLd + c0 + 4 * c);
    const float4 rb = ld4(rs + sb * kLd + c0 + 4 * c);
    diag_a += ra.x * uq.x * ka[c].x + ra.y * uq.y * ka[c].y + ra.z * uq.z * ka[c].z +
              ra.w * uq.w * ka[c].w;
    diag_b += rb.x * uq.x * kb[c].x + rb.y * uq.y * kb[c].y + rb.z * uq.z * kb[c].z +
              rb.w * uq.w * kb[c].w;
  }
  auto dot = [](const float4& r, const float4& k, float acc) {
    return fmaf(r.w, k.w, fmaf(r.z, k.z, fmaf(r.y, k.y, fmaf(r.x, k.x, acc))));
  };
  auto decay = [](float4& k, const float4& w) {
    k.x *= w.x;
    k.y *= w.y;
    k.z *= w.z;
    k.w *= w.w;
  };
  float pa[kC], pb[kC / 2];  // column sa's rows; column sb's rows 16 ..
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    float4 rt[kV], wt[kV];
#pragma unroll
    for (int c = 0; c < kV; ++c) {
      rt[c] = ld4(rs + t * kLd + c0 + 4 * c);
      wt[c] = ld4(ws + t * kLd + c0 + 4 * c);
    }
    pa[t] = t == sa ? diag_a : 0.f;
    if (t > sa) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kV; ++c) d = dot(rt[c], ka[c], d);
      pa[t] = d;
#pragma unroll
      for (int c = 0; c < kV; ++c) decay(ka[c], wt[c]);
    }
    if (t >= kC / 2) {
      float& p = pb[t - kC / 2];
      p = t == sb ? diag_b : 0.f;
      if (t > sb) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < kV; ++c) d = dot(rt[c], kb[c], d);
        p = d;
#pragma unroll
        for (int c = 0; c < kV; ++c) decay(kb[c], wt[c]);
      }
    }
  }
  // reduce-scatter over the column pair's lanes: lane q keeps rows ia ..
  // of column sa and 16 + ib .. of column sb
  constexpr int kRa = kC / kLanes, kRb = kC / 2 / kLanes;
  int ia = 0, ib = 0;
  warp_reduce_scatter<kC, kLanes / 2, 1>(pa, lane, ia);
  warp_reduce_scatter<kC / 2, kLanes / 2, 1>(pb, lane, ib);
#pragma unroll
  for (int e = 0; e < kRa; ++e) am[(ia + e) * kLdC + sa] = pa[e];
#pragma unroll
  for (int e = 0; e < kRb; ++e) {
    am[(q * kRb + e) * kLdC + sb] = 0.f;  // above column sb's diagonal
    am[(kC / 2 + ib + e) * kLdC + sb] = pb[e];
  }
}

// The running recurrences take every thread: kP = kThreadsPerChannel
// threads a channel i, part p of it owning the kM consecutive steps
// b0 = kM p .. b0 + kM - 1 of Y and of H (so step t's owner, part t / kM,
// and its slot t % kM are known at compile time).  Each step's result is
// written by its owner into a [kC][kLdP] staging buffer, stored to device
// memory after the chunk.

// The walks of channel i, part p, in one loop whose step j takes dr's step
// j and dk's and dw's step C - 1 - j, two independent chains side by side.
//
// dr: Y[q] = (S_{t-1} dy_q)_i, ascending in t.
//
// dk, dw and the chunk's share of du: H[s] = (G_t v_s)_i and
// U = <G_t,i, S0_i>, descending in t.  dw_t's sum over s < t is split over
// the kP parts: a part whose steps all lie below t adds E(t) sum_m c_m H[b0
// + m], with c_m = k_s prod_{s<q<b0+kM} w_q and E(t) = prod_{b0+kM<=q<t}
// w_q (a table taken ascending before the walk); the part that holds t
// walks its steps below t down with a running product; the parts' sums
// meet by a butterfly, then P_prev,t U is added.  Both forms are taken and
// one kept, so that no branch splits the unrolled steps.  dw takes P2's
// place once every thread has read it.
template <int D>
__device__ __forceinline__ void walks(float* sm, int i, int p, float& du_acc) {
  using L = Smem<D>;
  constexpr int kP = kThreadsPerChannel, kM = kC / kP;
  static_assert(kM == 4, "a float4 of B a part");
  const float* rs = sm + L::kR;
  const float* ks = sm + L::kK;
  const float* ws = sm + L::kWd;
  const float* p1 = sm + L::kP1;
  const float* pp = sm + L::kPP;
  const float* bm = sm + L::kB;
  const float* bt = sm + L::kBT;
  float* drs = sm + L::kRP;
  float* dks = sm + L::kKQ;
  float* dws = sm + L::kP2;
  const int b0 = kM * p;
  float y[kM], hv[kM], kv[kM], wb[kM], cm[kM], e[kC];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    y[m] = p1[(b0 + m) * L::kLdP + i];
    hv[m] = dws[(b0 + m) * L::kLdP + i];
    kv[m] = ks[(b0 + m) * L::kLd + i];
    wb[m] = ws[(b0 + m) * L::kLd + i];
  }
  {
    float f = 1.f;
#pragma unroll
    for (int m = kM - 1; m >= 0; --m) {
      cm[m] = kv[m] * f;                      // k_s prod_{s<q<b0+kM} w_q
      f *= wb[m];
    }
    f = 1.f;                                  // e[t] = prod_{b0+kM<=q<t} w_q
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      if (t > 0) {
        const float wq = ws[(t - 1) * L::kLd + i];
        if (t > b0 + kM) f *= wq;
      }
      e[t] = f;
    }
  }
  float uc = sm[L::kCc + i];
  const float ui = sm[L::kU + i];
  __syncthreads();                            // P2 is read
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    {                                         // dr's step t = j
      const int t = j, pt = t / kM, mt = t % kM;
      const float wt = ws[t * L::kLd + i], kt = ks[t * L::kLd + i];
      const float4 bq = *reinterpret_cast<const float4*>(bm + t * kLdC + b0);  // B[t][b0 ..]
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float drt = fmaf(ui * kt, bv[mt], y[mt]);
      if (p == pt) drs[t * L::kLdP + i] = drt;
#pragma unroll
      for (int m = 0; m < kM; ++m)
        if (p > pt || (p == pt && m > mt)) y[m] = fmaf(wt, y[m], kt * bv[m]);
    }
    {                                         // dk's and dw's step t = C - 1 - j
      const int t = kC - 1 - j, pt = t / kM, mt = t % kM;
      const float rt = rs[t * L::kLd + i], wt = ws[t * L::kLd + i];
      const float4 bq = *reinterpret_cast<const float4*>(bt + t * kLdC + b0);  // B[b0 ..][t]
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      const bool own = p == pt;
      float d = cm[0] * hv[0];
#pragma unroll
      for (int m = 1; m < kM; ++m) d = fmaf(cm[m], hv[m], d);
      float walk = 0.f, f = 1.f;
#pragma unroll
      for (int m = mt - 1; m >= 0; --m) {
        walk = fmaf(f * kv[m], hv[m], walk);
        f *= wb[m];
      }
      float acc = p < pt ? e[t] * d : own ? walk : 0.f;
      const float dkt = fmaf(ui * rt, bv[mt], hv[mt]);
      if (own) dks[t * L::kLdP + i] = dkt;
      du_acc = own ? fmaf(rt * kv[mt], bv[mt], du_acc) : du_acc;
#pragma unroll
      for (int o = 1; o < kP; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const float dwt = fmaf(pp[t * D + i], uc, acc);
      if (own) dws[t * L::kLdP + i] = dwt;
#pragma unroll
      for (int m = 0; m < kM; ++m)
        if (p < pt || (p == pt && m < mt)) hv[m] = fmaf(wt, hv[m], rt * bv[m]);
      uc = fmaf(wt, uc, rt * p1[t * L::kLdP + i]);
    }
  }
}

// Rows [t0, t0 + n) of the staged dr, dk (r's dtype) and dw (f32) to
// device memory, each row through its stride.
template <typename TI, int D>
__device__ __forceinline__ void store_grads(const float* sm, TI* dr, TI* dk, float* dw,
                                            const long long* st, int t0, int n) {
  using L = Smem<D>;
#pragma unroll
  for (int it = 0; it < Rows<D>::kIt; ++it) {
    const int idx = threadIdx.x + it * kThreadsOf<D>;
    const int tt = idx / D, d = idx % D;
    if (tt < n) {
      const long long t = t0 + tt;
      const int o = tt * L::kLdP + d;
      store_as(dr + t * st[17] + d, sm[L::kRP + o]);
      store_as(dk + t * st[20] + d, sm[L::kKQ + o]);
      dw[t * st[26] + d] = sm[L::kP2 + o];
    }
  }
}

template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(kThreadsOf<D>, 1) rwkv6_bwd_kernel(Args a, int hist_smem) {
  using L = Smem<D>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP;
  constexpr int kNT = D / 8;                  // 8-column tiles across the state
  constexpr int kThreads = kThreadsOf<D>, kWarps = kThreads / 32;
  constexpr int kTiles = D * D / (128 * kWarps);  // 16 x 8 tiles of G a warp keeps
  constexpr int kP = kThreadsPerChannel;
  // bf16 inputs (r, k, v, dy) are exact in TF32: no low parts
  constexpr bool kX = std::is_same<TI, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float sm[];
  const float* const rs = sm + L::kR;
  const float* const ks = sm + L::kK;
  const float* const ws = sm + L::kWd;
  const float* const vs = sm + L::kV;
  const float* const dys = sm + L::kDy;
  float* const rp = sm + L::kRP;
  float* const kq = sm + L::kKQ;
  float* const p1 = sm + L::kP1;
  float* const p2 = sm + L::kP2;
  float* const pp = sm + L::kPP;
  const float* const am = sm + L::kA;
  float* const bm = sm + L::kB;
  float* const gs = sm + L::kG;
  float* const pc = sm + L::kPC;
  float* const cc = sm + L::kCc;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;     // MMA fragment coordinates
  const int bh = blockIdx.x, b = bh / a.h, h = bh % a.h;
  const int chunks = (a.t + kC - 1) / kC;
  float* const hist = hist_smem ? sm + L::kHist
                                : a.hist + static_cast<long long>(bh) * (chunks - 1) * L::kState;
  const long long* st = a.st;
  const TI* r = static_cast<const TI*>(a.r) + b * st[0] + h * st[1];
  const TI* k = static_cast<const TI*>(a.k) + b * st[3] + h * st[4];
  const TI* v = static_cast<const TI*>(a.v) + b * st[6] + h * st[7];
  const TW* w = static_cast<const TW*>(a.w) + b * st[9] + h * st[10];
  const TI* dy = static_cast<const TI*>(a.dy) + b * st[12] + h * st[13];
  const long long ts[5] = {st[2], st[5], st[8], st[11], st[14]};
  TI* dr = static_cast<TI*>(a.dr) + b * st[15] + h * st[16];
  TI* dk = static_cast<TI*>(a.dk) + b * st[18] + h * st[19];
  TI* dv = static_cast<TI*>(a.dv) + b * st[21] + h * st[22];
  float* dw = a.dw + b * st[24] + h * st[25];

  // The warp's tiles of the state (the sweep's S, then the carry G), as MMA
  // accumulators: rows 16 * tm + g (+ 8), columns 8 * (tn + n) + 2 t4 (+ 1).
  const int tm = warp * kTiles / kNT, tn = warp * kTiles % kNT;
  auto row_of = [&](int e) { return 16 * tm + g + 8 * (e >> 1); };
  auto col_of = [&](int n, int e) { return 8 * (tn + n) + 2 * t4 + (e & 1); };
  float acc[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (tid < D) sm[L::kU + tid] = a.u[h * D + tid];
  Rows<D> rows;

  // 1. The forward sweep: S = P_C * S + (k * Q)^T V, the state before every
  // chunk but the first kept in hist.
  for (int ch = 0; ch + 1 < chunks; ++ch) {
    load_rows<TI, TW, D, false>(rows, r, k, w, v, dy, ts, ch * kC, kC);
    __syncthreads();                          // the last chunk's reads are done
    store_rows<D, false>(sm, rows);
    __syncthreads();
    if (tid < D) {
      float p = 1.f, q = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) p *= ws[t * kLd + tid];
      pc[tid] = p;
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        kq[t * kLdP + tid] = ks[t * kLd + tid] * q;
        q *= ws[t * kLd + tid];
      }
    }
    __syncthreads();
    if (ch + 2 < chunks)                      // the next chunk's rows into L2
      prefetch_rows<TI, TW, D, false>(r, k, w, v, dy, ts, (ch + 1) * kC, kC);
    else                                      // the backward's first chunk
      prefetch_rows<TI, TW, D, true>(r, k, w, v, dy, ts, (ch + 1) * kC,
                                     a.t - (ch + 1) * kC);
#pragma unroll
    for (int n = 0; n < kTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= pc[row_of(e)];
    mma_strip<kC / 8, false, kX>(
        acc, [&](int m, int kk) { return kq[kk * kLdP + 16 * tm + m]; },
        [&](int kk, int c) { return vs[kk * kLd + 8 * tn + c]; }, g, t4);
    float* const out = hist + ch * L::kState;
#pragma unroll
    for (int n = 0; n < kTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[row_of(e) * kLd + col_of(n, e)] = acc[n][e];
  }

  // 2. Backward, chunk by chunk from the last, G_end in acc.  The next
  // chunk's rows are fetched into L2 while this one's products and walks
  // run; this chunk's dr, dk and dw wait in shared memory until the next
  // chunk's top.
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float du_acc = 0.f;
  int done_t0 = 0, done_n = 0;                // the chunk whose grads are staged
  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kC, n = min(kC, a.t - t0);
    const float* const s0 = ch > 0 ? hist + (ch - 1) * L::kState : nullptr;
    load_rows<TI, TW, D, true>(rows, r, k, w, v, dy, ts, t0, n);
    __syncthreads();                          // the last chunk's walks are done
    store_grads<TI, D>(sm, dr, dk, dw, st, done_t0, done_n);
    store_rows<D, true>(sm, rows);
#pragma unroll
    for (int nn = 0; nn < kTiles; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[row_of(e) * kLd + col_of(nn, e)] = acc[nn][e];
    __syncthreads();

    // 2a. The decays (a thread a channel), c = <S0_i, G_end,i> (the next D
    // threads) and A (the upper half of the block).
    if (tid < D) {
      float p = 1.f, q = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        pp[t * D + tid] = p;
        rp[t * kLdP + tid] = rs[t * kLd + tid] * p;
        p *= ws[t * kLd + tid];
      }
      pc[tid] = p;
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        kq[t * kLdP + tid] = ks[t * kLd + tid] * q;
        q *= ws[t * kLd + tid];
      }
    } else if (tid < 2 * D) {
      const int i = tid - D;
      float c = 0.f;
      if (s0 != nullptr && ch + 1 < chunks) {
#pragma unroll 8
        for (int j = 0; j < D; ++j) c = fmaf(s0[i * kLd + j], gs[i * kLd + j], c);
      }
      cc[i] = c;
    } else if (tid >= kThreads / 2) {
      a_matrix<D>(sm, tid - kThreads / 2);
    }
    __syncthreads();
    // the next chunk's rows into L2 while this one's products and walks run
    if (ch > 0) prefetch_rows<TI, TW, D, true>(r, k, w, v, dy, ts, t0 - kC, kC);

    // 2b. The products on the tensor cores.  The warp's own tiles of the
    // carry: G = P_C * G + (r * P_prev)^T dY.
#pragma unroll
    for (int nn = 0; nn < kTiles; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] *= pc[row_of(e)];
    mma_strip<kC / 8, false, kX>(
        acc, [&](int m, int kk) { return rp[kk * kLdP + 16 * tm + m]; },
        [&](int kk, int c) { return dys[kk * kLd + 8 * tn + c]; }, g, t4);
    // The shared products, in strips of 16 rows by kSN 8-column tiles dealt
    // round the warps: dv (C x D), P1 (C x D), P2 (C x D), B (C x C).
    {
      constexpr int kSN = D / 16;                // tiles a strip: 4 at D = 64
      constexpr int kMT = kC / 16, kDS = D / (8 * kSN), kCS = kC / (8 * kSN);
      constexpr int kDv = kMT * kDS, kPs = kMT * kDS, kBs = kMT * kCS;
      for (int x = warp; x < kDv + 2 * kPs + kBs; x += kWarps) {
        float c4[kSN][4];
#pragma unroll
        for (int nn = 0; nn < kSN; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) c4[nn][e] = 0.f;
        if (x < kDv) {                        // dv = (k Q) G_end + A^T dY
          const int m0 = 16 * (x / kDS), n0 = 8 * kSN * (x % kDS);
          if (ch + 1 < chunks)                // G_end is zero after the last chunk
            mma_strip<D / 8, false, false>(
                c4, [&](int m, int kk) { return kq[(m0 + m) * kLdP + kk]; },
                [&](int kk, int c) { return gs[kk * kLd + n0 + c]; }, g, t4);
          mma_strip<kC / 8, false, kX>(
              c4, [&](int m, int kk) { return am[kk * kLdC + m0 + m]; },
              [&](int kk, int c) { return dys[kk * kLd + n0 + c]; }, g, t4);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int tt = m0 + g + 8 * hh;
            if (tt < n) {
              TI* row = dv + (t0 + tt) * st[23] + n0 + 2 * t4;
#pragma unroll
              for (int nn = 0; nn < kSN; ++nn) {
                store_as(row + 8 * nn, c4[nn][2 * hh]);
                store_as(row + 8 * nn + 1, c4[nn][2 * hh + 1]);
              }
            }
          }
          continue;
        }
        float* out;
        int ld, m0, n0;
        if (x < kDv + kPs) {                  // P1 = dY S0^T (zero before chunk 1)
          const int y = x - kDv;
          m0 = 16 * (y / kDS), n0 = 8 * kSN * (y % kDS), out = p1, ld = kLdP;
          if (s0 != nullptr)
            mma_strip<D / 8, kX, false>(
                c4, [&](int m, int kk) { return dys[(m0 + m) * kLd + kk]; },
                [&](int kk, int c) { return s0[(n0 + c) * kLd + kk]; }, g, t4);
        } else if (x < kDv + 2 * kPs) {       // P2 = V G_end^T
          const int y = x - kDv - kPs;
          m0 = 16 * (y / kDS), n0 = 8 * kSN * (y % kDS), out = p2, ld = kLdP;
          if (ch + 1 < chunks)                // G_end is zero after the last chunk
            mma_strip<D / 8, kX, false>(
                c4, [&](int m, int kk) { return vs[(m0 + m) * kLd + kk]; },
                [&](int kk, int c) { return gs[(n0 + c) * kLd + kk]; }, g, t4);
        } else {                              // B = V dY^T
          const int y = x - kDv - 2 * kPs;
          m0 = 16 * (y / kCS), n0 = 8 * kSN * (y % kCS), out = bm, ld = kLdC;
          mma_strip<D / 8, kX, kX>(
              c4, [&](int m, int kk) { return vs[(m0 + m) * kLd + kk]; },
              [&](int kk, int c) { return dys[(n0 + c) * kLd + kk]; }, g, t4);
        }
#pragma unroll
        for (int nn = 0; nn < kSN; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + g + 8 * (e >> 1), col = n0 + 8 * nn + 2 * t4 + (e & 1);
            out[row * ld + col] = c4[nn][e];
            if (out == bm) bm[L::kBT - L::kB + col * kLdC + row] = c4[nn][e];
          }
      }
    }
    __syncthreads();

    // 2c. The running recurrences, every thread.
    walks<D>(sm, tid / kP, tid % kP, du_acc);
    done_t0 = t0;
    done_n = n;
  }
  __syncthreads();
  store_grads<TI, D>(sm, dr, dk, dw, st, done_t0, done_n);
  // du's share of channel i: the parts' sums by a butterfly
#pragma unroll
  for (int o = 1; o < kP; o <<= 1) du_acc += __shfl_xor_sync(0xffffffffu, du_acc, o);
  if (tid % kP == 0) a.du_part[static_cast<long long>(bh) * D + tid / kP] = du_acc;
}

// du = the per-(b, h) partials summed over b = 0, 1, .. in order.
__global__ void __launch_bounds__(256) rwkv6_du_sum_kernel(const float* part,
                                                           float* du, int b,
                                                           int hd) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hd) return;
  float acc = part[idx];
  for (int q = 1; q < b; ++q) acc += part[static_cast<long long>(q) * hd + idx];
  du[idx] = acc;
}

// Words of scratch a (b, h) needs for its chunk states: 0 when they fit in
// shared memory beside the rest.
template <int D>
long long scratch_words(int t, int device) {
  using L = Smem<D>;
  const long long states = static_cast<long long>((t + kC - 1) / kC - 1) * L::kState;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return (L::kHist + states) * 4 <= optin ? 0 : states;
}

template <typename TI, typename TW, int D>
int launch_d(const Args& a, int device, cudaStream_t stream) {
  using L = Smem<D>;
  const long long spill = scratch_words<D>(a.t, device);
  if (spill < 0 || (spill > 0 && a.hist == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (a.t + kC - 1) / kC;
  const int bytes = 4 * (L::kHist + (spill ? 0 : (chunks - 1) * L::kState));
  auto kernel = rwkv6_bwd_kernel<TI, TW, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.b * a.h, kThreadsOf<D>, bytes, stream>>>(a, spill ? 0 : 1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hd = a.h * D;
  rwkv6_du_sum_kernel<<<(hd + 255) / 256, 256, 0, stream>>>(a.du_part, a.du,
                                                            a.b, hd);
  return REPRO_LAUNCH_STATUS();
}

template <typename TI, typename TW>
int rwkv6_bwd_entry(const void* r, const void* k, const void* v, const void* w,
                    const float* u, const void* dy, void* dr, void* dk, void* dv,
                    float* dw, float* hist, float* du_part, float* du, int b,
                    int h, int t, int d, const long long* strides, int device,
                    void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, w, u, dy, dr, dk, dv, dw, hist, du_part, du, b, h, t, {}};
  for (int i = 0; i < 27; ++i) a.st[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<TI, TW, 32>(a, device, s);
    case 64:
      return launch_d<TI, TW, 64>(a, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Words of f32 scratch each (b, h) needs for its chunk states at this T and
// D (0: they fit in shared memory; -1: D not compiled or no device).
REPRO_API long long repro_rwkv6_scan_bwd_scratch(int t, int d, int device) {
  if (t <= 0) return 0;
  switch (d) {
    case 32:
      return scratch_words<32>(t, device);
    case 64:
      return scratch_words<64>(t, device);
    default:
      return -1;
  }
}

// D in {32, 64}; strides: 27 element strides, (batch, head, time) of r, k,
// v, w, dy, dr, dk, dv and dw, each last axis contiguous; u (H, D) f32
// contiguous; hist holds B H times repro_rwkv6_scan_bwd_scratch(t, d)
// floats (null when that is 0), du_part B H D.  _f32: r, k, v, dy, w
// float32; _bf16: r, k, v, dy bfloat16 and w float32 (as the model passes
// them); _bf16w: w bfloat16 too.  dr, dk, dv in r's dtype; dw and du
// float32.
#define REPRO_RWKV6_BWD(NAME, TI, TW)                                          \
  REPRO_API int NAME(const void* r, const void* k, const void* v,             \
                     const void* w, const float* u, const void* dy, void* dr, \
                     void* dk, void* dv, float* dw, float* hist,              \
                     float* du_part, float* du, int b, int h, int t, int d,   \
                     const long long* strides, int device, void* stream) {    \
    return rwkv6_bwd_entry<TI, TW>(r, k, v, w, u, dy, dr, dk, dv, dw, hist,   \
                                   du_part, du, b, h, t, d, strides, device,  \
                                   stream);                                   \
  }

REPRO_RWKV6_BWD(repro_rwkv6_scan_bwd_f32, float, float)
REPRO_RWKV6_BWD(repro_rwkv6_scan_bwd_bf16, __nv_bfloat16, float)
REPRO_RWKV6_BWD(repro_rwkv6_scan_bwd_bf16w, __nv_bfloat16, __nv_bfloat16)

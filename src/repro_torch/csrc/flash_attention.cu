// FlashAttention-2 forward (GQA, causal with q_offset, Dk != Dv allowed),
// for float32 and bfloat16 q/k/v; the output takes q's dtype.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel
// (launched by flash_attention_pallas), which walks a (B, H, S/bq, T/bk)
// grid with the kv axis innermost and sequential, carrying the online
// softmax state (m, l, acc) across grid steps in VMEM scratch.  Blocks on
// Hopper run in parallel and in no order, so here the kv loop runs inside
// the block: one block per (b, h, q tile of kBQ rows) keeps m, l and acc in
// registers (f32) and streams (kBK, Dk) tiles of K and (kBK, Dv) tiles of V
// through shared memory.  The kv head is h / (H / KVH), read in place:
// repeat_kv is never materialised.  Causal masking is q_offset + i >= j,
// with the -1e30 sentinel of the TPU kernel (not -inf, which would give
// exp(-inf - -inf) = NaN); kv tiles wholly above the diagonal are not
// visited, and the ragged tails of S and T are masked here (zero-filled
// tiles, masked columns, rows never stored), so nothing is padded on the
// card.  q/k/v may be strided views (any strides over b, h and the
// sequence; the head dim contiguous); the output is contiguous (B,H,S,Dv).
//
// Arithmetic per kv tile, as the TPU kernel orders it: s = (q . k) * scale
// (f32 sums of the products), masked to -1e30, m_new =
// max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new), l = l *
// alpha + rowsum p, acc = acc * alpha + p @ v; at the end acc / l, with
// l == 0 read as 1 (the TPU kernel's guard).
//
// Rows that see no key (causal, q_offset + i < 0) take what the plain
// version gives them, and with it both JAX paths: in each kv block of the
// plain version's blocking (bq = min(512, S), bk = min(512, T)) that such a
// row's q block visits, every score is the sentinel, so p = 1 on every
// column and the row is the mean of v over the first (jmax + 1) * bk
// columns of T padded with zero rows, where jmax = min(ceil(T / bk) - 1,
// floor((q_offset + (i / bq + 1) * bq - 1) / bk)); 0 when jmax < 0.  The
// main kernels do not special-case these rows; no_key_rows_kernel, launched
// after them only when q_offset < 0, overwrites them.
//
// Two kernels compute this, chosen by dtype and head dims:
//
// * flash_mma_kernel, for bfloat16 at (Dk, Dv) in {(32, 32), (64, 64),
//   (96, 96), (128, 128), (96, 64)}: both products on the tensor cores
//   with mma.sync (bf16 inputs, f32 accumulation), p kept to about 16 bits
//   as the sum of two bf16 parts (see the note above the kernel);
// * flash_kernel, for float32 (which must match a full-precision product,
//   so no TF32 tensor cores) and every other head-dim pair: f32 FMAs on the
//   CUDA cores.  128 threads hold an 8 x 2 strip of the (64, 32) score tile
//   and an 8 x (Dv / 16) strip of the output, reading q and p rows as
//   float4 broadcasts and k and v rows as contiguous float4/float2 runs.
//
// What bounds it on the H100: for qwen2.5-3b's prefill (16 heads over 2 kv
// heads of 128, S = T = 256, bf16, batch 4) the work is 0.54 G causal
// multiply-adds against 9.4 MB of inputs and outputs: 2.8 us at 3.35 TB/s
// against 1.1 us at the bf16 tensor-core peak, so bytes bound it there; at
// S = T = 4096 operations do (69 us).  The tensor-core kernel is as simple
// as the CUDA-core one: no TMA, no wgmma, no overlap of the next tile's
// loads with this tile's products; those are for a later version.
#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 16;                 // threads across columns
constexpr int kTY = kThreads / kTX;     // 8 thread rows
constexpr int kBQ = 64;                 // q rows per block
constexpr int kBK = 32;                 // kv rows per tile
constexpr int kRows = kBQ / kTY;        // 8 q rows per thread
constexpr int kSCols = kBK / kTX;       // 2 score columns per thread
constexpr int kLdP = kBK + 4;           // padded row stride of the p tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, h, kvh, s, t, dk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  int causal, q_offset;
};

// Row sums and maxima over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory: Qs [kBQ][dk + 4], Ks [kBK][dk + 4], Vs [kBK][DV],
// Ps [kBQ][kLdP], all f32.
__host__ __device__ constexpr size_t smem_floats(int dk, int dv) {
  return static_cast<size_t>(kBQ) * (dk + 4) + static_cast<size_t>(kBK) * (dk + 4) +
         static_cast<size_t>(kBK) * dv + static_cast<size_t>(kBQ) * kLdP;
}

// Each thread owns output columns tx * VEC + kTX * VEC * u + e.
template <int DV>
struct VCols {
  static constexpr int kPer = DV / kTX;                       // columns per thread
  static constexpr int kVec = kPer % 4 == 0 ? 4 : (kPer % 2 == 0 ? 2 : 1);
  static constexpr int kGroups = kPer / kVec;
};

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  using C = VCols<DV>;
  extern __shared__ __align__(16) float smem[];
  const int dk = a.dk;
  const int ldq = dk + 4;
  float* qs = smem;
  float* ks = qs + kBQ * ldq;
  float* vs = ks + kBK * ldq;
  float* ps = vs + kBK * DV;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  // heaviest causal q tiles first
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / (a.h / a.kvh);
  const int q0 = q_tile * kBQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kv_head * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kv_head * a.v_sh;

  for (int idx = tid; idx < kBQ * dk; idx += kThreads) {
    const int r = idx / dk, d = idx % dk;
    qs[r * ldq + d] = q0 + r < a.s ? to_f32(q[(q0 + r) * a.q_ss + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][C::kPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) acc[i][c] = 0.f;
  }

  // kv columns this tile's real rows can see
  int kv_end = a.t;
  if (a.causal) {
    const int last_row = a.q_offset + min(q0 + kBQ, a.s) - 1;
    kv_end = min(kv_end, last_row + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // every thread is done with the previous K/V tile
    for (int idx = tid; idx < kBK * dk; idx += kThreads) {
      const int r = idx / dk, d = idx % dk;
      ks[r * ldq + d] = k0 + r < a.t ? to_f32(k[(k0 + r) * a.k_ss + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int r = idx / DV, d = idx % DV;
      vs[r * DV + d] = k0 + r < a.t ? to_f32(v[(k0 + r) * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // s = q k^T for rows ty + kTY i, columns tx + kTX jj
    float s[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kSCols; ++jj) s[i][jj] = 0.f;
    for (int d = 0; d < dk; d += 4) {
      float4 qv[kRows], kv[kSCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + kTY * i) * ldq + d);
#pragma unroll
      for (int jj = 0; jj < kSCols; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(ks + (tx + kTX * jj) * ldq + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kSCols; ++jj) {
          float acc_s = s[i][jj];
          acc_s = fmaf(qv[i].x, kv[jj].x, acc_s);
          acc_s = fmaf(qv[i].y, kv[jj].y, acc_s);
          acc_s = fmaf(qv[i].z, kv[jj].z, acc_s);
          acc_s = fmaf(qv[i].w, kv[jj].w, acc_s);
          s[i][jj] = acc_s;
        }
    }

    // scale, mask, online softmax; p goes to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kTY * i;
      const int qi = a.q_offset + q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kSCols; ++jj) {
        const int kj = k0 + tx + kTX * jj;
        const bool visible = kj < a.t && (!a.causal || qi >= kj);
        s[i][jj] = visible ? s[i][jj] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSCols; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        ps[row * kLdP + tx + kTX * jj] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::kPer; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's p is written and read by the same half warp

    // acc += p @ v
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + kTY * i) * kLdP + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (c0 + e) * DV + tx * C::kVec;
        float vv[C::kPer];
#pragma unroll
        for (int u = 0; u < C::kGroups; ++u) {
          const float* src = vrow + kTX * C::kVec * u;
          if constexpr (C::kVec == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(src);
            vv[4 * u] = t4.x, vv[4 * u + 1] = t4.y, vv[4 * u + 2] = t4.z,
                   vv[4 * u + 3] = t4.w;
          } else if constexpr (C::kVec == 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(src);
            vv[2 * u] = t2.x, vv[2 * u + 1] = t2.y;
          } else {
            vv[u] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < C::kPer; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.h + h) * a.s * DV;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= a.s) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int u = 0; u < C::kGroups; ++u)
#pragma unroll
      for (int w = 0; w < C::kVec; ++w) {
        const int col = tx * C::kVec + kTX * C::kVec * u + w;
        store_as(o + static_cast<long long>(row) * DV + col,
                 acc[i][u * C::kVec + w] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync.m16n8k16 (bf16 x bf16 -> f32).
//
// The same algorithm and the same per-element arithmetic as flash_kernel,
// with both products on the tensor cores.  Four warps, each owning 16 of
// the block's 64 q rows; kv tiles of 64 rows.  q . k: q's fragments stay in
// registers for the whole kv loop, k is read from shared memory as the
// "col" operand (a (kv row, d) row-major tile is exactly that).  p @ v: the
// score accumulators are the A fragments of the next product, so p never
// leaves registers; v is staged transposed (dv, kv) so its fragments are
// 32-bit reads too.  The TPU kernel multiplies p in f32, and an mma takes
// bf16, so p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and
// both are multiplied (two mma per fragment): p_hi + p_lo holds p to about
// 16 bits, where one bf16 rounding would keep 8.  Rows of each 16-row
// fragment are groupID and groupID + 8 (groupID = lane / 4), columns are
// 2 * (lane % 4) + {0, 1}; the row statistics m and l of a thread's two
// rows reduce over the 4 lanes that share them.
constexpr int kMmaBK = 64;            // kv rows per tile
constexpr int kMmaPad = 8;            // bf16 padding per shared row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [row0, row0 + 64) of a (rows, D) bf16 matrix with row stride
// ``ss`` into dst[64][D + kMmaPad] (zeros past ``rows``), 16 bytes at a
// time when the source allows it.  Transposed: dst[D][64 + kMmaPad].
template <int D, bool kTransposed>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int row0, int rows,
                                           bool vec) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kMmaBK * kChunks; idx += kThreads) {
    // neighbouring threads take neighbouring 16-byte chunks of a row, or,
    // for the transposed copy, neighbouring rows (conflict-free stores)
    const int r = kTransposed ? idx % kMmaBK : idx / kChunks;
    const int c = (kTransposed ? idx / kMmaBK : idx % kChunks) * 8;
    __nv_bfloat16 v8[8];
    if (row0 + r < rows) {
      const __nv_bfloat16* p = src + (row0 + r) * ss + c;
      if (vec) {
        *reinterpret_cast<uint4*>(v8) = *reinterpret_cast<const uint4*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v8[e] = p[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v8[e] = __float2bfloat16_rn(0.f);
    }
    if constexpr (kTransposed) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(c + e) * (kMmaBK + kMmaPad) + r] = v8[e];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (D + kMmaPad) + c) =
          *reinterpret_cast<const uint4*>(v8);
    }
  }
}

__host__ __device__ constexpr size_t mma_smem_bytes(int dk, int dv) {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kBQ) * (dk + kMmaPad) +
          static_cast<size_t>(kMmaBK) * (dk + kMmaPad) +
          static_cast<size_t>(dv) * (kMmaBK + kMmaPad));
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(Args a) {
  constexpr int kKSteps = DK / 16, kNT = kMmaBK / 8, kDT = DV / 8;
  extern __shared__ __align__(16) __nv_bfloat16 sh[];
  __nv_bfloat16* qs = sh;                                // [kBQ][DK + pad]
  __nv_bfloat16* ks = qs + kBQ * (DK + kMmaPad);         // [kMmaBK][DK + pad]
  __nv_bfloat16* vt = ks + kMmaBK * (DK + kMmaPad);      // [DV][kMmaBK + pad]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int q_tile = gridDim.x - 1 - blockIdx.x;         // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / (a.h / a.kvh);
  const int q0 = q_tile * kBQ;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const auto* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kv_head * a.k_sh;
  const auto* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kv_head * a.v_sh;
  auto aligned = [](const void* p, long long ss) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ss % 8 == 0;
  };
  const bool q_vec = aligned(q, a.q_ss) && a.q_sb % 8 == 0 && a.q_sh % 8 == 0;
  const bool k_vec = aligned(k, a.k_ss) && a.k_sb % 8 == 0 && a.k_sh % 8 == 0;
  const bool v_vec = aligned(v, a.v_ss) && a.v_sb % 8 == 0 && a.v_sh % 8 == 0;

  stage_tile<DK, false>(qs, q, a.q_ss, q0, a.s, q_vec);
  __syncthreads();
  uint32_t qa[kKSteps][4];
  const __nv_bfloat16* qrow = qs + (warp * 16 + g) * (DK + kMmaPad) + 2 * tig;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    qa[kk][0] = ld32(qrow + kk * 16);
    qa[kk][1] = ld32(qrow + 8 * (DK + kMmaPad) + kk * 16);
    qa[kk][2] = ld32(qrow + kk * 16 + 8);
    qa[kk][3] = ld32(qrow + 8 * (DK + kMmaPad) + kk * 16 + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int kv_end = a.t;
  if (a.causal) kv_end = min(kv_end, a.q_offset + min(q0 + kBQ, a.s));
  const int n_tiles = kv_end > 0 ? (kv_end + kMmaBK - 1) / kMmaBK : 0;
  // absolute q positions of this thread's two rows
  const int qi0 = a.q_offset + q0 + warp * 16 + g, qi1 = qi0 + 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kMmaBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<DK, false>(ks, k, a.k_ss, k0, a.t, k_vec);
    stage_tile<DV, true>(vt, v, a.v_ss, k0, a.t, v_vec);
    __syncthreads();

    // s = q k^T: 16 rows x 64 columns per warp, in 8 column tiles
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * (DK + kMmaPad) + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma_bf16(s[nt], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // scale, mask, online softmax (row g: elements 0, 1; row g + 8: 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * tig + (e & 1);
        const int qi = e < 2 ? qi0 : qi1;
        const bool visible = kj < a.t && (!a.causal || qi >= kj);
        s[nt][e] = visible ? s[nt][e] * a.scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e / 2]);
        rs[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= alpha[0], acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1], acc[dt][3] *= alpha[1];
    }

    // acc += p @ v, p = p_hi + p_lo, in 4 steps of 16 kv rows
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // r: (row g, k lo), (row g + 8, k lo), (row g, k hi), (row g + 8, k hi)
        const float* sv = s[2 * kk + r / 2] + 2 * (r % 2);
        hi[r] = pack_bf16(sv[0], sv[1]);
        const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi[r]);
        lo[r] = pack_bf16(sv[0] - __low2float(h2), sv[1] - __high2float(h2));
      }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const __nv_bfloat16* vrow = vt + (dt * 8 + g) * (kMmaBK + kMmaPad) +
                                    kk * 16 + 2 * tig;
        const uint32_t b0 = ld32(vrow), b1 = ld32(vrow + 8);
        mma_bf16(acc[dt], hi, b0, b1);
        mma_bf16(acc[dt], lo, b0, b1);
      }
    }
  }

  auto* o = static_cast<__nv_bfloat16*>(a.o) + (static_cast<long long>(b) * a.h + h) * a.s * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.s) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(row) * DV + col) =
          __floats2bfloat162_rn(acc[dt][2 * r] / denom, acc[dt][2 * r + 1] / denom);
    }
  }
}

template <int DK, int DV>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(DK, DV);
  auto kernel = flash_mma_kernel<DK, DV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return REPRO_LAUNCH_STATUS();
}

template <typename T, int DV>
int launch_dv(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.dk, DV) * sizeof(float);
  auto kernel = flash_kernel<T, DV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    // the whole carveout to shared memory, so two blocks fit on an SM
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// The rows i < min(S, -q_offset) of a causal call: see the note at the top.
// One block per (row, head, batch); threads across the Dv columns.
template <typename T>
__global__ void __launch_bounds__(kThreads) no_key_rows_kernel(Args a, int dv,
                                                               int bq, int bk) {
  const int i = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int hi = a.q_offset + (i / bq + 1) * bq - 1;   // last row of i's q block
  const int nk = (a.t + bk - 1) / bk;
  const int jmax = hi < 0 ? -1 : min(nk - 1, hi / bk);
  const int cols = (jmax + 1) * bk;                    // columns visited, padding included
  const int n = min(a.t, cols);                        // real rows of v among them
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + (hh / (a.h / a.kvh)) * a.v_sh;
  T* o = static_cast<T*>(a.o) + ((static_cast<long long>(b) * a.h + hh) * a.s + i) * dv;
  for (int c = threadIdx.x; c < dv; c += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < n; ++j) sum += to_f32(v[j * a.v_ss + c]);
    store_as(o + c, cols > 0 ? sum / static_cast<float>(cols) : 0.f);
  }
}

template <typename T>
int launch_no_key_rows(const Args& a, int dv, int bq, int bk, cudaStream_t stream) {
  const int rows = a.s < -a.q_offset ? a.s : -a.q_offset;
  if (rows <= 0 || bq <= 0 || bk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  no_key_rows_kernel<T><<<dim3(rows, a.h, a.b), kThreads, 0, stream>>>(a, dv, bq, bk);
  return REPRO_LAUNCH_STATUS();
}

template <typename T>
int launch_main(const Args& a, int dk, int dv, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // the head dims the tensor-core kernel is compiled for
    if (dk == 128 && dv == 128) return launch_mma<128, 128>(a, st);
    if (dk == 96 && dv == 96) return launch_mma<96, 96>(a, st);
    if (dk == 64 && dv == 64) return launch_mma<64, 64>(a, st);
    if (dk == 32 && dv == 32) return launch_mma<32, 32>(a, st);
    if (dk == 96 && dv == 64) return launch_mma<96, 64>(a, st);
  }
  switch (dv) {
    case 32: return launch_dv<T, 32>(a, st);
    case 64: return launch_dv<T, 64>(a, st);
    case 96: return launch_dv<T, 96>(a, st);
    case 128: return launch_dv<T, 128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Head dims this file takes: Dk any multiple of 4 from 4 to 256 (a loop
// bound), Dv in {32, 64, 96, 128} (the size of each thread's output strip;
// repro_torch/kernels/flash_attention/flash_attention.py lists the same).
template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int b,
                 int h, int kvh, int s, int t, int dk, int dv,
                 const long long* strides, float scale, int causal,
                 int q_offset, int bq, int bk, int device, void* stream_ptr) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0 || s <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || dk <= 0 || dk % 4 != 0 || dk > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, b, h, kvh, s, t, dk,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8],
         scale, causal, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int err = launch_main<T>(a, dk, dv, st);
  if (err != 0 || !causal || q_offset >= 0) return err;
  return launch_no_key_rows<T>(a, dv, bq, bk, st);
}

}  // namespace

// strides: 9 element strides, (batch, head, sequence) of q, then k, then v.
// bq, bk: the plain version's blocks (min(512, S), min(512, T) by default),
// which decide what a row that sees no key gets.
REPRO_API int repro_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, int b, int h,
                                        int kvh, int s, int t, int dk, int dv,
                                        const long long* strides, float scale,
                                        int causal, int q_offset, int bq,
                                        int bk, int device, void* stream) {
  return launch_flash<float>(q, k, v, o, b, h, kvh, s, t, dk, dv, strides,
                             scale, causal, q_offset, bq, bk, device, stream);
}

REPRO_API int repro_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, int b, int h,
                                         int kvh, int s, int t, int dk, int dv,
                                         const long long* strides, float scale,
                                         int causal, int q_offset, int bq,
                                         int bk, int device, void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, o, b, h, kvh, s, t, dk, dv,
                                     strides, scale, causal, q_offset, bq, bk,
                                     device, stream);
}

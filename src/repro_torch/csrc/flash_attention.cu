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
// * flash_wgmma_kernel, for bfloat16 at (Dk, Dv) in {(32, 32), (64, 64),
//   (80, 80), (96, 96), (128, 128), (96, 64), (192, 128), (256, 256)}: a producer
//   warp brings Q once and K and V tiles through a shared-memory ring with
//   TMA, and two consumer warpgroups run both products on wgmma (bf16
//   inputs, f32 accumulation),
//   p kept to about 16 bits as the sum of two bf16 parts (see the note
//   above the kernel);
// * flash_kernel, for float32 (which must match a full-precision product,
//   so no TF32 tensor cores) and every other head-dim pair: f32 FMAs on the
//   CUDA cores.  128 threads hold an 8 x 2 strip of the (64, 32) score tile
//   and an 8 x (Dv / 16) strip of the output, reading q and p rows as
//   float4 broadcasts and k and v rows as contiguous float4/float2 runs (or
//   one float at a time at Dv 80: hubert's heads in float32).  At Dv 256 (paligemma's
//   heads, here in float32 only) a thread's strip is 128 f32 accumulators
//   (ptxas: 255 registers a thread, no spills), and the block's shared
//   memory at Dk 256 is 141,824 bytes: one block an SM.
//
// What bounds it on the H100: for qwen2.5-3b's prefill (16 heads over 2 kv
// heads of 128, S = T = 256, bf16, batch 4) the work is 0.54 G causal
// multiply-adds against 9.4 MB of inputs and outputs: 2.8 us at 3.35 TB/s
// against 1.1 us at the bf16 tensor-core peak, so bytes bound it there; at
// S = T = 4096 operations do (69 us at the peak for the two products).
// The bf16 kernel does three products per tile, not two (p_hi V and p_lo
// V), so its own floor at 4096 is 104 us.  Loads that threads issue
// between barriers, v staged transposed by hand and mma.sync leave the
// tensor cores idle most of the time; so the wgmma kernel feeds them from
// swizzled shared memory that no thread writes, its producer runs ahead of
// the products by up to three tiles, and the two warpgroups of a block
// share the tensor cores, one doing its softmax while the other
// multiplies.
#include "common.cuh"
#include "hopper.cuh"

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
  float* lse;   // (B, H, S) row log-sum-exp for the backward, or null
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.h + h) * a.s + row] = m[i] + logf(l[i]);
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
// bfloat16 on the tensor cores: flash_wgmma_kernel, TMA + wgmma.
//
// One block per (128 q rows, head, batch), 384 threads: two consumer
// warpgroups, each owning 64 of the block's q rows, and a producer
// warpgroup whose first warp's lane 0 issues every copy.  At Dv 256
// (paligemma's heads) a warpgroup's 64 x 256 f32 accumulators alone take
// 128 registers a thread, and beside the scores and P's two parts the
// consumers' code spilled (ptxas: 260 bytes of spill stores, whatever the
// setmaxnreg split); so there the block owns 64 q rows, and both consumer
// warpgroups take all of them, each computing S and P for them and
// accumulating its own half of Dv's columns (wg_split_dv): the same
// registers as (128, 128), at one more Q K^T a tile.  The producer
// warpgroup drops to 24 registers a thread (setmaxnreg.dec) and the
// consumers raise theirs to 240 (setmaxnreg.inc): the exchange works on
// whole warpgroups, and a lone producer warp would free registers in one
// SM sub-partition only.  ptxas allocates 168 registers a thread for the
// whole kernel (the limit for 12 warps) and the consumers' code fits in
// them without spills; overlapping the next tile's Q K^T with this tile's
// softmax (two score tiles live) does not fit, and spilling costs more
// than the overlap gains.
// The producer loads the q tile once and streams (64, Dk) tiles of K and
// (64, Dv) tiles of V through a 3-stage ring with TMA
// (cp.async.bulk.tensor, 4-d tensor maps built on the host per call), each
// stage with a full and an empty mbarrier.  Everything lands in
// 128-byte-swizzled boxes of 64 bf16 columns (a 128-wide head is two
// boxes; 96 is two, the second half zero-filled by TMA; hubert's 80 two,
// all but 16 columns of the second zero-filled, Q K^T in 5 k-steps; 32
// one, half zero; MLA's Dk of 192 three, 12 k-steps of 16), rows past S
// and T zero-filled by TMA too.  At (192, 128) the block holds 3 Q boxes of 128
// rows (48 KB) and 3 stages of 3 K and 2 V boxes (120 KB): 173,112 bytes
// with the barriers and the alignment slack, one block an SM, the same
// registers as (128, 128) (the scores and Dv's accumulators do not grow
// with Dk).  At (256, 256) it holds 4 Q boxes of 64 rows (32 KB) and 3
// stages of 4 K and 4 V boxes (192 KB): 230,456 bytes.  Per kv tile, each
// consumer warpgroup:
//
// * S = Q K^T: wgmma.m64n64k16, A = its 64 q rows and B = the K tile as it
//   lies (both K-major), Dk / 16 steps, f32 accumulators in registers;
// * the online softmax on wgmma's accumulator layout (thread (warp w, lane
//   l) holds rows 16w + l/4 and + 8, columns 8j + 2(l%4) + {0, 1}), with
//   flash_kernel's per-element arithmetic: scale, columns >= T and causal
//   columns to the -1e30 sentinel, m, alpha, p, l, row reductions over the
//   4 lanes of a quad;
// * acc += P V: wgmma.m64nNk16 (N = Dv, or Dv / 2 at Dv 256, B starting
//   at the warpgroup's half of the V boxes; at Dv 80 N = 96, mma_n: V's
//   columns 80-95 are TMA's zeros, the last 16 accumulators stay 0 and are
//   not stored, and no wgmma reads a box at a width that is not a multiple
//   of 32) with A = P from registers (the
//   score accumulators of two n8 tiles are exactly one k16 A fragment) and
//   B = the V tile with the transpose bit (MN-major), so V is never staged
//   transposed.  P is p_hi + p_lo, two bf16 parts multiplied in turn: p
//   to about 16 bits, where
//   one bf16 rounding keeps 8, so the result holds to the f32-p plain
//   version within the check's bf16 tolerance.
//
// Descriptors: K-major operands (Q, K) use SBO = 1024 bytes (8 rows of 128
// bytes) and step 32 bytes per k16 inside a box, a box further per 4
// steps; the MN-major V uses SBO = 1024 bytes (8 kv rows) and LBO = one
// box (64 rows x 128 bytes) between its 64-column halves, and steps 16 kv
// rows (2048 bytes) per k16.  Every box starts 1024-byte aligned, so the
// swizzle phase (base offset) is 0.  Kv tiles wholly above the diagonal
// are not loaded; a warpgroup whose rows all lie above a loaded tile skips
// its products for it.  Rows >= S are never stored.
constexpr int kWgRows = 64;                 // q rows per consumer warpgroup
constexpr int kWgBK = 64;                   // kv rows per tile
constexpr int kWgStages = 3;
constexpr int kWgConsumers = 2 * 128;
constexpr int kWgThreads = kWgConsumers + 128;   // and a producer warpgroup
constexpr int kMaxSmem = 232448;            // shared memory a block can have

// Whether the two consumer warpgroups split Dv's columns over the same 64
// q rows (Dv 256), instead of each owning 64 rows with all of Dv.
template <int DK, int DV>
__host__ __device__ constexpr bool wg_split_dv() { return DV > 192; }

// q rows per block
template <int DK, int DV>
__host__ __device__ constexpr int wg_block_rows() {
  return wg_split_dv<DK, DV>() ? kWgRows : 2 * kWgRows;
}

template <int DK, int DV>
__host__ __device__ constexpr int wg_smem_bytes() {
  return ((DK + kBox - 1) / kBox) * wg_block_rows<DK, DV>() * 128 +
         kWgStages * (((DK + kBox - 1) / kBox) + ((DV + kBox - 1) / kBox)) * kWgBK * 128 +
         (1 + 2 * kWgStages) * 8 + 1024;   // barriers, and slack to align to 1024
}

template <int DK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Args a, Perm perm) {
  constexpr int NQ = (DK + kBox - 1) / kBox, NV = (DV + kBox - 1) / kBox;
  constexpr int KSTEPS = DK / 16;
  constexpr bool SPLIT = wg_split_dv<DK, DV>();
  constexpr int BQ = wg_block_rows<DK, DV>();
  constexpr int DVW = SPLIT ? DV / 2 : DV;                 // Dv columns a warpgroup owns
  constexpr int DVN = mma_n<DVW>();                        // and the width of its P V
  constexpr int BOXQ = BQ * 128, BOXKV = kWgBK * 128;      // bytes of one box
  constexpr int K_BYTES = NQ * BOXKV, STAGE = K_BYTES + NV * BOXKV;
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DVN <= 192 &&
                    (SPLIT ? DVW % kBox == 0 : DVN <= NV * kBox),
                "head dims");
  static_assert(wg_smem_bytes<DK, DV>() <= kMaxSmem, "shared memory of a block");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qs + NQ * BOXQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kWgStages * STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWgStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_tile = gridDim.x - 1 - blockIdx.x;           // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / (a.h / a.kvh);
  const int q0 = q_tile * BQ;
  int kv_end = a.t;
  if (a.causal) kv_end = min(kv_end, a.q_offset + min(q0 + BQ, a.s));
  const int n_tiles = kv_end > 0 ? (kv_end + kWgBK - 1) / kWgBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kWgConsumers / 32 && lane == 0) {
      mbar_arrive_tx(q_full, NQ * BOXQ);
#pragma unroll
      for (int x = 0; x < NQ; ++x)
        tma_load(qs + x * BOXQ, &tq, perm.q, x * kBox, q0, h, b, q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kWgStages;
        mbar_wait(&empty[s], ((j / kWgStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], STAGE);
        unsigned char* st = ring + s * STAGE;
#pragma unroll
        for (int x = 0; x < NQ; ++x)
          tma_load(st + x * BOXKV, &tk, perm.k, x * kBox, j * kWgBK, kv_head, b, &full[s]);
#pragma unroll
        for (int x = 0; x < NV; ++x)
          tma_load(st + K_BYTES + x * BOXKV, &tv, perm.v, x * kBox, j * kWgBK, kv_head, b,
                   &full[s]);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + (SPLIT ? 0 : wg * kWgRows);       // the warpgroup's first row
  const int col0 = SPLIT ? wg * DVW : 0;                   // and its first Dv column
  const bool live = row0 < a.s;
  const int last = a.q_offset + min(row0 + kWgRows, a.s) - 1;   // its last position
  const int qi0 = a.q_offset + row0 + wq * 16 + g, qi1 = qi0 + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DVN / 2];                                        // columns >= DVW stay 0
#pragma unroll
  for (int i = 0; i < DVN / 2; ++i) o[i] = 0.f;
  // the tiles this warpgroup multiplies: all, or (causal) those that start
  // at or before its last row; the rest it only hands back
  const int n_wg = !live ? 0
                   : !a.causal ? n_tiles
                   : last < 0 ? 0 : min(n_tiles, last / kWgBK + 1);
  const unsigned char* qw = qs + (row0 - q0) * 128;       // this warpgroup's rows

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kWgStages;
    mbar_wait(&full[s], (j / kWgStages) & 1);
    if (j < n_wg) {
      const unsigned char* st = ring + s * STAGE;
      const int k0 = j * kWgBK;
      float sc[kWgBK / 2];
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int off = (kk % 4) * 32;              // bytes: 16 columns a step
        wgmma_ss_n64(sc, sw128_desc(qw + (kk / 4) * BOXQ + off, 16, 1024),
                        sw128_desc(st + (kk / 4) * BOXKV + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale, mask, online softmax (row qi0: elements 0, 1 of each n8
      // tile; row qi1: 2, 3)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kWgBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qi = e < 2 ? qi0 : qi1;
          const bool visible = kj < a.t && (!a.causal || qi >= kj);
          float& x = sc[4 * nt + e];
          x = visible ? x * a.scale : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        sc[i] = expf(sc[i] - m[(i % 4) / 2]);
        rs[(i % 4) / 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
      for (int nt = 0; nt < DVW / 8; ++nt) {
        o[4 * nt] *= alpha[0], o[4 * nt + 1] *= alpha[0];
        o[4 * nt + 2] *= alpha[1], o[4 * nt + 3] *= alpha[1];
      }

      // acc += p @ v, p = p_hi + p_lo, in steps of 16 kv rows
      uint32_t hi[kWgBK / 16][4], lo[kWgBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // r: (row g, k lo), (row g + 8, k lo), (row g, k hi), (row g + 8, k hi)
          const float* sv = sc + 4 * (2 * kk + r / 2) + 2 * (r % 2);
          hi[kk][r] = pack_bf16(sv[0], sv[1]);
          const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
          lo[kk][r] = pack_bf16(sv[0] - __low2float(h2), sv[1] - __high2float(h2));
        }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t dv =
            sw128_desc(st + K_BYTES + (col0 / kBox) * BOXKV + kk * 16 * 128, BOXKV, 1024);
        wgmma_rs<DVN>(o, hi[kk], dv);
        wgmma_rs<DVN>(o, lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);         // this warp is done with stage s
  }

  if (!live) return;
  auto* out = static_cast<__nv_bfloat16*>(a.o) + (static_cast<long long>(b) * a.h + h) * a.s * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wq * 16 + g + 8 * r;
    if (row >= a.s) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    if (a.lse != nullptr && t4 == 0 && col0 == 0)
      a.lse[(static_cast<long long>(b) * a.h + h) * a.s + row] = m[r] + logf(l[r]);
#pragma unroll
    for (int nt = 0; nt < DVW / 8; ++nt) {
      const int col = col0 + nt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * DV + col) =
          __floats2bfloat162_rn(o[4 * nt + 2 * r] / denom, o[4 * nt + 2 * r + 1] / denom);
    }
  }
}

template <int DK, int DV>
int launch_wgmma(const Args& a, int dv, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  Perm perm;
  constexpr int BQ = wg_block_rows<DK, DV>();
  const bool ok =
      encode_map(&tq, a.q, DK, {a.s, a.h, a.b}, {a.q_ss, a.q_sh, a.q_sb}, BQ, perm.q) &&
      encode_map(&tk, a.k, DK, {a.t, a.kvh, a.b}, {a.k_ss, a.k_sh, a.k_sb}, kWgBK, perm.k) &&
      encode_map(&tv, a.v, dv, {a.t, a.kvh, a.b}, {a.v_ss, a.v_sh, a.v_sb}, kWgBK, perm.v);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = wg_smem_bytes<DK, DV>();
  auto kernel = flash_wgmma_kernel<DK, DV>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.s + BQ - 1) / BQ, a.h, a.b);
  kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, a, perm);
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
    if (dk == 128 && dv == 128) return launch_wgmma<128, 128>(a, dv, st);
    if (dk == 96 && dv == 96) return launch_wgmma<96, 96>(a, dv, st);
    if (dk == 80 && dv == 80) return launch_wgmma<80, 80>(a, dv, st);      // hubert
    if (dk == 64 && dv == 64) return launch_wgmma<64, 64>(a, dv, st);
    if (dk == 32 && dv == 32) return launch_wgmma<32, 32>(a, dv, st);
    if (dk == 96 && dv == 64) return launch_wgmma<96, 64>(a, dv, st);
    if (dk == 192 && dv == 128) return launch_wgmma<192, 128>(a, dv, st);   // MLA
    if (dk == 256 && dv == 256) return launch_wgmma<256, 256>(a, dv, st);   // paligemma
  }
  switch (dv) {
    case 32: return launch_dv<T, 32>(a, st);
    case 64: return launch_dv<T, 64>(a, st);
    case 80: return launch_dv<T, 80>(a, st);
    case 96: return launch_dv<T, 96>(a, st);
    case 128: return launch_dv<T, 128>(a, st);
    case 256: return launch_dv<T, 256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Head dims this file takes: Dk any multiple of 4 from 4 to 256 (a loop
// bound), Dv in {32, 64, 80, 96, 128, 256} (the size of each thread's
// output strip;
// repro_torch/kernels/flash_attention/flash_attention.py lists the same).
template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                 int h, int kvh, int s, int t, int dk, int dv,
                 const long long* strides, float scale, int causal,
                 int q_offset, int bq, int bk, int device, void* stream_ptr) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0 || s <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || dk <= 0 || dk % 4 != 0 || dk > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, lse, b, h, kvh, s, t, dk,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8],
         scale, causal, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int err = launch_main<T>(a, dk, dv, st);
  if (err != 0 || !causal || q_offset >= 0) return err;
  return launch_no_key_rows<T>(a, dv, bq, bk, st);
}

}  // namespace

// lse: null, or (B, H, S) f32 that receives each row's log-sum-exp m + ln l
// in natural-log units (the kernels' exponent is expf), for the backward
// (csrc/flash_attention_bwd.cu); the output's bits do not depend on it.
// strides: 9 element strides, (batch, head, sequence) of q, then k, then v.
// bq, bk: the plain version's blocks (min(512, S), min(512, T) by default),
// which decide what a row that sees no key gets.
REPRO_API int repro_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int b, int h, int kvh, int s, int t, int dk, int dv,
                                        const long long* strides, float scale,
                                        int causal, int q_offset, int bq,
                                        int bk, int device, void* stream) {
  return launch_flash<float>(q, k, v, o, lse, b, h, kvh, s, t, dk, dv, strides,
                             scale, causal, q_offset, bq, bk, device, stream);
}

REPRO_API int repro_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int b, int h, int kvh, int s, int t, int dk, int dv,
                                         const long long* strides, float scale,
                                         int causal, int q_offset, int bq,
                                         int bk, int device, void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, o, lse, b, h, kvh, s, t, dk, dv,
                                     strides, scale, causal, q_offset, bq, bk,
                                     device, stream);
}

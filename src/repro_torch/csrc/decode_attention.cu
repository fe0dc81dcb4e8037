// Decode attention (flash-decoding): one query per sequence against the KV
// cache, q (B, H, Dk) x k (B, KVH, T, Dk) x v (B, KVH, T, Dv) -> out
// (B, H, Dv) in q's dtype, with the softmax's max m and sum l (B, H, 1) in
// f32; with partial = 1, out is the unnormalised f32 acc, so that
// combine_partials over T-shards gives the full result.  Grouped-query heads
// (KVH divides H) read their kv head in place.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py:_decode_kernel
// (launched by decode_attention_pallas), which walks a (B, KVH, T / bk)
// grid with the cache axis innermost and sequential, carrying the group's
// online-softmax state (acc, m, l) across grid steps in VMEM.
//
// What bounds it on the H100: bytes.  The cache is read once and every key
// costs 2 (Dk + Dv) flops per head: at qwen2.5-3b's decode shape (B = 4,
// H = 16 over KVH = 2, T = 512, Dk = Dv = 128, bf16) 2.1 MB, 0.63 us at
// 3.35 TB/s; at T = 32768 134 MB, 40 us, against 1.07 GFLOP, 16 us at the
// f32 peak of the CUDA cores.  So the products stay f32 on the CUDA cores
// (the tensor cores would need bf16 inputs and would not shorten a
// bytes-bound kernel), and the design is about keeping enough loads in
// flight on every SM.  One block per (b, kv head) would run 8 blocks on
// 132 SMs at qwen's shape, each walking all of T alone; so T is split.
//
// Two kernels:
//
// * decode_split_kernel, grid (n_splits, KVH, B): each block takes its own
//   chunk of keys_per_split keys (the plan, plan_decode_splits in
//   repro_torch/kernels/decode_attention/decode_attention.py, aims one
//   sequence's n_splits * KVH blocks at about twice the SM count where T
//   allows, whatever B, with a floor of keys per split so that the
//   partials' write stays small against the cache read).  A producer warp streams the chunk in tiles of 32 keys
//   into a ring of 4 shared-memory stages (3 for f32 rows of 256) with TMA
//   bulk copies (cp.async.bulk, one per row, or one per tile where the
//   rows are contiguous), each stage with a full and an empty mbarrier, so
//   up to 4 tiles are in flight whatever the consumers are doing; the
//   copies cost it no registers and no address arithmetic per 16 bytes
//   (16-byte cp.async copies from every thread between __syncthreads do
//   not keep the cache streaming, whatever the number of stages).
//   8 consumer warps take each tile: warp w keys 4w .. 4w + 3 for every
//   head of the pass, each half warp two of them.  Scores: each lane holds
//   q for the pass's heads at its 1/16 of the head dim in registers and
//   multiplies its slice of each key's row, so a row is read from shared
//   memory once and q never; one butterfly reduce-scatter per half warp
//   (15 shuffles for 8 heads x 2 keys) sums the lanes' parts into (head,
//   key) scores, each in the same tree order.  Each warp keeps its own
//   online softmax over its keys (p and alpha pass through a small
//   per-warp buffer in shared memory), so the consumer warps never wait for
//   each other inside the chunk (a block-wide softmax costs three barriers
//   and shared-memory round trips a tile); p @ v reads each v row once
//   per warp as lane-contiguous slices; the warps' (acc, m, l) merge in a
//   fixed order at the end.  Rows in the ring are 32 slices wide, zero
//   past the head dim.  A view whose rows are not 16-byte aligned is
//   copied into the same ring by the producer warp with plain loads.
//   With n_splits == 1 the block writes the final result.
// * decode_combine_kernel, one block per (b, head), when n_splits > 1:
//   merges the splits' f32 (acc, m, l) in the fixed order 0, 1, ..., with
//   combine_partials' arithmetic (no fused multiply-adds), and writes the
//   merged unnormalised triple (partial) or acc / l in q's dtype.  It is a
//   programmatic dependent launch (griddepcontrol), so its launch overlaps
//   the split kernel's tail.
//
// With lengths (the model's decode step, models/attention.py:attend_decode)
// row b attends to keys [0, lengths[b]) only: a split wholly past it loads
// nothing and gives the no-key partial.  The step's weights are the JAX
// model's: p = exp(s - m) from the row's global max m, rounded to the cache
// dtype before p @ v, while l sums p unrounded (its einsum over
// pexp.astype(cache dtype)); so a third kernel, decode_max_kernel, writes
// each split's max score first, and the split kernel, launched as its
// programmatic dependent (its producer streams keys while the maxima are
// found), then runs with that fixed max (alpha = 1) and rounds each p it
// multiplies.  Without the
// rounding (p kept in f32, as the TPU kernel keeps it) the card's step
// parted from the CPU's by 2^-9 of a weight, enough to flip an MoE
// routing near-tie.
//
// The T-sharded step (a cache whose T is split over the model axis, the
// JAX model's GSPMD partial reductions) takes the same route in two passes
// over a shard's keys, with the row lengths local to the shard (0 where the
// shard holds none of a row's keys): repro_decode_max_* runs
// decode_max_kernel and decode_rowmax_kernel, which reduces the splits'
// maxima to each row's shard max (the sentinel where it has no key); the
// model all-reduces those to the global max; repro_decode_partial_* then
// runs the split kernel (and the combine kernel) with that global max
// given (gmax), and returns the f32 acc and l of the shard's keys (the
// weights rounded as above), which the model adds in shard order.
//
// Arithmetic per tile, as the TPU kernel orders it: s = (q . k) * scale in
// f32, m_new = max(m, max s), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + sum p, acc = acc * alpha + p @ v; out = acc / l with
// l == 0 read as 1.  Any T >= 1 works: keys past T get p = 0 and are never
// multiplied, so nothing is padded.  A group larger than the heads a pass
// holds (8, or 4 at Dk or Dv > 128 or for groups of up to 4) runs in several
// passes over the chunk.  Repeated runs give the same bits, and so does a
// row of a batched call and the same row called alone: the plan depends on
// KVH, T and the SM count only, and every sum has a fixed order.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;                // consumers; one more warp produces
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kCombineThreads = 128;
constexpr int kTile = 32;            // keys per ring stage: one per lane
constexpr int kKeysPerWarp = kTile / kWarps;   // p @ v: keys per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T zero_as() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_as<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;          // (B, H, Dv): q's dtype, or f32 when partial
  float* m_out;     // (B, H) or null
  float* l_out;     // (B, H) or null
  float* acc_s;     // (n_splits, B, H, Dv) f32 scratch when n_splits > 1
  float* m_s;       // (n_splits, B, H)
  float* l_s;       // (n_splits, B, H)
  const long long* lengths;   // (B,): keys [0, lengths[b]) of row b, or null (all T)
  float* mx_s;      // (n_splits, B, H) f32: each split's max score, or null;
                    // non-null: the model's weights (see decode_max_kernel)
  const float* gmax;  // (B, H) f32: each row's max given (the T-sharded
                      // step's partial pass: the model's weights), or null
  int b, h, kvh, t, dk, dv;
  long long q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  float scale;
  int partial, n_splits, kps;
  int out_f32;      // the normalised out in f32 (else q's dtype)
  int vec;          // every k and v row is 16-byte aligned, whole 16-byte chunks
};

// Keys of row b the call attends to: [0, lengths[b]) clamped to [0, T].
__device__ __forceinline__ int row_length(const Args& a, int b) {
  if (a.lengths == nullptr) return a.t;
  const long long n = a.lengths[b];
  return n < 0 ? 0 : n > a.t ? a.t : static_cast<int>(n);
}

// x rounded to T (the cache dtype) and back.
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The normalised output, in q's dtype or (out_f32) in f32.
template <typename T>
__device__ __forceinline__ void store_out(const Args& a, long long i, float x) {
  if (a.out_f32) static_cast<float*>(a.o)[i] = x;
  else store_as(static_cast<T*>(a.o) + i, x);
}

// Heads a pass holds: HB * DPL q values and HB * DPL accumulators per lane.
template <int DPL>
__host__ __device__ constexpr int max_heads_per_pass() { return DPL <= 4 ? 8 : 4; }

// Ring stages: 4, or 3 where a stage is 64 KB (f32 rows of 256).
template <typename T, int DPL>
__host__ __device__ constexpr int stages() { return sizeof(T) * DPL >= 32 ? 3 : 4; }

__host__ __device__ inline int chunks(int d, int es) { return (d * es + 15) / 16; }

// Shared memory, in bytes: the ring (kTile K rows, then kTile V rows per
// stage, each row 32 * DPL elements: the head dim, then zeros), the warps'
// acc for the merge [kWarps][HB][dv], and their m and l [kWarps][HB] each,
// then the full and empty barriers.
__host__ __device__ inline size_t smem_bytes(int stages, int hb, int dpl,
                                             int dv, int es) {
  const size_t ring = static_cast<size_t>(stages) * kTile * 2 * 32 * dpl * es;
  const size_t floats = static_cast<size_t>(kWarps) * hb * (dv + 2 + kKeysPerWarp + 1);
  return ring + (floats * sizeof(float) + 7) / 8 * 8 + 2 * stages * sizeof(uint64_t);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// One TMA bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// The consumer warps' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kWarps * 32) : "memory");
}

// The producer warp stages keys [key0, key0 + nrow) of one (b, kv head)
// into ring rows of ``rb`` bytes.  Aligned views: one TMA bulk copy per
// row (or one for the whole tile where rows are contiguous in both), all
// completing on ``full``, whose 32 arrivals come from the warp's lanes.
// Other views: plain loads and stores, then the lanes' arrivals (release).
// Rows past nrow keep what they held: their scores are masked and their p
// never used.
template <typename T>
__device__ __forceinline__ void produce(char* dk_dst, char* dv_dst, int rb,
                                        const T* kg, const T* vg, const Args& a,
                                        int key0, int nrow, uint64_t* full,
                                        int lane) {
  constexpr int E = 16 / sizeof(T);
  if (a.vec) {
    const unsigned kb = a.dk * sizeof(T), vb = a.dv * sizeof(T);
    const bool kc = a.k_st * sizeof(T) == rb && kb == static_cast<unsigned>(rb);
    const bool vc = a.v_st * sizeof(T) == rb && vb == static_cast<unsigned>(rb);
    if (lane == 0) mbar_arrive_tx(full, nrow * (kb + vb));
    __syncwarp();
    const T* k0 = kg + static_cast<long long>(key0) * a.k_st;
    const T* v0 = vg + static_cast<long long>(key0) * a.v_st;
    if (kc) {
      if (lane == 0) bulk_copy(dk_dst, k0, nrow * kb, full);
    } else if (lane < nrow) {
      bulk_copy(dk_dst + lane * rb, k0 + lane * a.k_st, kb, full);
    }
    if (vc) {
      if (lane == 0) bulk_copy(dv_dst, v0, nrow * vb, full);
    } else if (lane < nrow) {
      bulk_copy(dv_dst + lane * rb, v0 + lane * a.v_st, vb, full);
    }
    if (lane != 0) mbar_arrive(full);
    return;
  }
  for (int m = 0; m < 2; ++m) {
    const int d = m == 0 ? a.dk : a.dv;
    const T* src = m == 0 ? kg : vg;
    const long long st = m == 0 ? a.k_st : a.v_st;
    char* dst = m == 0 ? dk_dst : dv_dst;
    const int nc = (d + E - 1) / E;
    for (int idx = lane; idx < nrow * nc; idx += 32) {
      const int r = idx / nc, c = idx % nc;
      const T* row = src + static_cast<long long>(key0 + r) * st + c * E;
      alignas(16) T vals[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vals[e] = c * E + e < d ? row[e] : zero_as<T>();
      *reinterpret_cast<uint4*>(dst + r * rb + c * 16) =
          *reinterpret_cast<const uint4*>(vals);
    }
  }
  mbar_arrive(full);
}

// N consecutive elements of a ring row as f32, in loads of up to 16 bytes.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = __bfloat162float(p[0]);
  } else {
    constexpr int W = N / 2;                 // 32-bit words
    unsigned w[W];
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + 2 * i);
        w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
      }
    } else if constexpr (W == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Butterfly reduce-scatter over the warp: on entry each lane holds N
// partial sums (N a power of two, at most 32); on exit v[0] is the sum over
// all 32 lanes of entry N * lane / 32, each sum taken in the same tree
// order.  Half the values move at each step: 31 shuffles for N = 32.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

// DPL: head-dim elements per lane (Dk, Dv <= 32 * DPL); HB: heads per pass.
// Warps 0 .. kWarps - 1 consume, warp kWarps produces.
template <typename T, int DPL, int HB>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  constexpr int S = stages<T, DPL>();
  constexpr int QE = 2 * DPL;                        // row elements per lane: 16 lanes a row
  constexpr int NS = HB * kKeysPerWarp / 2;          // score parts per lane: 2 keys
  constexpr int R = 16 / NS;                         // lanes per (key, head) score
  constexpr int RB = 32 * DPL * sizeof(T);           // ring row bytes
  static_assert(NS <= 16 && (NS & (NS - 1)) == 0, "one reduce-scatter per tile");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr size_t kStageBytes = static_cast<size_t>(kTile) * 2 * RB;
  char* ring = reinterpret_cast<char*>(smem);
  float* macc = reinterpret_cast<float*>(smem + S * kStageBytes);   // [kWarps][HB][dv]
  float* wm = macc + kWarps * HB * a.dv;             // [kWarps][HB]: each warp's m
  float* wl = wm + kWarps * HB;                      // [kWarps][HB]: and l
  float* pbuf = wl + kWarps * HB;                    // [kWarps]: p [4][HB], alpha [HB]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uintptr_t>(pbuf + kWarps * (kKeysPerWarp + 1) * HB + 1) &
      ~uintptr_t(7));
  uint64_t* empty = full + S;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.h / a.kvh;
  const int key_begin = split * a.kps;
  const int key_end = min(row_length(a, b), key_begin + a.kps);
  // a split wholly past the row's length loads nothing: its partial is the
  // no-key one (m at the sentinel, l = 0, acc = 0)
  const int n_tiles = key_end > key_begin ? (key_end - key_begin + kTile - 1) / kTile : 0;
  const int n_pass = (group + HB - 1) / HB;
  // the combine kernel may launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // rows are read whole (32 * DPL elements): zero what no copy writes
  {
    const int kused = chunks(a.dk, sizeof(T)) * 16, vused = chunks(a.dv, sizeof(T)) * 16;
    const int kn = (RB - kused) / 16, vn = (RB - vused) / 16;
    for (int idx = tid; idx < S * kTile * (kn + vn); idx += kThreads) {
      const int row = idx / (kn + vn), c = idx % (kn + vn);
      const int s = row / kTile, r = row % kTile;
      char* p = c < kn ? ring + s * kStageBytes + r * RB + kused + c * 16
                       : ring + s * kStageBytes + (kTile + r) * RB + vused + (c - kn) * 16;
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);         // the producer warp's lanes
      mbar_init(&empty[s], kWarps);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: every pass streams the chunk again, through one ring
    const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    int g = 0;
    for (int pass = 0; pass < n_pass; ++pass) {
      for (int j = 0; j < n_tiles; ++j, ++g) {
        const int s = g % S;
        mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
        const int key0 = key_begin + j * kTile;
        char* st = ring + s * kStageBytes;
        produce<T>(st, st + kTile * RB, RB, kg, vg, a, key0,
                   min(kTile, key_end - key0), &full[s], lane);
      }
    }
    return;
  }

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  int g = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int h0 = pass * HB;
    const int nh = min(HB, group - h0);
    const int head0 = kvh * group + h0;              // first q head of the pass
    // q for the pass in registers: lane holds elements (lane % 16) * QE ..
    // + QE, the two half warps alike
    float qr[HB][QE];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int i = 0; i < QE; ++i) {
        const int d = (lane % 16) * QE + i;
        qr[hh][i] = hh < nh && d < a.dk ? to_f32(q[(head0 + hh) * a.q_sh + d]) : 0.f;
      }

    // this warp's online softmax: lane holds (m, l) of head h_own of the
    // pass (every lane of the same head alike) and acc for its DPL columns
    // of every head
    const int e_own = (lane % 16) / R;               // its score after the reduce-scatter
    const int h_own = e_own % HB;
    const int key_own = (lane / 16) * 2 + e_own / HB;   // of the warp's 4 keys
    float* pw = pbuf + warp * (kKeysPerWarp + 1) * HB;
    // the model's weights (mx_s): every weight from the row's global max,
    // the max over the splits' maxima (exact, so its order does not matter)
    float m_run = kNegInf, l_run = 0.f, acc[HB][DPL];
    const bool fixed_max = a.mx_s != nullptr || a.gmax != nullptr;
    if (a.gmax != nullptr) {
      m_run = h_own < nh ? a.gmax[static_cast<long long>(b) * a.h + head0 + h_own] : 0.f;
    } else if (a.mx_s != nullptr) {
      // this grid is a programmatic dependent of decode_max_kernel: its
      // producer streams keys already; the maxima are read once it is done
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      m_run = h_own < nh ? kNegInf : 0.f;            // (a head past the group: unused)
      for (int sp = 0; sp < a.n_splits && h_own < nh; ++sp)
        m_run = fmaxf(m_run, a.mx_s[(static_cast<long long>(sp) * a.b + b) * a.h + head0 + h_own]);
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[hh][e] = 0.f;

    for (int j = 0; j < n_tiles; ++j, ++g) {
      const int s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      const char* st = ring + s * kStageBytes;
      const int nv = min(kTile, key_end - key_begin - j * kTile);

      // scores: warp w takes keys 4w .. 4w + 3, half warp h keys 4w + 2h
      // and + 1, lane its QE elements of each; the half warp's parts meet
      // in one reduce-scatter, after which lane holds the score of key
      // key_own for head h_own
      float part[32];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = warp * kKeysPerWarp + (lane / 16) * 2 + kk;
        float x[QE];
        load_f32<QE>(reinterpret_cast<const T*>(st + r * RB) + (lane % 16) * QE, x);
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
          float sacc = 0.f;
#pragma unroll
          for (int i = 0; i < QE; ++i) sacc = fmaf(qr[hh][i], x[i], sacc);
          part[kk * HB + hh] = sacc;
        }
      }
      reduce_scatter<NS, 8>(part, lane);

      // softmax over the warp's 4 keys: the lanes of one head differ in
      // lane bits 3 and 4
      const bool valid = warp * kKeysPerWarp + key_own < nv;
      const float sv = valid ? part[0] * a.scale : kNegInf;
      float mx = fmaxf(sv, __shfl_xor_sync(0xffffffffu, sv, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fixed_max ? m_run : fmaxf(m_run, mx);
      const float alpha = fixed_max ? 1.f : expf(m_run - m_new);
      const float p = valid ? expf(sv - m_new) : 0.f;
      float ps = p + __shfl_xor_sync(0xffffffffu, p, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l_run = l_run * alpha + ps;
      m_run = m_new;
      // the weight of p @ v: p itself, or (the model's) p rounded to the
      // cache dtype, while l sums p unrounded
      if (lane % R == 0) pw[key_own * HB + h_own] = fixed_max ? round_as(p, T()) : p;
      if (lane < HB * R && lane % R == 0) pw[kKeysPerWarp * HB + h_own] = alpha;
      __syncwarp();

      // acc = acc * alpha + p @ v over the warp's keys; lane holds columns
      // lane * DPL .. + DPL; p and alpha come through the warp's buffer
#pragma unroll
      for (int h4 = 0; h4 < HB; h4 += 4) {
        const float4 al = *reinterpret_cast<const float4*>(pw + kKeysPerWarp * HB + h4);
        const float a4[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[h4 + i][e] *= a4[i];
      }
      const char* vt = st + kTile * RB;
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk) {
        const int r = warp * kKeysPerWarp + kk;
        if (r >= nv) break;
        float vv[DPL];
        load_f32<DPL>(reinterpret_cast<const T*>(vt + r * RB) + lane * DPL, vv);
#pragma unroll
        for (int h4 = 0; h4 < HB; h4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + kk * HB + h4);
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              acc[h4 + i][e] = fmaf(pp[i], vv[e], acc[h4 + i][e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);         // this warp is done with stage s
    }

    // merge the warps' states in a fixed order: m = max over warps, each
    // warp's acc and l scaled by exp(m_w - m)
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int c = lane * DPL + e;
        if (hh < nh && c < a.dv) macc[(warp * HB + hh) * a.dv + c] = acc[hh][e];
      }
    if (lane < HB * R && lane % R == 0) {
      wm[warp * HB + h_own] = m_run;
      wl[warp * HB + h_own] = l_run;
    }
    consumers_sync();
    const long long bh = static_cast<long long>(a.b) * a.h;
    for (int idx = tid; idx < nh * a.dv; idx += kWarps * 32) {
      const int hh = idx / a.dv, c = idx % a.dv;
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * HB + hh]);
      float av = 0.f, lv = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float sc_w = expf(wm[w * HB + hh] - mm);
        av = fmaf(macc[(w * HB + hh) * a.dv + c], sc_w, av);
        lv = fmaf(wl[w * HB + hh], sc_w, lv);
      }
      const long long row = static_cast<long long>(b) * a.h + head0 + hh;
      if (a.n_splits > 1) {
        const long long srow = split * bh + row;
        a.acc_s[srow * a.dv + c] = av;
        if (c == 0) a.m_s[srow] = mm, a.l_s[srow] = lv;
      } else if (a.partial) {
        static_cast<float*>(a.o)[row * a.dv + c] = av;
      } else {
        store_out<T>(a, row * a.dv + c, av / (lv == 0.f ? 1.f : lv));
      }
      if (a.n_splits == 1 && c == 0 && a.m_out) {
        a.m_out[row] = mm;
        a.l_out[row] = lv;
      }
    }
    consumers_sync();    // macc and m, l are read before the next pass writes them
  }
}

// One block per (b, head): the splits merged in order 0, 1, ..., n - 1, as
// combine_partials merges them (products and sums rounded one by one).  It
// is launched as a programmatic dependent of the split kernel, so its
// launch overlaps the split kernel's tail; griddepcontrol.wait holds it
// until that grid has finished and its writes are visible.  The splits' m
// and l go to shared memory first, and each thread has 8 splits' acc loads
// in flight at once.
constexpr int kCombineBatch = 8;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(Args a) {
  extern __shared__ float ml[];                      // m [n_splits], l [n_splits]
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = blockIdx.x, bh = static_cast<long long>(a.b) * a.h;
  const int n = a.n_splits;
  for (int i = threadIdx.x; i < n; i += kCombineThreads) {
    ml[i] = a.m_s[i * bh + row];
    ml[n + i] = a.l_s[i * bh + row];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.dv; c += kCombineThreads) {
    float acc = a.acc_s[row * a.dv + c], m = ml[0], l = ml[n];
    for (int i0 = 1; i0 < n; i0 += kCombineBatch) {
      float x[kCombineBatch];
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u)
        x[u] = i0 + u < n ? a.acc_s[((i0 + u) * bh + row) * a.dv + c] : 0.f;
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        if (i0 + u >= n) break;
        const float m2 = ml[i0 + u], l2 = ml[n + i0 + u];
        const float mn = fmaxf(m, m2);
        const float w1 = expf(m - mn), w2 = expf(m2 - mn);
        acc = __fadd_rn(__fmul_rn(acc, w1), __fmul_rn(x[u], w2));
        l = __fadd_rn(__fmul_rn(l, w1), __fmul_rn(l2, w2));
        m = mn;
      }
    }
    if (a.partial) {
      static_cast<float*>(a.o)[row * a.dv + c] = acc;
    } else {
      store_out<T>(a, row * a.dv + c, acc / (l == 0.f ? 1.f : l));
    }
    if (c == 0 && a.m_out) {
      a.m_out[row] = m;
      a.l_out[row] = l;
    }
  }
}

// The model's weights need each row's global max before any weight is
// rounded: one block per (split, kv head, b) writes the max of its split's
// scaled scores (q . k) * scale for each head of the group into mx_s;
// warp w takes keys w, w + 8, ...; lane l the head-dim elements l, l + 32,
// ...; a butterfly sums each score.  A split past the row's length writes
// the sentinel.
constexpr int kMaxThreads = 256;
constexpr int kMaxHeads = 8;                          // heads a pass

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) decode_max_kernel(Args a) {
  __shared__ float red[kMaxThreads / 32][kMaxHeads];
  // the split kernel may launch now: it waits for this grid before it
  // reads the maxima
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = a.h / a.kvh;
  const int key_begin = split * a.kps;
  const int key_end = min(row_length(a, b), key_begin + a.kps);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  for (int h0 = 0; h0 < group; h0 += kMaxHeads) {
    float qr[kMaxHeads][8];                           // Dk <= 256: 8 a lane
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = lane + 32 * i;
        qr[hh][i] = h0 + hh < group && d < a.dk
                        ? to_f32(q[(kvh * group + h0 + hh) * a.q_sh + d]) : 0.f;
      }
    float mx[kMaxHeads];
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) mx[hh] = kNegInf;
    for (int key = key_begin + warp; key < key_end; key += kMaxThreads / 32) {
      const T* krow = kg + static_cast<long long>(key) * a.k_st;
      float kv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < a.dk ? to_f32(krow[d]) : 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sc = fmaf(qr[hh][i], kv[i], sc);
        mx[hh] = fmaxf(mx[hh], warp_sum(sc) * a.scale);
      }
    }
    if (lane == 0)
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) red[warp][hh] = mx[hh];
    __syncthreads();
    if (threadIdx.x < kMaxHeads && h0 + threadIdx.x < group) {
      float m = kNegInf;
#pragma unroll
      for (int w = 0; w < kMaxThreads / 32; ++w) m = fmaxf(m, red[w][threadIdx.x]);
      a.mx_s[(static_cast<long long>(split) * a.b + b) * a.h + kvh * group + h0 +
             threadIdx.x] = m;
    }
    __syncthreads();
  }
}

// The T-sharded step's max pass: each row's max over the splits' maxima
// (exact, in any order) into m_out (B, H).
__global__ void __launch_bounds__(kCombineThreads) decode_rowmax_kernel(Args a) {
  const long long bh = static_cast<long long>(a.b) * a.h;
  for (long long row = static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
       row < bh; row += static_cast<long long>(gridDim.x) * kCombineThreads) {
    float m = kNegInf;
    for (int sp = 0; sp < a.n_splits; ++sp) m = fmaxf(m, a.mx_s[sp * bh + row]);
    a.m_out[row] = m;
  }
}

template <typename T, int DPL, int HB>
int launch_split(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(stages<T, DPL>(), HB, DPL, a.dv, sizeof(T));
  auto kernel = decode_split_kernel<T, DPL, HB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.mx_s == nullptr) {
    kernel<<<dim3(a.n_splits, a.kvh, a.b), kThreads, smem, stream>>>(a);
    return REPRO_LAUNCH_STATUS();
  }
  // after decode_max_kernel, as its programmatic dependent
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.kvh, a.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int DPL>
int launch_dpl(const Args& a, cudaStream_t stream) {
  constexpr int kMax = max_heads_per_pass<DPL>();
  const int group = a.h / a.kvh;
  if (a.mx_s != nullptr) {
    decode_max_kernel<T><<<dim3(a.n_splits, a.kvh, a.b), kMaxThreads, 0, stream>>>(a);
    const int e = REPRO_LAUNCH_STATUS();
    if (e != 0) return e;
  }
  const int err = group <= 4 ? launch_split<T, DPL, 4>(a, stream)
                             : launch_split<T, DPL, kMax>(a, stream);
  if (err != 0 || a.n_splits == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.h);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * a.n_splits;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

bool aligned16(const void* p, long long a_, long long b_, long long c_, int es) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (a_ * es) % 16 == 0 &&
         (b_ * es) % 16 == 0 && (c_ * es) % 16 == 0;
}

// A plan the kernels cannot run (a nonzero error), or 0.
int bad_plan(int h, int kvh, int t, int dk, int dv, int n_splits, int kps, bool scratch) {
  const bool bad = kvh <= 0 || h % kvh != 0 || t <= 0 || dk <= 0 || dk > 256 || dv <= 0 ||
                   dv > 256 || n_splits <= 0 || kps <= 0 || kps % kTile != 0 ||
                   static_cast<long long>(n_splits) * kps < t ||
                   static_cast<long long>(n_splits - 1) * kps >= t ||
                   (n_splits > 1 && (!scratch || n_splits > 4096));
  return bad ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <typename T>
int run_decode(const void* q, const void* k, const void* v, void* o, float* m_out,
               float* l_out, float* acc_s, float* m_s, float* l_s, const long long* lengths,
               float* mx_s, const float* gmax, int b, int h, int kvh, int t, int dk, int dv,
               const long long* strides, float scale, int partial, int out_f32, int n_splits,
               int kps, cudaStream_t st) {
  constexpr int es = sizeof(T);
  const int vec = (dk * es) % 16 == 0 && (dv * es) % 16 == 0 &&
                  aligned16(k, strides[2], strides[3], strides[4], es) &&
                  aligned16(v, strides[5], strides[6], strides[7], es);
  Args a{q, k, v, o, m_out, l_out, acc_s, m_s, l_s, lengths, mx_s, gmax, b, h, kvh, t, dk,
         dv, strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], scale, partial, n_splits, kps,
         out_f32, vec};
  const int d = dk > dv ? dk : dv;
  if (d <= 32) return launch_dpl<T, 1>(a, st);
  if (d <= 64) return launch_dpl<T, 2>(a, st);
  if (d <= 128) return launch_dpl<T, 4>(a, st);
  return launch_dpl<T, 8>(a, st);
}

template <typename T>
int decode_entry(const void* q, const void* k, const void* v, void* o,
                 float* m_out, float* l_out, float* acc_s, float* m_s,
                 float* l_s, const long long* lengths, float* mx_s, int b, int h, int kvh,
                 int t, int dk, int dv, const long long* strides, float scale,
                 int partial, int out_f32, int n_splits, int kps, int device,
                 void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0) return 0;
  if (const int e = bad_plan(h, kvh, t, dk, dv, n_splits, kps, acc_s && m_s && l_s)) return e;
  if (mx_s != nullptr && (partial || dk > 8 * 32)) return static_cast<int>(cudaErrorInvalidValue);
  return run_decode<T>(q, k, v, o, m_out, l_out, acc_s, m_s, l_s, lengths, mx_s, nullptr, b,
                       h, kvh, t, dk, dv, strides, scale, partial, out_f32, n_splits, kps,
                       static_cast<cudaStream_t>(stream));
}

// The T-sharded step's max pass: decode_max_kernel over the shard's
// splits into mx_s, then decode_rowmax_kernel into m_out.
template <typename T>
int max_entry(const void* q, const void* k, const long long* lengths, float* mx_s,
              float* m_out, int b, int h, int kvh, int t, int dk, const long long* strides,
              float scale, int n_splits, int kps, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0) return 0;
  if (const int e = bad_plan(h, kvh, t, dk, dk, n_splits, kps, true)) return e;
  if (!lengths || !mx_s || !m_out) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, k, nullptr, m_out, nullptr, nullptr, nullptr, nullptr, lengths, mx_s, nullptr,
         b, h, kvh, t, dk, dk, strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[2], strides[3], strides[4], scale, 0, n_splits, kps, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_max_kernel<T><<<dim3(n_splits, kvh, b), kMaxThreads, 0, st>>>(a);
  const int e = REPRO_LAUNCH_STATUS();
  if (e != 0) return e;
  const long long rows = static_cast<long long>(b) * h;
  const int blocks = static_cast<int>((rows + kCombineThreads - 1) / kCombineThreads);
  decode_rowmax_kernel<<<blocks < 4096 ? blocks : 4096, kCombineThreads, 0, st>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// The T-sharded step's partial pass: the split (and combine) kernels with
// each row's global max given, partial.
template <typename T>
int partial_entry(const void* q, const void* k, const void* v, float* acc, float* m_out,
                  float* l_out, float* acc_s, float* m_s, float* l_s,
                  const long long* lengths, const float* gmax, int b, int h, int kvh, int t,
                  int dk, int dv, const long long* strides, float scale, int n_splits,
                  int kps, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0) return 0;
  if (const int e = bad_plan(h, kvh, t, dk, dv, n_splits, kps, acc_s && m_s && l_s)) return e;
  if (!lengths || !gmax || !m_out || !l_out) return static_cast<int>(cudaErrorInvalidValue);
  return run_decode<T>(q, k, v, acc, m_out, l_out, acc_s, m_s, l_s, lengths, nullptr, gmax, b,
                       h, kvh, t, dk, dv, strides, scale, 1, 0, n_splits, kps,
                       static_cast<cudaStream_t>(stream));
}

}  // namespace

// Dk and Dv up to 256; strides: 8 element strides, (batch, head) of q, then
// (batch, head, time) of k and of v (the last axis of each contiguous);
// out, m and l are contiguous, and m, l may be null.  n_splits and kps
// (keys per split, a multiple of 32) cover [0, T) with no empty split; when
// n_splits > 1, acc_s (n_splits, B, H, Dv), m_s and l_s (n_splits, B, H)
// are f32 scratch.  lengths: null, or (B,) int64 on the device: row b
// attends to keys [0, lengths[b]) (clamped to [0, T]); the plan is the same
// whatever the lengths.  mx_s: null, or (n_splits, B, H) f32 scratch: the
// model's weights (decode_max_kernel first, then every weight from the
// row's global max, rounded to the cache dtype before p @ v; not with
// partial).  out_f32: the normalised out in f32, not q's dtype.
REPRO_API int repro_decode_attention_f32(
    const void* q, const void* k, const void* v, void* o, float* m, float* l,
    float* acc_s, float* m_s, float* l_s, const long long* lengths,
    float* mx_s, int b, int h, int kvh, int t, int dk, int dv, const long long* strides,
    float scale, int partial, int out_f32, int n_splits, int kps, int device,
    void* stream) {
  return decode_entry<float>(q, k, v, o, m, l, acc_s, m_s, l_s, lengths, mx_s, b, h,
                             kvh, t, dk, dv, strides, scale, partial, out_f32,
                             n_splits, kps, device, stream);
}

REPRO_API int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, void* o, float* m, float* l,
    float* acc_s, float* m_s, float* l_s, const long long* lengths,
    float* mx_s, int b, int h, int kvh, int t, int dk, int dv, const long long* strides,
    float scale, int partial, int out_f32, int n_splits, int kps, int device,
    void* stream) {
  return decode_entry<__nv_bfloat16>(q, k, v, o, m, l, acc_s, m_s, l_s, lengths,
                                     mx_s, b, h, kvh, t, dk, dv, strides, scale,
                                     partial, out_f32, n_splits, kps, device,
                                     stream);
}

// The T-sharded step's two passes over one shard's keys (see the note at
// the top).  lengths (B,) int64: row b's keys of this shard, [0,
// lengths[b]) (0 allowed); n_splits and kps as above.  max: q (B, H, Dk),
// k (B, KVH, T, Dk), strides the 5 of q (batch, head) and k (batch, head,
// time); mx_s (n_splits, B, H) f32 scratch; m_out (B, H) f32 receives each
// row's max scaled score over its keys here (-1e30 where it has none).
REPRO_API int repro_decode_max_f32(const void* q, const void* k, const long long* lengths,
                                   float* mx_s, float* m_out, int b, int h, int kvh, int t,
                                   int dk, const long long* strides, float scale,
                                   int n_splits, int kps, int device, void* stream) {
  return max_entry<float>(q, k, lengths, mx_s, m_out, b, h, kvh, t, dk, strides, scale,
                          n_splits, kps, device, stream);
}

REPRO_API int repro_decode_max_bf16(const void* q, const void* k, const long long* lengths,
                                    float* mx_s, float* m_out, int b, int h, int kvh, int t,
                                    int dk, const long long* strides, float scale,
                                    int n_splits, int kps, int device, void* stream) {
  return max_entry<__nv_bfloat16>(q, k, lengths, mx_s, m_out, b, h, kvh, t, dk, strides,
                                  scale, n_splits, kps, device, stream);
}

// partial: gmax (B, H) f32, each row's global max; acc (B, H, Dv), m_out
// and l_out (B, H) f32 receive the shard's sum of p v (p = exp(s - gmax)
// rounded to the cache dtype), gmax again, and the sum of p (unrounded);
// acc_s, m_s, l_s and strides as for repro_decode_attention_*.
REPRO_API int repro_decode_partial_f32(
    const void* q, const void* k, const void* v, float* acc, float* m_out, float* l_out,
    float* acc_s, float* m_s, float* l_s, const long long* lengths, const float* gmax, int b,
    int h, int kvh, int t, int dk, int dv, const long long* strides, float scale,
    int n_splits, int kps, int device, void* stream) {
  return partial_entry<float>(q, k, v, acc, m_out, l_out, acc_s, m_s, l_s, lengths, gmax, b,
                              h, kvh, t, dk, dv, strides, scale, n_splits, kps, device,
                              stream);
}

REPRO_API int repro_decode_partial_bf16(
    const void* q, const void* k, const void* v, float* acc, float* m_out, float* l_out,
    float* acc_s, float* m_s, float* l_s, const long long* lengths, const float* gmax, int b,
    int h, int kvh, int t, int dk, int dv, const long long* strides, float scale,
    int n_splits, int kps, int device, void* stream) {
  return partial_entry<__nv_bfloat16>(q, k, v, acc, m_out, l_out, acc_s, m_s, l_s, lengths,
                                      gmax, b, h, kvh, t, dk, dv, strides, scale, n_splits,
                                      kps, device, stream);
}

// The gradient of the Mamba (S6) selective scan (csrc/mamba_scan.cu, the
// scan without the D * x skip, which stays in PyTorch) with no state in and
// no gradient into the final state, the training path's case: x/delta
// (B, T, Dm), a (Dm, N), b/c (B, T, N) and the output's gradient dy
// (B, T, Dm) -> dx (B, T, Dm) in x's dtype, ddelta (B, T, Dm) in delta's,
// da (Dm, N), db and dc (B, T, N) f32.
//
// Replaces no TPU kernel: the JAX package trains jamba through jax.grad of
// its XLA path (src/repro/kernels/mamba_scan/ops.py:_chunked_assoc), and
// the TPU kernel _mamba_kernel has no VJP.
//
// The math, per (b, channel d, state n), with da_t = exp(delta_t a),
// h_t = da_t h_{t-1} + delta_t x_t b_t (h_{-1} = 0), y_t = sum_n h_t c_t and
// dh_t = dL/dh_t = dy_t c_t + da_{t+1} dh_{t+1}; with p_t = da_t h_{t-1} and
// q_t = dh_t p_t:
//
//     dx_t[d]     = delta_t[d] sum_n dh_t[d, n] b_t[n]
//     ddelta_t[d] = sum_n a[d, n] q_t[d, n] + x_t[d] sum_n dh_t[d, n] b_t[n]
//     da[d, n]    = sum_{b, t} delta_t q_t
//     db_t[n]     = sum_d dh_t[d, n] delta_t[d] x_t[d]
//     dc_t[n]     = sum_d h_t[d, n] dy_t[d]
//
// Each h is recomputed with the forward's own arithmetic (da = 2^(delta *
// a log2 e) on the special-function unit's ex2.approx.ftz.f32, then one
// FMA), so the backward sees the forward kernel's h bit for bit.
//
// What bounds it on the H100: at jamba's training shape (B = 8, T = 128,
// Dm = 16384, N = 16) it reads x, dy (bf16), delta (f32) and writes dx
// (bf16) and ddelta (f32), about 235 MB with b, c and their gradients
// (70 us at 3.35 TB/s), against about 18 f32 flops a step, channel and
// state (72 us at 67 TFLOP/s) and one exponential each (64 us at the
// special-function unit's 16 a clock per SM).  This design takes each
// exponential twice (the checkpoint sweep and the recomputed chunk; the
// reverse walk reuses the chunk's da): 537 M, 128 us, its own floor.  What
// holds it is the issue of its instructions at 128 registers a thread:
// taking the exponentials away moves it ~1 %, the sums' shuffles ~26 %
// (benchmarks_torch/mamba_bwd_variants.py; PERF.md, Findings).
//
// The design:
// * A channel's N states split over L = N / S lanes, S = min(N, kMaxStates)
//   states a thread (plan_mamba_bwd in mamba_scan.py): kThreads / L
//   channels of one batch row a block, 2 blocks (16 warps) an SM.
// * h_{t-1} and da_t at every step of the reverse walk without a third
//   exponential: a first forward sweep keeps each thread's states at the
//   start of every chunk of kC = 8 steps; then, chunk by chunk from the
//   last, the chunk's steps run forward again from that state, keeping each
//   step's h_{t-1} and da_t in registers (2 kC S of them, the loops
//   unrolled), and the reverse walk carries dh backwards through them.  The
//   chunk states stay in shared memory (each thread its own, 4 KB a chunk
//   and block) while the block still fits kBlocksPerSm to an SM: up to
//   T = 136 at N = 16; a longer T keeps them in a scratch buffer of the
//   wrapper's, B (ceil(T / 8) - 1) Dm N f32 with Dm rounded up to a block
//   (the library says how many words: repro_mamba_scan_bwd_scratch).  The
//   forward kernel is left as it is.
// * Nothing in the chain waits on device memory: x, delta, dy, b and c
//   stream through a ring of kStages chunks in shared memory, one barrier
//   a chunk, as TMA boxes of (kC steps, the block's channels or N) that one
//   thread issues against the stage's mbarrier where mamba_scan.py:rows_16b
//   allows; else x, delta and dy by element loads, and b and c (always at
//   N = 2, whose rows are 8 bytes) by 4-byte cp.async copies (for b and c
//   at N = 16 those took 0.9 to 5.4 % longer than the boxes at jamba's
//   training shape; PERF.md, Findings).  The sweep stages x, delta and b
//   alone.
// * The sums without atomics: over a channel's states, a reduce-scatter of
//   (sum_n dh b, ddelta) over its L lanes; over channels (db, dc), the
//   halvings of a reduce-scatter of shuffles in each warp, whose lanes'
//   shares the block adds in order (warp by warp, lane by lane) into a
//   per-block partial for each (b, t, n); mamba_bwd_sum_kernel adds the
//   blocks' partials in kSumGroups runs of consecutive blocks, each in
//   order, then the runs in order, and da's per-row partials over b in
//   order.  Two calls give the same bits, and no sum depends on B.
//
// Any T and Dm work; channels past Dm and steps past T run as zeros (delta
// = 0 is an identity step) and write nothing.
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;      // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kC = 8;              // steps a chunk: its h_{t-1} and da_t in registers
constexpr int kMaxStates = 4;      // states a thread at most
constexpr int kStages = 2;         // chunks in the ring
constexpr int kBlocksPerSm = 2;    // the occupancy the chunk states may not lower
constexpr int kSumGroups = 8;      // runs of blocks mamba_bwd_sum_kernel adds
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

// 2^z on the special-function unit (MUFU.EX2), as the forward kernel takes it.
__device__ __forceinline__ float ex2_sfu(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
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

// A (c0, c1, c2) box of a 3-d tensor map into shared memory, completing on
// the mbarrier bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The index warp_reduce_scatter<K, M, kLo> (common.cuh) leaves lane
// `lane` with.
template <int K, int M, int kLo>
__device__ __forceinline__ int scatter_index(int lane) {
  if constexpr (M >= kLo && K > 1) {
    return (lane & M ? K / 2 : 0) + scatter_index<K / 2, M / 2, kLo>(lane);
  } else {
    return 0;
  }
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

template <int S>
__device__ __forceinline__ void store_row(float* p, const float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int j = 0; j < S; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (S % 2 == 0) {
#pragma unroll
    for (int j = 0; j < S; j += 2)
      *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) p[j] = v[j];
  }
}

struct Args {
  const void* x;         // (B, T, Dm)
  const void* delta;     // (B, T, Dm)
  const float* a;        // (Dm, N)
  const float* bm;       // (B, T, N)
  const float* cm;       // (B, T, N)
  const void* dy;        // (B, T, Dm), x's dtype
  float* ckpt;           // (B, blocks, chunks - 1, kThreads, S), or null: in shared memory
  void* dx;              // (B, T, Dm), x's dtype
  void* ddelta;          // (B, T, Dm), delta's dtype
  float* da_part;        // (B, Dm, N)
  float* db_part;        // (B, blocks, T, N)
  float* dc_part;        // (B, blocks, T, N)
  float* da;             // (Dm, N)
  float* db;             // (B, T, N)
  float* dc;             // (B, T, N)
  int b, t, dm;
  int blocks;            // blocks of a batch row (plan_mamba_bwd)
  int copy16;            // the tiles come by TMA (x, delta, dy rows of 16 bytes)
};

// A thread's states, the lanes a channel and the channels a block.
template <int N>
struct Plan {
  static constexpr int S = N < kMaxStates ? N : kMaxStates;
  static constexpr int L = N / S;
  static constexpr int C = kThreads / L;
  // a warp's lanes that hold parts of the same sum after the halvings of a
  // channel reduce-scatter (which its partials keep apart)
  static constexpr int G = 32 / L / S;
  static_assert(L <= 8 && S * L == N, "N in {2, 4, 8, 16, 32}");
};

constexpr int up128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared memory, in bytes: the ring of kStages chunks (x, delta, dy as
// (kC, C) tiles, each 128-byte aligned for TMA, b and c as (kC, N) rows),
// the warps' sums of db and dc (two chunks: [2][db, dc][kC][kWarps][G][N]
// f32), the ring's mbarriers, then the chunk states when they stay here
// ([chunks - 1][kThreads][S] f32).
template <typename TX, typename TD, int N>
struct Layout {
  using P = Plan<N>;
  static constexpr int kXBytes = kC * P::C * static_cast<int>(sizeof(TX));
  static constexpr int kDBytes = kC * P::C * static_cast<int>(sizeof(TD));
  static constexpr int kX = 0;
  static constexpr int kD = up128(kX + kXBytes);
  static constexpr int kDy = up128(kD + kDBytes);
  static constexpr int kB = up128(kDy + kXBytes);
  static constexpr int kCm = kB + kC * N * 4;
  static constexpr int kStage = up128(kCm + kC * N * 4);
  static constexpr int kRedOne = kC * kWarps * P::G * N;    // floats
  static constexpr int kRed = kStages * kStage;
  static constexpr int kBar = kRed + 4 * kRedOne * 4;
  static constexpr int kCkpt = kBar + 16 * ((kStages * 8 + 15) / 16);
  static constexpr int kCkptChunk = kThreads * P::S * 4;    // bytes a chunk
  static_assert(kXBytes % 16 == 0, "16-byte tile rows");
};

// Whether a T of `chunks` chunks keeps its chunk states in shared memory:
// the block with them (f32 tiles, the largest) still fits kBlocksPerSm to
// an SM of 228 KB (1 KB of each block the system's).
template <int N>
constexpr bool states_fit(int chunks) {
  using G = Layout<float, float, N>;
  return chunks <= 1 ||
         G::kCkpt + (chunks - 1) * G::kCkptChunk <= 228 * 1024 / kBlocksPerSm - 1024;
}

// Rows [row, row + rows) of a (B * T, dm) tensor, channels [ch0, ch0 + C),
// into a (kC, C) tile where no tensor map describes them: one element a
// load and a shared store, so the thread waits here for its loads; zeros
// past the rows and past dm.
template <typename T, int C>
__device__ __forceinline__ void stage_each(T* dst, const T* src, long long row,
                                           int rows, int ch0, int dm) {
  for (int i = threadIdx.x; i < kC * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dst[i] = r < rows && ch0 + c < dm ? src[(row + r) * dm + ch0 + c] : zero<T>();
  }
}

template <typename TX, typename TD, int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    mamba_bwd_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap td,
                     const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, Args a) {
  using P = Plan<N>;
  using G = Layout<TX, TD, N>;
  constexpr int S = P::S, L = P::L, C = P::C, kG = P::G;
  // b and c come by TMA too where their rows are whole 16 bytes
  constexpr bool kBcTma = N * 4 % 16 == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = tid % L;                   // states [part S, part S + S)
  const int cl = tid / L;                     // channel within the block
  const int ch0 = blockIdx.x * C, ch = ch0 + cl;
  const bool live = ch < a.dm;
  // where the lane's share of a channel sum goes: its warp, its place among
  // the kG lanes the halvings leave with parts of the same sum, its state
  const int slot = (warp * kG + ((lane / L) & (kG - 1))) * N + part * S +
                   scatter_index<S, 16, 32 / S>(lane);
  const int bi = blockIdx.y;
  const long long row0 = static_cast<long long>(bi) * a.t;
  const int chunks = (a.t + kC - 1) / kC;
  const int sweeps = chunks - 1, loads = sweeps + chunks;
  const TX* const x = static_cast<const TX*>(a.x);
  const TD* const dl = static_cast<const TD*>(a.delta);
  const TX* const dyg = static_cast<const TX*>(a.dy);
  float* const red = reinterpret_cast<float*>(smem + G::kRed);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + G::kBar);
  TX* const dxo = static_cast<TX*>(a.dx);
  TD* const ddo = static_cast<TD*>(a.ddelta);
  // this thread's state before chunk q (q >= 1) at ck + (q - 1) * kThreads * S
  float* const ck =
      (a.ckpt ? a.ckpt + (static_cast<long long>(bi) * a.blocks + blockIdx.x) *
                             sweeps * kThreads * S
              : reinterpret_cast<float*>(smem + G::kCkpt)) + tid * S;

  float av[S], ap[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    av[j] = live ? a.a[static_cast<long long>(ch) * N + part * S + j] : 0.f;
    ap[j] = av[j] * kLog2e;
  }

  // The ring's loads: s < sweeps is the sweep's chunk s (x, delta, b),
  // then the backward's chunks - 1 .. 0 (x, delta, dy, b, c).  With copy16
  // one thread issues the TMA boxes (zeros past T and Dm) and arms stage
  // s % kStages's mbarrier with their bytes; else x, delta and dy come
  // element by element.  b and c come by 4-byte copies where no box takes
  // them (rows past T are then the next row's, or zeros, and meet
  // delta = dy = 0 there).
  auto load = [&](int s) {
    const bool full = s >= sweeps;
    const int q = full ? loads - 1 - s : s;
    unsigned char* const st = smem + (s % kStages) * G::kStage;
    const int t0 = q * kC, rows = min(kC, a.t - t0);
    const long long r0 = row0 + t0;
    float* const bs = reinterpret_cast<float*>(st + G::kB);
    float* const cs = reinterpret_cast<float*>(st + G::kCm);
    if (a.copy16) {
      if (tid == 0) {
        uint64_t* const b_ = bar + s % kStages;
        mbar_arrive_tx(b_, (1 + full) * (G::kXBytes + kBcTma * kC * N * 4) + G::kDBytes);
        tma_load_3d(st + G::kX, &tx, ch0, t0, bi, b_);
        tma_load_3d(st + G::kD, &td, ch0, t0, bi, b_);
        if (full) tma_load_3d(st + G::kDy, &tdy, ch0, t0, bi, b_);
        if constexpr (kBcTma) {
          tma_load_3d(bs, &tb, 0, t0, bi, b_);
          if (full) tma_load_3d(cs, &tc, 0, t0, bi, b_);
        }
      }
    } else {
      stage_each<TX, C>(reinterpret_cast<TX*>(st + G::kX), x, r0, rows, ch0, a.dm);
      stage_each<TD, C>(reinterpret_cast<TD*>(st + G::kD), dl, r0, rows, ch0, a.dm);
      if (full) stage_each<TX, C>(reinterpret_cast<TX*>(st + G::kDy), dyg, r0, rows, ch0, a.dm);
    }
    if (!(kBcTma && a.copy16)) {
      const long long off = r0 * N;
      for (int i = tid; i < kC * N; i += kThreads) {
        const bool ok = i < rows * N;
        cp_async4(bs + i, ok ? a.bm + off + i : a.bm, ok);
        if (full) cp_async4(cs + i, ok ? a.cm + off + i : a.cm, ok);
      }
    }
  };

  // The block's partials of db and dc for chunk q: its lanes' shares summed
  // in order (warp by warp, each warp's kG in lane order).
  auto flush = [&](int q, int par) {
    const float* const rb = red + par * 2 * G::kRedOne;
    const float* const rc = rb + G::kRedOne;
    const int t0 = q * kC, steps = min(kC, a.t - t0);
    for (int i = tid; i < steps * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      const int base = tt * kWarps * kG * N + n;
      float sb = rb[base], sc = rc[base];
#pragma unroll
      for (int w = 1; w < kWarps * kG; ++w) {
        sb += rb[base + w * N];
        sc += rc[base + w * N];
      }
      const long long o =
          ((static_cast<long long>(bi) * a.blocks + blockIdx.x) * a.t + t0 + tt) * N + n;
      a.db_part[o] = sb;
      a.dc_part[o] = sc;
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    if (r < loads) load(r);
    cp_async_commit();
  }
  float h[S], carry[S], dav[S];   // the state; da_{t+1} dh_{t+1}; da's sum
#pragma unroll
  for (int j = 0; j < S; ++j) h[j] = carry[j] = dav[j] = 0.f;

  for (int s = 0; s < loads; ++s) {
    cp_async_wait<kStages - 2>();   // this thread's copies of load s landed
    if (a.copy16) mbar_wait(bar + s % kStages, (s / kStages) & 1);   // and the boxes
    __syncthreads();                // everyone's, and load s - 1's tile is free
    if (s + kStages - 1 < loads) load(s + kStages - 1);
    cp_async_commit();
    const unsigned char* const st = smem + (s % kStages) * G::kStage;
    const TX* const xs = reinterpret_cast<const TX*>(st + G::kX) + cl;
    const TD* const ds = reinterpret_cast<const TD*>(st + G::kD) + cl;
    const TX* const dys = reinterpret_cast<const TX*>(st + G::kDy) + cl;
    const float* const bs = reinterpret_cast<const float*>(st + G::kB) + part * S;
    const float* const cs = reinterpret_cast<const float*>(st + G::kCm) + part * S;

    if (s < sweeps) {
      // 1. The sweep: chunk s forward, its end state kept for chunk s + 1.
#pragma unroll
      for (int tt = 0; tt < kC; ++tt) {
        const float dt = to_f32(ds[tt * C]);
        const float dx = dt * to_f32(xs[tt * C]);
        float bv[S];
        load_row<S>(bs + tt * N, bv);
#pragma unroll
        for (int j = 0; j < S; ++j) h[j] = fmaf(ex2_sfu(dt * ap[j]), h[j], dx * bv[j]);
      }
      store_row<S>(ck + s * kThreads * S, h);
      continue;
    }

    const int q = loads - 1 - s, t0 = q * kC, steps = min(kC, a.t - t0);
    // the walk's step tt of this thread's channel in dx and ddelta, from the
    // last step down
    const long long last = (row0 + t0 + kC - 1) * a.dm + ch;
    TX* dxp = dxo + last;
    TD* ddp = ddo + last;
    // 2. The partials of the chunk walked last (q + 1).
    if (s > sweeps) flush(q + 1, (s - 1) & 1);
    float* const red_b = red + (s & 1) * 2 * G::kRedOne;
    float* const red_c = red_b + G::kRedOne;
    if (q > 0) {
      load_row<S>(ck + (q - 1) * kThreads * S, h);
    } else {
#pragma unroll
      for (int j = 0; j < S; ++j) h[j] = 0.f;
    }
    // 3. The chunk forward again, keeping h_{t-1} and da_t, with the warp's
    // share of dc_t = sum_d h_t dy_t.
    float hp[kC][S], da[kC][S];
#pragma unroll
    for (int tt = 0; tt < kC; ++tt) {
      const float dt = to_f32(ds[tt * C]);
      const float dx = dt * to_f32(xs[tt * C]);
      const float dyv = to_f32(dys[tt * C]);
      float bv[S], pc[S];
      load_row<S>(bs + tt * N, bv);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        da[tt][j] = ex2_sfu(dt * ap[j]);
        hp[tt][j] = h[j];
        h[j] = fmaf(da[tt][j], h[j], dx * bv[j]);
        pc[j] = h[j] * dyv;
      }
      int idx = 0;                  // the lane's state, in slot already
      warp_reduce_scatter<S, 16, 32 / S>(pc, lane, idx);
      red_c[tt * kWarps * kG * N + slot] = pc[0];
    }
    // 4. The reverse walk with dh_t, no exponential.
#pragma unroll
    for (int tt = kC - 1; tt >= 0; --tt) {
      const float dt = to_f32(ds[tt * C]);
      const float xv = to_f32(xs[tt * C]);
      const float dx = dt * xv;
      const float dyv = to_f32(dys[tt * C]);
      float bv[S], cv[S], pb[S];
      load_row<S>(bs + tt * N, bv);
      load_row<S>(cs + tt * N, cv);
      float gb = 0.f, ga = 0.f;   // sum_n dh b, sum_n a q over the lane's states
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float g = fmaf(dyv, cv[j], carry[j]);           // dh_t
        const float qv = g * (da[tt][j] * hp[tt][j]);         // dh_t da_t h_{t-1}
        dav[j] = fmaf(dt, qv, dav[j]);
        ga = fmaf(av[j], qv, ga);
        gb = fmaf(g, bv[j], gb);
        pb[j] = g * dx;
        carry[j] = da[tt][j] * g;
      }
      // (sum_n dh b, ddelta) over the channel's lanes: lane part 0 ends
      // with the first, lane L / 2 with the second
      float v2[2] = {gb, fmaf(xv, gb, ga)};
      int which = 0;
      if constexpr (L > 1) warp_reduce_scatter<2, L / 2, 1>(v2, lane, which);
      // lane part 0 stores dx, lane L / 2 ddelta (one lane both when L = 1)
      const bool on = live && tt < steps;
      if (on && part == 0) store_as(dxp, dt * v2[0]);
      if (on && part == L / 2) store_as(ddp, v2[L == 1]);
      dxp -= a.dm;
      ddp -= a.dm;
      int idx = 0;
      warp_reduce_scatter<S, 16, 32 / S>(pb, lane, idx);
      red_b[tt * kWarps * kG * N + slot] = pb[0];
    }
  }
  __syncthreads();                  // the last chunk's warp sums are complete
  flush(0, (loads - 1) & 1);
  if (live) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      a.da_part[(static_cast<long long>(bi) * a.dm + ch) * N + part * S + j] = dav[j];
  }
}

// db, dc: the blocks' partials of each (b, t, n), in kSumGroups runs of
// consecutive blocks, each run summed in block order, then the runs in
// order (a block of 256 threads takes 32 (t, n) of one row, a warp a run);
// da: the batch rows' partials summed in row order.  sum_blocks blocks do
// the first, the rest the second.
__global__ void __launch_bounds__(32 * kSumGroups) mamba_bwd_sum_kernel(
    Args a, int n, int sum_blocks) {
  const long long tn = static_cast<long long>(a.t) * n;
  if (static_cast<int>(blockIdx.x) < sum_blocks) {
    __shared__ float runs[2][kSumGroups][32];
    const int per_row = static_cast<int>((tn + 31) / 32);
    const int bi = blockIdx.x / per_row;
    const long long e = static_cast<long long>(blockIdx.x % per_row) * 32 + threadIdx.x % 32;
    const int g = threadIdx.x / 32;
    const int per = (a.blocks + kSumGroups - 1) / kSumGroups;
    const int q0 = min(a.blocks, g * per), q1 = min(a.blocks, q0 + per);
    float sb = 0.f, sc = 0.f;
    if (e < tn) {
      const long long base = static_cast<long long>(bi) * a.blocks * tn + e;
#pragma unroll 4
      for (int q = q0; q < q1; ++q) {
        sb += a.db_part[base + q * tn];
        sc += a.dc_part[base + q * tn];
      }
    }
    runs[0][g][threadIdx.x % 32] = sb;
    runs[1][g][threadIdx.x % 32] = sc;
    __syncthreads();
    if (g == 0 && e < tn) {
#pragma unroll
      for (int r = 1; r < kSumGroups; ++r) {
        sb += runs[0][r][threadIdx.x];
        sc += runs[1][r][threadIdx.x];
      }
      a.db[bi * tn + e] = sb;
      a.dc[bi * tn + e] = sc;
    }
    return;
  }
  const long long j =
      static_cast<long long>(blockIdx.x - sum_blocks) * blockDim.x + threadIdx.x;
  const long long dn = static_cast<long long>(a.dm) * n;
  if (j >= dn) return;
  float s = a.da_part[j];
  for (int q = 1; q < a.b; ++q) s += a.da_part[q * dn + j];
  a.da[j] = s;
}

template <int N>
long long scratch_words(int b, int t, int dm) {
  using P = Plan<N>;
  const int chunks = (t + kC - 1) / kC;
  if (states_fit<N>(chunks)) return 0;
  return static_cast<long long>(b) * ((dm + P::C - 1) / P::C) * (chunks - 1) *
         kThreads * P::S;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// A 3-d map of a contiguous (B, T, Dm) tensor in boxes of C channels by kC
// steps of one batch row; zeros past T and past Dm.  (b and c: Dm = C = N.)
template <typename T, int C>
bool encode_rows(CUtensorMap* map, const void* ptr, int b, int t, int dm) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dm), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dm) * sizeof(T),
                                 static_cast<cuuint64_t>(t) * dm * sizeof(T)};
  const cuuint32_t boxes[3] = {C, kC, 1}, elem[3] = {1, 1, 1};
  return encode(map, map_type<T>(), 3, const_cast<void*>(ptr), dims, strides, boxes, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TX, typename TD, int N>
int launch_n(const Args& a, cudaStream_t stream) {
  using P = Plan<N>;
  using G = Layout<TX, TD, N>;
  const int chunks = (a.t + kC - 1) / kC;
  if (a.blocks != (a.dm + P::C - 1) / P::C || a.b > 65535 ||
      (a.ckpt == nullptr) != states_fit<N>(chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx{}, td{}, tdy{}, tb{}, tc{};
  if (a.copy16 && !(encode_rows<TX, P::C>(&tx, a.x, a.b, a.t, a.dm) &&
                    encode_rows<TD, P::C>(&td, a.delta, a.b, a.t, a.dm) &&
                    encode_rows<TX, P::C>(&tdy, a.dy, a.b, a.t, a.dm) &&
                    (N * 4 % 16 != 0 || (encode_rows<float, N>(&tb, a.bm, a.b, a.t, N) &&
                                         encode_rows<float, N>(&tc, a.cm, a.b, a.t, N)))))
    return static_cast<int>(cudaErrorNotSupported);
  const int bytes = G::kCkpt + (a.ckpt ? 0 : (chunks - 1) * G::kCkptChunk);
  auto kernel = mamba_bwd_kernel<TX, TD, N>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.blocks, a.b), kThreads, bytes, stream>>>(tx, td, tdy, tb, tc, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tn = static_cast<long long>(a.t) * N;
  const long long sum_blocks = a.b * ((tn + 31) / 32);
  const long long da_blocks = (static_cast<long long>(a.dm) * N + 32 * kSumGroups - 1) /
                              (32 * kSumGroups);
  mamba_bwd_sum_kernel<<<static_cast<unsigned>(sum_blocks + da_blocks),
                         32 * kSumGroups, 0, stream>>>(a, N, static_cast<int>(sum_blocks));
  return REPRO_LAUNCH_STATUS();
}

bool rows_16b(const void* p, int dm, int itemsize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (static_cast<long long>(dm) * itemsize) % 16 == 0;
}

template <typename TX, typename TD>
int mamba_bwd_entry(const Args& a, int n, cudaStream_t stream) {
  if (a.copy16 && !(rows_16b(a.x, a.dm, sizeof(TX)) && rows_16b(a.dy, a.dm, sizeof(TX)) &&
                    rows_16b(a.delta, a.dm, sizeof(TD)) &&
                    (n * 4 % 16 != 0 || (rows_16b(a.bm, n, 4) && rows_16b(a.cm, n, 4)))))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 2: return launch_n<TX, TD, 2>(a, stream);
    case 4: return launch_n<TX, TD, 4>(a, stream);
    case 8: return launch_n<TX, TD, 8>(a, stream);
    case 16: return launch_n<TX, TD, 16>(a, stream);
    case 32: return launch_n<TX, TD, 32>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Words of f32 scratch the backward needs for its chunk states at these
// sizes (0: they stay in shared memory; -1: N not compiled).
REPRO_API long long repro_mamba_scan_bwd_scratch(int b, int t, int dm, int n) {
  if (b <= 0 || t <= 0 || dm <= 0) return 0;
  switch (n) {
    case 2: return scratch_words<2>(b, t, dm);
    case 4: return scratch_words<4>(b, t, dm);
    case 8: return scratch_words<8>(b, t, dm);
    case 16: return scratch_words<16>(b, t, dm);
    case 32: return scratch_words<32>(b, t, dm);
    default: return -1;
  }
}

// N in {2, 4, 8, 16, 32}; every tensor contiguous; a, b, c float32; ckpt
// null, or repro_mamba_scan_bwd_scratch's words where they are not 0;
// da_part B Dm N floats, db_part and dc_part B blocks T N, blocks =
// ceil(Dm / (256 / lanes)) (plan_mamba_bwd); copy16 only when x, dy and
// delta have 16-byte aligned bases and rows, and b and c 16-byte aligned
// bases where N >= 4 (their tiles then come by TMA).  _f32: x, dy, delta float32;
// _bf16: x, dy bfloat16, delta float32 (what the jamba block passes under
// bfloat16); _bf16d: delta bfloat16 too.  dx in x's dtype, ddelta in
// delta's; da, db, dc float32.
#define REPRO_MAMBA_BWD(NAME, TX, TD)                                          \
  REPRO_API int NAME(const void* x, const void* delta, const float* a_mat,    \
                     const float* bm, const float* cm, const void* dy,        \
                     float* ckpt, void* dx, void* ddelta, float* da_part,     \
                     float* db_part, float* dc_part, float* da, float* db,    \
                     float* dc, int b, int t, int dm, int n, int blocks,      \
                     int copy16, int device, void* stream) {                  \
    REPRO_SET_DEVICE(device);                                                 \
    if (b <= 0 || t <= 0 || dm <= 0)                                          \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const Args args{x, delta, a_mat, bm, cm, dy, ckpt, dx, ddelta, da_part,   \
                    db_part, dc_part, da, db, dc, b, t, dm, blocks, copy16};  \
    return mamba_bwd_entry<TX, TD>(args, n, static_cast<cudaStream_t>(stream)); \
  }

REPRO_MAMBA_BWD(repro_mamba_scan_bwd_f32, float, float)
REPRO_MAMBA_BWD(repro_mamba_scan_bwd_bf16, __nv_bfloat16, float)
REPRO_MAMBA_BWD(repro_mamba_scan_bwd_bf16d, __nv_bfloat16, __nv_bfloat16)

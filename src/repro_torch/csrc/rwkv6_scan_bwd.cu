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
// dw is taken straight from its definition, a product of two running
// recurrences, never as (d log w) / w from cumulative sums of log w: that
// form (the chunked XLA path's jax.grad, and the plain version's autograd)
// loses dw where w is small (ROADMAP.md queue 3), while this one is
// finite and exact to f32 rounding for any w in [0, 1], w = 0 included.
//
// What bounds it on the H100: at rwkv6-3b's training shape (B = 8, H = 40,
// T = 128, D = 64) it reads r, k, v, dy (bf16) and w (f32) and writes dr,
// dk, dv (bf16) and dw (f32), about 58 MB (17 us at 3.35 TB/s), and does
// 6 FMAs a state entry a step (the S and G recurrences, dr, dk, dv and dw),
// 2.0 GFLOP, 30 us at 67 TFLOP/s: the FFMA rate, if anything.  As in the
// forward, what bounds it in fact is the latency of each step's chain.
// This first kernel is written to be right and simple; PERF.md has its
// time beside its bound.
//
// The design:
// * The forward's grid: one block per (b, h, slab of 32 state columns), the
//   D / 32 slab blocks of a head in a thread-block cluster.  Column j of S
//   and of G evolves on its own, so a block carries its slab of S and G for
//   the whole sequence; 256 threads, each a row i of the slab and D / 8
//   (8 at D = 64) of its columns, in registers.
// * S_{t-1} at every step of the reverse sweep, by recomputation: a first
//   forward sweep writes the slab's state at the start of every chunk of
//   kC = 8 steps to a scratch buffer in device memory (B H T / 8 D^2 f32,
//   84 MB at the training shape, the block reading back only what it
//   wrote); the reverse sweep then, chunk by chunk from the last, runs the
//   chunk's 8 steps forward again from that state, keeping each S_{t-1} in
//   shared memory (each thread its own entries), and walks them backwards
//   with G.  The forward kernel is left as it is (it writes no states): a
//   training step pays one more forward sweep here instead of 21-84 MB of
//   states written in every forward, remat's recomputations included.
// * The sums over all D columns (dr, dk and dw take their row's sum over
//   both slabs) go through distributed shared memory: each block leaves its
//   slab's partial sums of a chunk in its own shared memory, and after one
//   cluster barrier a chunk block c adds the blocks' partials in rank order
//   for rows [32c, 32c + 32) and writes them with the bonus terms.  The
//   partials are double-buffered by chunk parity, so one barrier a chunk
//   suffices.  dv needs only the slab's own rows: a reduce-scatter of
//   shuffles within each warp, then the 8 warps' sums in order.  du is a
//   per-(b, h) partial, summed over b in order by rwkv6_du_sum_kernel.
//   No atomics: every sum has a fixed order, so two calls give the same
//   bits (remat recomputes, and its gradients must not move).
//
// Any T works; the last chunk's missing steps are never run.  r, k, v, w
// and dy are contiguous; the scratch and the partials are the wrapper's.
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kC = 8;          // steps a chunk (its states kept in shared memory)
constexpr int kW = 32;         // state columns a block owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kC == kWarps, "one warp a step for the per-step dot products");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;        // (H, D)
  const void* dy;        // (B, H, T, D), r's dtype
  float* ckpt;           // (B, H, chunks, D, D): the state before each chunk
  void* dr;              // (B, H, T, D), r's dtype
  void* dk;
  void* dv;
  float* dw;             // (B, H, T, D)
  float* du_part;        // (B, H, D)
  float* du;             // (H, D)
  int b, h, t;
};

// Shared memory of a block, in floats.
template <int D>
struct Smem {
  static constexpr int kTPR = kThreads / D;    // threads a row
  static constexpr int kCPT = kW / kTPR;       // slab columns a thread
  static constexpr int kIn = 0;                // [5][kC][D]: r, k, w, v, dy
  static constexpr int kDot = kIn + 5 * kC * D;    // [2][kC]: v.dy, r.(u k)
  static constexpr int kU = kDot + 2 * kC;     // [D]
  static constexpr int kX = kU + D;            // [2][3][kC][D]: partials
  static constexpr int kRed = kX + 2 * 3 * kC * D;  // [kC][kWarps][kW]
  static constexpr int kHist = kRed + kC * kWarps * kW;  // [kC][kCPT][kThreads]
  static constexpr int kFloats = kHist + kC * kCPT * kThreads;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kTPR * D == kThreads && kCPT * kTPR == kW, "thread layout");
};

enum { kR = 0, kK = 1, kWd = 2, kV = 3, kDy = 4 };

// Rows [t0, t0 + n) of r, k, w, v and dy of one (b, h) as f32, all D
// channels, into in[5][kC][D]; steps past n are zeros (w: ones), never read.
template <typename TI, typename TW, int D>
__device__ __forceinline__ void stage(float* in, const Args& a, long long row0,
                                      int t0, int n) {
  const TI* r = static_cast<const TI*>(a.r);
  const TI* k = static_cast<const TI*>(a.k);
  const TW* w = static_cast<const TW*>(a.w);
  const TI* v = static_cast<const TI*>(a.v);
  const TI* dy = static_cast<const TI*>(a.dy);
  for (int idx = threadIdx.x; idx < kC * D; idx += kThreads) {
    const int tt = idx / D;
    const long long g = (row0 + t0) * D + idx;
    const bool ok = tt < n;
    in[kR * kC * D + idx] = ok ? to_f32(r[g]) : 0.f;
    in[kK * kC * D + idx] = ok ? to_f32(k[g]) : 0.f;
    in[kWd * kC * D + idx] = ok ? to_f32(w[g]) : 1.f;
    in[kV * kC * D + idx] = ok ? to_f32(v[g]) : 0.f;
    in[kDy * kC * D + idx] = ok ? to_f32(dy[g]) : 0.f;
  }
}

template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(kThreads, 2) rwkv6_bwd_kernel(Args a) {
  using L = Smem<D>;
  constexpr int kTPR = L::kTPR, kCPT = L::kCPT;
  constexpr int kNB = D / kW;
  extern __shared__ __align__(16) float sm[];
  float* const in = sm + L::kIn;
  float* const dots = sm + L::kDot;
  float* const us = sm + L::kU;
  float* const red = sm + L::kRed;
  float* const hist = sm + L::kHist;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / kTPR;                     // the thread's row
  const int part = tid % kTPR;                  // its columns: part * kCPT ..
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = rank * kW;                     // the slab's first column
  const int jc = j0 + part * kCPT;              // the thread's first column
  const int bh = blockIdx.x / kNB;
  const int h = bh % a.h;
  const long long row0 = static_cast<long long>(bh) * a.t;
  const int chunks = (a.t + kC - 1) / kC;
  float* const ckpt = a.ckpt + static_cast<long long>(bh) * chunks * D * D +
                      i * D + jc;
  const float* const rs = in + kR * kC * D;
  const float* const ks = in + kK * kC * D;
  const float* const ws = in + kWd * kC * D;
  const float* const vs = in + kV * kC * D;
  const float* const dys = in + kDy * kC * D;

  for (int d = tid; d < D; d += kThreads) us[d] = a.u[h * D + d];

  // 1. Forward: the slab's state before every chunk, to the scratch.
  float s[kCPT];
#pragma unroll
  for (int c = 0; c < kCPT; ++c) s[c] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kC, n = min(kC, a.t - t0);
    float* const out = ckpt + static_cast<long long>(ch) * D * D;
#pragma unroll
    for (int c = 0; c < kCPT; c += 4)
      *reinterpret_cast<float4*>(out + c) = make_float4(s[c], s[c + 1], s[c + 2], s[c + 3]);
    if (ch + 1 == chunks) break;               // the last chunk's end is not needed
    __syncthreads();                           // the last chunk's reads are done
    stage<TI, TW, D>(in, a, row0, t0, n);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float wi = ws[tt * D + i], ki = ks[tt * D + i];
#pragma unroll
      for (int c = 0; c < kCPT; ++c) s[c] = fmaf(wi, s[c], ki * vs[tt * D + jc + c]);
    }
  }

  // 2. Backward, chunk by chunk from the last.
  float g[kCPT];
#pragma unroll
  for (int c = 0; c < kCPT; ++c) g[c] = 0.f;
  float du_acc = 0.f;
  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kC, n = min(kC, a.t - t0);
    float* const xs = sm + L::kX + (ch & 1) * 3 * kC * D;   // [3][kC][D]
    __syncthreads();                           // the last chunk's reads are done
    stage<TI, TW, D>(in, a, row0, t0, n);
    __syncthreads();
    // v_t . dy_t and r_t . (u * k_t), warp tt for step tt, lanes over D in
    // a fixed order
    {
      const int tt = warp;
      float vd = 0.f, ruk = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) {
        vd = fmaf(vs[tt * D + d], dys[tt * D + d], vd);
        ruk = fmaf(rs[tt * D + d], us[d] * ks[tt * D + d], ruk);
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, m);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, m);
      }
      if (lane == 0) {
        dots[tt] = vd;
        dots[kC + tt] = ruk;
      }
    }
    // the chunk's steps forward again from its state: S_{t-1} kept for the
    // reverse walk, and the slab's share of S_{t-1} dy_t
    {
      const float* const in_s = ckpt + static_cast<long long>(ch) * D * D;
#pragma unroll
      for (int c = 0; c < kCPT; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(in_s + c);
        s[c] = q.x; s[c + 1] = q.y; s[c + 2] = q.z; s[c + 3] = q.w;
      }
    }
    for (int tt = 0; tt < n; ++tt) {
      const float wi = ws[tt * D + i], ki = ks[tt * D + i];
      float drp = 0.f;
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        hist[(tt * kCPT + c) * kThreads + tid] = s[c];
        drp = fmaf(s[c], dys[tt * D + jc + c], drp);
        s[c] = fmaf(wi, s[c], ki * vs[tt * D + jc + c]);
      }
#pragma unroll
      for (int m = 1; m < kTPR; m <<= 1) drp += __shfl_xor_sync(0xffffffffu, drp, m);
      if (part == 0) xs[tt * D + i] = drp;
    }
    // the reverse walk with G: the slab's shares of G_t v_t and of
    // sum_j G_t S_{t-1}, and G_t^T k_t over the slab's rows
    for (int tt = n - 1; tt >= 0; --tt) {
      const float wi = ws[tt * D + i], ki = ks[tt * D + i], ri = rs[tt * D + i];
      float dkp = 0.f, dwp = 0.f;
      float pv[kCPT];
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        dkp = fmaf(g[c], vs[tt * D + jc + c], dkp);
        dwp = fmaf(g[c], hist[(tt * kCPT + c) * kThreads + tid], dwp);
        pv[c] = g[c] * ki;
        g[c] = fmaf(wi, g[c], ri * dys[tt * D + jc + c]);
      }
#pragma unroll
      for (int m = 1; m < kTPR; m <<= 1) {
        dkp += __shfl_xor_sync(0xffffffffu, dkp, m);
        dwp += __shfl_xor_sync(0xffffffffu, dwp, m);
      }
      if (part == 0) {
        xs[(kC + tt) * D + i] = dkp;
        xs[(2 * kC + tt) * D + i] = dwp;
      }
      int col = 0;
      warp_reduce_scatter<kCPT, 16, kTPR>(pv, lane, col);
      red[(tt * kWarps + warp) * kW + part * kCPT + col] = pv[0];
    }
    __syncthreads();                           // red is complete
    // dv of the slab's columns: the warps' sums in order, plus the bonus
    for (int idx = tid; idx < n * kW; idx += kThreads) {
      const int tt = idx / kW, j = idx % kW;
      float acc = red[(tt * kWarps) * kW + j];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) acc += red[(tt * kWarps + q) * kW + j];
      acc = fmaf(dots[kC + tt], dys[tt * D + j0 + j], acc);
      store_as(static_cast<TI*>(a.dv) + (row0 + t0 + tt) * D + j0 + j, acc);
    }
    cluster.sync();                            // every block's partials are in
    // dr, dk and dw of rows [j0, j0 + 32): the blocks' partials in rank
    // order, plus the bonus terms
    for (int idx = tid; idx < 3 * n * kW; idx += kThreads) {
      const int q = idx / (n * kW), tt = (idx / kW) % n, row = j0 + idx % kW;
      const int e = (q * kC + tt) * D + row;
      float acc = cluster.map_shared_rank(xs, 0)[e];
#pragma unroll
      for (int rk = 1; rk < kNB; ++rk) acc += cluster.map_shared_rank(xs, rk)[e];
      const long long o = (row0 + t0 + tt) * D + row;
      const float bonus = us[row] * dots[tt];
      if (q == 0)
        store_as(static_cast<TI*>(a.dr) + o, fmaf(bonus, ks[tt * D + row], acc));
      else if (q == 1)
        store_as(static_cast<TI*>(a.dk) + o, fmaf(bonus, rs[tt * D + row], acc));
      else
        a.dw[o] = acc;
    }
    if (tid < kW) {
      const int row = j0 + tid;
      for (int tt = n - 1; tt >= 0; --tt)
        du_acc = fmaf(rs[tt * D + row] * ks[tt * D + row], dots[tt], du_acc);
    }
  }
  cluster.sync();  // no block leaves while another may read its memory
  if (tid < kW) a.du_part[static_cast<long long>(bh) * D + j0 + tid] = du_acc;
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

template <typename TI, typename TW, int D>
int launch_d(const Args& a, cudaStream_t stream) {
  constexpr int kNB = D / kW;
  using L = Smem<D>;
  auto kernel = rwkv6_bwd_kernel<TI, TW, D>;
  if (L::kBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.b * a.h * kNB);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kNB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hd = a.h * D;
  rwkv6_du_sum_kernel<<<(hd + 255) / 256, 256, 0, stream>>>(a.du_part, a.du,
                                                            a.b, hd);
  return REPRO_LAUNCH_STATUS();
}

template <typename TI, typename TW>
int rwkv6_bwd_entry(const void* r, const void* k, const void* v, const void* w,
                    const float* u, const void* dy, float* ckpt, void* dr,
                    void* dk, void* dv, float* dw, float* du_part, float* du,
                    int b, int h, int t, int d, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, w, u, dy, ckpt, dr, dk, dv, dw, du_part, du, b, h, t};
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

// D in {32, 64}; every tensor contiguous; ckpt holds B H ceil(T / 8) D^2
// floats, du_part B H D.  _f32: r, k, v, dy, w float32; _bf16: r, k, v, dy
// bfloat16 and w float32 (as the model passes them); _bf16w: w bfloat16 too.
// dr, dk, dv in r's dtype; dw and du float32.
#define REPRO_RWKV6_BWD(NAME, TI, TW)                                          \
  REPRO_API int NAME(const void* r, const void* k, const void* v,             \
                     const void* w, const float* u, const void* dy,           \
                     float* ckpt, void* dr, void* dk, void* dv, float* dw,    \
                     float* du_part, float* du, int b, int h, int t, int d,   \
                     int device, void* stream) {                              \
    return rwkv6_bwd_entry<TI, TW>(r, k, v, w, u, dy, ckpt, dr, dk, dv, dw,   \
                                   du_part, du, b, h, t, d, device, stream);  \
  }

REPRO_RWKV6_BWD(repro_rwkv6_scan_bwd_f32, float, float)
REPRO_RWKV6_BWD(repro_rwkv6_scan_bwd_bf16, __nv_bfloat16, float)
REPRO_RWKV6_BWD(repro_rwkv6_scan_bwd_bf16w, __nv_bfloat16, __nv_bfloat16)

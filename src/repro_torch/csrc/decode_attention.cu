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
// online-softmax state (acc, m, l) across grid steps in VMEM.  Here one
// block per (b, kv head) holds the whole T loop: its 8 warps split T into
// tiles of 32 keys (warp w takes tiles w, w + 8, ...), each warp keeps
// (acc, m, l) for its heads in f32 registers, and at the end the warps'
// states merge through shared memory in a fixed order (warp 0, 1, ...), so
// repeated runs give the same bits.  A warp stages its tile of keys in
// shared memory, 64 columns at a time, with coalesced row reads; then lane
// i scores key t0 + i against every head of the group (the rows padded so
// that the 32 lanes read 32 banks, q transposed so the group's heads load
// as float4), the warp takes the tile's max per head, and the
// probabilities pass through shared memory to the lanes that own the
// output columns (lane c holds columns c, c + 32, ...; v rows are read
// coalesced).  Any T works: keys past T get p = 0, so nothing is padded.
// A group larger than the heads a warp holds in registers (8, or 4 at
// Dv > 128) runs in several passes over T.
//
// Arithmetic per tile, as the TPU kernel orders it: s = (q . k) * scale in
// f32, m_new = max(m, max s), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + sum p, acc = acc * alpha + p @ v; out = acc / l with
// l == 0 read as 1.
//
// What bounds it on the H100: bytes.  At qwen2.5-3b's decode shape (B = 4,
// H = 16 over KVH = 2, T = 512, Dk = Dv = 128, bf16) the cache read is
// 2.1 MB, 0.63 us at 3.35 TB/s, against 8.4 M multiply-adds.  With one
// block per (b, kv head) that shape runs 8 blocks on 132 SMs: a simple
// first version; splitting T over more blocks is for a later one.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;            // keys per warp tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
  int b, h, kvh, t, dk, dv;
  long long q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  float scale;
  int partial;
};

// Heads a warp holds per pass: HB * VPL accumulators per lane.
template <int VPL>
__host__ __device__ constexpr int heads_per_pass() { return VPL <= 4 ? 8 : 4; }

// A warp stages its key tile kDC columns at a time, rows kTile x kStride
// elements: one padding element in f32, two in bf16, so that a row is an
// odd number of 4-byte words and lane i, reading row i, hits bank i.
constexpr int kDC = 64;
// rows of the key tile, and of v, whose loads a lane has in flight at once:
// one block per SM leaves no other warp to hide the latency of device memory
constexpr int kRows = 8;
constexpr int kVRows = 4;
template <typename T>
__host__ __device__ constexpr int k_stride() { return kDC + (sizeof(T) == 4 ? 1 : 2); }

// Shared memory, in bytes: q of the pass's heads (transposed, [Dk][HB]),
// each warp's p ([kTile][HB]) and (m, l) ([HB] each), then one region that
// holds the warps' key tiles during the T loop and their acc ([HB][Dv])
// for the merge after it.
__host__ __device__ inline size_t smem_bytes(int hb, int dk, int dv,
                                             size_t tile_bytes) {
  const size_t floats = static_cast<size_t>(hb) * dk +
                        static_cast<size_t>(kWarps) * kTile * hb +
                        2 * static_cast<size_t>(kWarps) * hb;
  const size_t acc = static_cast<size_t>(kWarps) * hb * dv * sizeof(float);
  const size_t tiles = kWarps * tile_bytes;
  return floats * sizeof(float) + (tiles > acc ? tiles : acc);
}

template <typename T>
__device__ __forceinline__ T zero_as() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_as<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// VPL: output columns per lane (Dv <= 32 * VPL).
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  constexpr int HB = heads_per_pass<VPL>();
  constexpr int KS = k_stride<T>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qt = smem;                                  // [dk][HB]
  float* pw = qt + HB * a.dk + warp * kTile * HB;    // this warp's [kTile][HB]
  float* red_m = qt + HB * a.dk + kWarps * kTile * HB;   // [kWarps][HB]
  float* red_l = red_m + kWarps * HB;                // [kWarps][HB]
  float* region = red_l + kWarps * HB;
  T* kt = reinterpret_cast<T*>(region) + warp * kTile * KS;   // [kTile][KS]
  float* red_acc = region;                           // [kWarps][HB][dv]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int group = a.h / a.kvh;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int h0 = 0; h0 < group; h0 += HB) {
    const int nh = min(HB, group - h0);
    const int head0 = kvh * group + h0;              // first q head of the pass
    __syncthreads();   // the previous pass is done with shared memory
    for (int idx = tid; idx < HB * a.dk; idx += kThreads) {
      const int hh = idx / a.dk, d = idx % a.dk;
      qt[d * HB + hh] = hh < nh ? to_f32(q[(head0 + hh) * a.q_sh + d]) : 0.f;
    }
    __syncthreads();

    float m[HB], l[HB], acc[HB][VPL];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      m[hh] = kNegInf;
      l[hh] = 0.f;      // this lane's share of the sum; reduced at the end
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[hh][e] = 0.f;
    }

    for (int t0 = warp * kTile; t0 < a.t; t0 += kWarps * kTile) {
      const int nv = min(kTile, a.t - t0);
      const bool valid = lane < nv;                  // lane scores key t0 + lane
      float s[HB];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) s[hh] = 0.f;
      for (int d0 = 0; d0 < a.dk; d0 += kDC) {
        const int nd = min(kDC, a.dk - d0);
        __syncwarp();    // every lane is done reading the previous columns
        // coalesced along each row; kRows rows' loads in flight at once
        for (int r0 = 0; r0 < kTile; r0 += kRows) {
          T lo[kRows], hi[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const T* krow = kb + static_cast<long long>(t0 + r0 + i) * a.k_st + d0;
            const bool row = r0 + i < nv;
            lo[i] = row && lane < nd ? krow[lane] : zero_as<T>();
            hi[i] = row && lane + 32 < nd ? krow[lane + 32] : zero_as<T>();
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            kt[(r0 + i) * KS + lane] = lo[i];
            kt[(r0 + i) * KS + lane + 32] = hi[i];
          }
        }
        __syncwarp();
        const T* mine = kt + lane * KS;
#pragma unroll 8
        for (int d = 0; d < nd; ++d) {
          const float kd = to_f32(mine[d]);
          const float* qd = qt + (d0 + d) * HB;
#pragma unroll
          for (int h4 = 0; h4 < HB; h4 += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qd + h4);
            s[h4] = fmaf(qv.x, kd, s[h4]);
            s[h4 + 1] = fmaf(qv.y, kd, s[h4 + 1]);
            s[h4 + 2] = fmaf(qv.z, kd, s[h4 + 2]);
            s[h4 + 3] = fmaf(qv.w, kd, s[h4 + 3]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        float p = 0.f;
        if (hh < nh) {
          const float sv = valid ? s[hh] * a.scale : kNegInf;
          const float m_new = fmaxf(m[hh], warp_max(sv));
          const float alpha = expf(m[hh] - m_new);
          p = valid ? expf(sv - m_new) : 0.f;
          l[hh] = l[hh] * alpha + p;
          m[hh] = m_new;
#pragma unroll
          for (int e = 0; e < VPL; ++e) acc[hh][e] *= alpha;
        }
        pw[lane * HB + hh] = p;
      }
      __syncwarp();
      // kVRows v rows' loads in flight at once (rows past T read as 0, p = 0)
      for (int j0 = 0; j0 < nv; j0 += kVRows) {
        float vv[kVRows][VPL];
#pragma unroll
        for (int jj = 0; jj < kVRows; ++jj) {
          const T* vrow = vb + static_cast<long long>(t0 + j0 + jj) * a.v_st;
#pragma unroll
          for (int e = 0; e < VPL; ++e) {
            const int c = lane + 32 * e;
            vv[jj][e] = j0 + jj < nv && c < a.dv ? to_f32(vrow[c]) : 0.f;
          }
        }
#pragma unroll
        for (int jj = 0; jj < kVRows; ++jj) {
#pragma unroll
          for (int h4 = 0; h4 < HB; h4 += 4) {
            const float4 pv =
                *reinterpret_cast<const float4*>(pw + (j0 + jj) * HB + h4);
            const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < VPL; ++e)
                acc[h4 + i][e] = fmaf(pp[i], vv[jj][e], acc[h4 + i][e]);
          }
        }
      }
      __syncwarp();    // the tile's p are read before the next tile writes
    }

    // this warp's state, then a fixed-order merge over the warps; acc goes
    // where the key tiles were, so every warp must be done with its tile
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh >= nh) break;
      const float lw = warp_sum(l[hh]);
      if (lane == 0) {
        red_m[warp * HB + hh] = m[hh];
        red_l[warp * HB + hh] = lw;
      }
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        const int c = lane + 32 * e;
        if (c < a.dv) red_acc[(warp * HB + hh) * a.dv + c] = acc[hh][e];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nh * a.dv; idx += kThreads) {
      const int hh = idx / a.dv, c = idx % a.dv;
      float mm = kNegInf;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w * HB + hh]);
      float av = 0.f, lv = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float sc = expf(red_m[w * HB + hh] - mm);
        av = fmaf(red_acc[(w * HB + hh) * a.dv + c], sc, av);
        lv = fmaf(red_l[w * HB + hh], sc, lv);
      }
      const long long row = static_cast<long long>(b) * a.h + head0 + hh;
      if (a.partial) {
        static_cast<float*>(a.o)[row * a.dv + c] = av;
      } else {
        store_as(static_cast<T*>(a.o) + row * a.dv + c, av / (lv == 0.f ? 1.f : lv));
      }
      if (c == 0 && a.m_out) {
        a.m_out[row] = mm;
        a.l_out[row] = lv;
      }
    }
  }
}

template <typename T, int VPL>
int launch_vpl(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(heads_per_pass<VPL>(), a.dk, a.dv,
                                 static_cast<size_t>(kTile) * k_stride<T>() * sizeof(T));
  auto kernel = decode_kernel<T, VPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.kvh, a.b), kThreads, smem, stream>>>(a);
  return REPRO_LAUNCH_STATUS();
}

template <typename T>
int decode_entry(const void* q, const void* k, const void* v, void* o,
                 float* m_out, float* l_out, int b, int h, int kvh, int t,
                 int dk, int dv, const long long* strides, float scale,
                 int partial, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (b <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || t < 0 || dk <= 0 || dk > 256 || dv <= 0 ||
      dv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, m_out, l_out, b, h, kvh, t, dk, dv,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], scale, partial};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dv <= 32) return launch_vpl<T, 1>(a, st);
  if (dv <= 64) return launch_vpl<T, 2>(a, st);
  if (dv <= 128) return launch_vpl<T, 4>(a, st);
  return launch_vpl<T, 8>(a, st);
}

}  // namespace

// Dk and Dv up to 256; strides: 8 element strides, (batch, head) of q, then
// (batch, head, time) of k and of v (the last axis of each contiguous);
// out, m and l are contiguous, and m, l may be null.
REPRO_API int repro_decode_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, float* m,
                                         float* l, int b, int h, int kvh,
                                         int t, int dk, int dv,
                                         const long long* strides, float scale,
                                         int partial, int device, void* stream) {
  return decode_entry<float>(q, k, v, o, m, l, b, h, kvh, t, dk, dv, strides,
                             scale, partial, device, stream);
}

REPRO_API int repro_decode_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, float* m,
                                          float* l, int b, int h, int kvh,
                                          int t, int dk, int dv,
                                          const long long* strides, float scale,
                                          int partial, int device, void* stream) {
  return decode_entry<__nv_bfloat16>(q, k, v, o, m, l, b, h, kvh, t, dk, dv,
                                     strides, scale, partial, device, stream);
}

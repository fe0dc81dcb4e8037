// Hopper building blocks shared by the tensor-core kernels
// (flash_attention.cu's flash_wgmma_kernel and flash_attention_bwd.cu's
// flash_dq_wgmma_kernel and flash_dkdv_wgmma_kernel): mbarriers, TMA tensor-map loads into
// 128-byte-swizzled boxes of 64 bf16 columns, wgmma descriptors, fences and
// waits, and the host's tensor-map encoder.
#pragma once

#include "wgmma.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBox = 64;                    // bf16 columns per 128-byte swizzled box
constexpr unsigned kWaitLimit = 1u << 20;   // mbarrier polls before a fault is declared

// The width N of the register-A products (wgmma_rs) that accumulate D
// result columns: D rounded up to a multiple of 32 (96 for hubert's 80).
// The B operand's columns past D are the zeros TMA fills past the head dim,
// so the extra accumulators stay exactly 0 and are never stored.
template <int D>
__host__ __device__ constexpr int mma_n() { return (D + 31) / 32 * 32; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Perm {                               // tensor-map dim (1..3) of seq, head, batch
  int q[3], k[3], v[3];
};

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
// Wait for the phase of parity ``parity``; a wait that never ends is a
// fault (a lost copy), reported as one instead of a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kWaitLimit) __trap();
  }
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
// Coordinates of column ``col`` of (seq, head, batch) in a map whose dims
// 1..3 hold them in the order ``pos`` gives.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         const int (&pos)[3], int col, int seq,
                                         int head, int batch, uint64_t* bar) {
  const int x[3] = {seq, head, batch};
  int c[3];
#pragma unroll
  for (int d = 1; d <= 3; ++d)
    c[d - 1] = pos[0] == d ? x[0] : pos[1] == d ? x[1] : x[2];
  tma_load_4d(dst, map, col, c[0], c[1], c[2], bar);
}

// A wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else {
    static_assert(N == 256, "wgmma_rs widths: 32, 64, 96, 128, 192, 256 (mma_n)");
    wgmma_rs_n256(d, a, db);
  }
}

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-d bf16 map of a (batch, head, seq, d) view, d contiguous: dim 0 is d
// in boxes of 64 columns, dims 1..3 the other three sorted by stride (a
// dim of size 1 takes the largest stride); ``pos`` says where seq, head and
// batch went.  Sizes are clamped to 1 (an empty axis is never loaded).
bool encode_map(CUtensorMap* map, const void* ptr, int d, const int (&size)[3],
                const long long (&stride)[3], int box_rows, int (&pos)[3]) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  long long st[3];
  long long widest = d * 2LL;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * 2 > widest) widest = stride[i] * 2;
  for (int i = 0; i < 3; ++i) st[i] = size[i] > 1 ? stride[i] * 2 : widest;
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (st[order[j]] < st[order[i]]) {
        const int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  const int box[3] = {box_rows, 1, 1};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t boxes[4] = {kBox, 0, 0, 0}, elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int r = order[i];
    dims[i + 1] = static_cast<cuuint64_t>(size[r] > 1 ? size[r] : 1);
    strides[i] = static_cast<cuuint64_t>(st[r]);
    boxes[i + 1] = box[r];
    pos[r] = i + 1;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

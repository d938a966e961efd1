// What the flash-attention kernels share: K7 (flash_attention.cu, the
// forward) and K8 (flash_attention_bwd.cu, the backward). The mask and band
// of the Pallas kernels in repro/kernels/flash_attention.py, and the bf16
// tensor-core pieces: cp.async staging of row-major tiles, ldmatrix
// fragments and mma.sync.m16n8k16 with f32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

// the mask of _fwd_kernel: key kj of sk is visible from the query at
// position pi (its row plus the causal query offset qp: a shard of the
// sequence whose first query sits at position qp; a causal mask or a
// window only where the keys are the queries' own timeline)
__device__ __forceinline__ bool visible(int pi, int kj, int sk, int causal,
                                        int window) {
  return kj < sk && (!causal || kj <= pi) && (window <= 0 || kj > pi - window);
}

// the tiles [t0, t1) of sk keys that intersect the band of the query rows
// [q0, q1), which sit at positions [q0 + qp, q1 + qp)
__device__ __forceinline__ void key_tiles(int q0, int q1, int sk, int bk,
                                          int causal, int window, int qp,
                                          int* t0, int* t1) {
  const int khi = causal ? min(sk, q1 + qp) : sk;
  const int klo = window > 0 ? max(0, q0 + qp - window + 1) : 0;
  *t0 = klo / bk;
  *t1 = (khi + bk - 1) / bk;
}

// the mask arguments both entry points take: a causal call needs q_pos0 +
// s <= sk (its last query's keys exist; q_pos0 = 0 and sk = s is plain
// causal self-attention), a call without the causal mask takes no offset
// (a cross-attention's sk of its own), and a window only sk = s with no
// offset (no sequence-parallel split runs a windowed layer)
inline bool offset_ok(int s, int sk, int causal, int window, int q_pos0) {
  if (q_pos0 < 0 || (!causal && q_pos0 > 0)) return false;
  if (causal && static_cast<long long>(q_pos0) + s > sk) return false;
  return window <= 0 || (q_pos0 == 0 && sk == s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// four 8x8 bf16 tiles from shared memory; lane i names row i % 8 of tile
// i / 8, and r[j] is this lane's fragment of tile j (transposed with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + kRows) of a [s, D] bf16 matrix into shared memory (row
// stride D + 8) with 16-byte cp.async copies by kNthreads threads; rows at
// or past s read nothing and are zero-filled
template <int D, int kRows, int kNthreads = kThreads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int s) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < kRows * kVec; idx += kNthreads) {
    const int r = idx / kVec, c = (idx - r * kVec) * 8;
    const bool in = r0 + r < s;
    const __nv_bfloat16* from =
        src + static_cast<int64_t>(in ? r0 + r : 0) * D + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(smem_addr(dst + r * (D + 8) + c)), "l"(from),
                   "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One warp's c[8][4] = A B^T: A's 16 rows at a, B's 64 rows at b (both
// row-major, row stride D + 8), the sum over D. c[j][e] is row g + (e / 2)
// * 8 and column j * 8 + 2 t + e % 2 of the 16 x 64 result (g = lane / 4,
// t = lane % 4): the accumulator layout of mma.sync.
template <int D>
__device__ __forceinline__ void warp_abt(float (&c)[8][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int lane) {
  constexpr int kStride = D + 8;
  const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lquad = lane >> 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];  // rows 0-7 / 8-15 x columns 0-7 / 8-15 of the slice
    ldsm_x4(af, a + (lhalf * 8 + lrow) * kStride + kk * 16 + lquad * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bf[4];  // B rows 0-7 / 8-15 of the pair x columns 0-7 / 8-15
      ldsm_x4(bf, b + (jp * 16 + lquad * 8 + lrow) * kStride + kk * 16 +
                      lhalf * 8);
      mma_bf16(c[2 * jp], af, bf[0], bf[1]);
      mma_bf16(c[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// a [16, 64] f32 accumulator (the layout above) as the bf16 A fragments of
// a product over its 64 columns: the accumulator layout of mma.sync is the
// A operand's, so the values stay in registers
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[4][4],
                                           const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16(x[j][0], x[j][1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// One warp's acc += P B: P [16, 64] as A fragments, B [64, kN * 8] at b
// (row-major, row stride D + 8); B runs along the product's k axis, so its
// fragments come through ldmatrix.trans
template <int D, int kN>
__device__ __forceinline__ void warp_pb(float (&acc)[kN][4],
                                        const uint32_t (&pa)[4][4],
                                        const __nv_bfloat16* b, int lane) {
  constexpr int kStride = D + 8;
  const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lquad = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t bf[4];  // rows 0-7 / 8-15 x columns 0-7 / 8-15 of the pair
      ldsm_x4_trans(bf, b + (kk * 16 + lhalf * 8 + lrow) * kStride +
                            np * 16 + lquad * 8);
      mma_bf16(acc[2 * np], pa[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], pa[kk], bf[2], bf[3]);
    }
  }
}

// the current device's SM count, for grids sized to fill the card; 0 or a
// cudaError
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(err);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// K7 flash_fwd: causal / sliding-window GQA attention forward for Hopper
// (sm_90a), returning the output and the per-row logsumexp.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_fwd
// (_fwd_kernel). That kernel walked a sequential grid (BH, q tiles, k tiles)
// and carried the online-softmax state (m, l, acc) in VMEM scratch from one
// k step to the next; it needed S to be a multiple of its 512-row blocks.
// Here one block owns one (head, query tile) and loops over the key tiles
// itself, so the state lives in registers for the whole loop; tiles that lie
// wholly outside the causal or window band are never visited, and the ragged
// tail (S not a multiple of the tile) is masked, so any S works. GQA: query
// head n reads KV head n / g straight from memory, with no replication.
//
// Semantics, as _fwd_kernel: scores in f32, a masked score is -1e30 and its
// p is 0, m starts at -1e30, l and the accumulator in f32,
// o = acc / max(l, 1e-30) in q's type, lse = m + log(max(l, 1e-30)) in f32.
// Like the TPU kernel, the bf16 kernel rounds p to v's type (bf16, the
// tensor cores' operand) before the PV product and sums l from the
// unrounded p; for f32 inputs the rounding is a no-op.
//
// What bounds it: operations. At minitron-4b's prefill (q [48, 4096, 128],
// k/v [16, 4096, 128], bf16, causal) it moves 135 MB (q, k, v, o, lse once
// each: 0.04 ms at 3.35 TB/s) for 2.06e11 flops of the two products (0.21
// ms at the 989 TFLOP/s bf16 tensor-core peak); at recurrentgemma-9b's
// (q [32, 4096, 256], k/v [2, 4096, 256], window 2048) 143 MB (0.04 ms)
// for the same 2.06e11 flops of the window's band (0.2085 ms). At
// granite-moe-3b-a800m's (q [48, 4096, 64], k/v [16, 4096, 64], causal)
// 1.03e11 flops (0.104 ms), and beside them the softmax's 4.03e8 ex2, one
// a score of the causal band: at 16 results a clock an SM on the special-
// function units, about 0.096 ms. At D = 64 the exponentials cost about as
// much as the products (at D = 128 half as much), so a warpgroup that runs
// its softmax and then its products in turn is held near their sum; the D
// = 64 kernel runs one warpgroup's softmax under the others' products.
//
// Five kernels:
// * bf16 at D = 64, flash_fwd_wgmma64_kernel (namespace wg64, below): three
//   consumer warpgroups of 64 queries each and a producer warpgroup that
//   streams 128-key K and V tiles to all three through a TMA ring; Q in
//   shared memory; registers 128 a thread at launch, 160 for each
//   consumer thread (setmaxnreg), shared memory 153 KB (one block an SM).
// * bf16 at D = 128, flash_fwd_wgmma_kernel (namespace wg, below): one
//   warpgroup, Q in registers, K and V through a two-stage TMA ring,
//   wgmma products.
// * bf16 at D = 256, flash_fwd_wgmma256_kernel (namespace wg256, below):
//   two consumer warpgroups on two query heads of a GQA group and a
//   producer warpgroup that feeds both through a TMA ring; registers
//   168 a thread at launch, 240 for each consumer thread (setmaxnreg),
//   shared memory 193 KB (one block an SM).
// * flash_fwd_mma_kernel (bf16 at D 16, 32 and 96): 4 warps, a 64-query
//   tile (16 rows a warp), 64-key tiles. Q, K and V are copied row-major
//   into shared memory with 16-byte cp.async (rows padded by 8 elements,
//   so the eight rows an ldmatrix reads fall on 32 distinct banks); the
//   fragments come through ldmatrix (.trans for V, whose B operand runs
//   along the key axis), and S = Q K^T and O += P V run on the tensor
//   cores as mma.sync.m16n8k16 bf16 -> f32. The S accumulator's layout is
//   the A operand's layout of the PV product, so P goes from registers to
//   the tensor cores without touching shared memory (the FlashAttention-2
//   arrangement). No multi-stage pipeline, TMA or wgmma: each key tile is
//   copied, then used, with two __syncthreads a tile; the other blocks on
//   the SM overlap one block's copies.
// * flash_fwd_f32_kernel (f32; any of the supported D): 4 warps, 16
//   queries (4 rows a warp), 32-key tiles staged as f32. Lane j scores key j
//   of the tile; the row's max and sum are warp shuffles; lane c accumulates
//   output columns c, c + 32, ... with p broadcast by shuffle. f32 FMAs, so
//   f32 inputs keep f32 products (mma in TF32 would not).
#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct MmaTile {
  static constexpr int kBq = 64;
  static constexpr int kBk = 64;
  static constexpr int kStride = D + 8;     // bf16 elements a staged row
  static constexpr size_t kSmem = static_cast<size_t>(kBq + 2 * kBk) *
                                  kStride * sizeof(__nv_bfloat16);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int s, int group,
                         int causal, int window, float scale) {
  using T = MmaTile<D>;
  constexpr int kNt = D / 8;                // output n-tiles of 8 columns
  constexpr int kStride = T::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + T::kBq * kStride;
  __nv_bfloat16* vs = ks + T::kBk * kStride;

  // the last query tiles, which visit the most causal key tiles, start first
  const int nq = (s + T::kBq - 1) / T::kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * T::kBq;
  const int bh = blockIdx.y;
  const int64_t qoff = static_cast<int64_t>(bh) * s * D;
  const int64_t kvoff = static_cast<int64_t>(bh / group) * s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8
  stage_rows<D, T::kBq>(qs, q + qoff, q0, s);

  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};    // this thread's columns only; summed over
                                  // the quad at the end
  int t0, t1;
  key_tiles(q0, min(q0 + T::kBq, s), s, T::kBk, causal, window, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * T::kBk;
    __syncthreads();                        // the last tile's readers are done
    stage_rows<D, T::kBk>(ks, k + kvoff, k0, s);
    stage_rows<D, T::kBk>(vs, v + kvoff, k0, s);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float sc[8][4];
    warp_abt<D>(sc, qs + warp * 16 * kStride, ks, lane);

    // mask, running max over the quad that shares a row
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float val = visible(row, key, s, causal, window)
                              ? sc[j][e] * scale
                              : kMasked;
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m_run[r] - mx[r]) * kLog2e);
      m_run[r] = mx[r];
      l_run[r] *= corr[r];
    }
    // p = exp(s - m) (0 where masked); l from the f32 p; P as bf16 A
    // fragments (the S accumulator's layout is the A operand's)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = sc[j][e];
        sc[j][e] = val == kMasked ? 0.f
                                  : exp2f((val - m_run[e >> 1]) * kLog2e);
        l_run[e >> 1] += sc[j][e];
      }
    }
    uint32_t pa[4][4];
    to_a_frags(pa, sc);
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V: k runs over the tile's 64 keys in 4 steps of 16; V is
    // row-major [key][d], so its B fragments come through ldmatrix.trans
    warp_pb<D, kNt>(acc, pa, vs, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = row0 + r * 8;
    if (row >= s) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = o + qoff + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
    }
    if (t == 0) {
      lse[static_cast<int64_t>(bh) * s + row] = m_run[r] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 with FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Bq = 16;   // 4 rows a warp
constexpr int kF32Bk = 32;   // one key a lane

template <int D>
constexpr size_t f32_smem() {
  return (static_cast<size_t>(kF32Bq) * D +
          static_cast<size_t>(kF32Bk) * (D + 1) +
          static_cast<size_t>(kF32Bk) * D) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int s, int group,
                         int causal, int window, float scale) {
  constexpr int kRows = kF32Bq / (kThreads / 32);
  constexpr int kPer = (D + 31) / 32;       // output columns a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [Bq][D]
  float* ks = qs + kF32Bq * D;                    // [Bk][D + 1]
  float* vs = ks + kF32Bk * (D + 1);              // [Bk][D]

  const int nq = (s + kF32Bq - 1) / kF32Bq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kF32Bq;
  const int bh = blockIdx.y;
  const int64_t qoff = static_cast<int64_t>(bh) * s * D;
  const int64_t kvoff = static_cast<int64_t>(bh / group) * s * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < kF32Bq * D; idx += kThreads) {
    const int r = idx / D;
    qs[idx] = q0 + r < s ? q[qoff + static_cast<int64_t>(q0) * D + idx] : 0.f;
  }
  float acc[kRows][kPer];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[i][c] = 0.f;
  }
  int t0, t1;
  key_tiles(q0, min(q0 + kF32Bq, s), s, kF32Bk, causal, window, &t0,
            &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * kF32Bk;
    __syncthreads();
    for (int idx = tid; idx < kF32Bk * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < s) {
        const int64_t off = kvoff + static_cast<int64_t>(k0) * D + idx;
        kv = k[off];
        vv = v[off];
      }
      ks[r * (D + 1) + c] = kv;
      vs[idx] = vv;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qr = warp * kRows + i;
      const int row = q0 + qr;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qs[qr * D + d], ks[lane * (D + 1) + d], dot);
      }
      const bool vis = visible(row, key, s, causal, window);
      const float sv = vis ? dot * scale : kMasked;
      float mx = sv;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = expf(m_run[i] - m_new);
      const float p = vis ? expf(sv - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      }
      l_run[i] = l_run[i] * corr + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kF32Bk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] = fmaf(pj, vs[j * D + d], acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= s) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[qoff + static_cast<int64_t>(row) * D + d] = acc[i][c] / l;
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * s + row] = m_run[i] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 128 on wgmma, with a TMA copy ring
// ---------------------------------------------------------------------------

namespace wg {

using hopper::wg::aligned_smem;
using hopper::wg::kD;
using hopper::wg::kmajor;
using hopper::wg::kTile;
using hopper::wg::kTileBytes;
using hopper::wg::load_rows;
using hopper::wg::mnmajor;

constexpr float kLn2 = 0.6931471805599453f;

using hopper::ex2;

constexpr int kThreadsWg = 128;          // one warpgroup
constexpr int kStages = 2;               // the copy ring of K, V
constexpr size_t kSmem = 1024 + kStages * 2 * kTileBytes + 64;

// One block per (query head, 64-query tile), three blocks an SM: Q in
// registers as the A operand of S = Q K^T, the band's K and V tiles
// streamed through the ring. The running max m is over the raw scores; p =
// 2^(s c - m c) with c = scale log2e, and lse = m c ln 2 + log l.
__global__ void __launch_bounds__(kThreadsWg, 3)
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int s, int group,
                           int causal, int window, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);            // K, V a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 *
                                               kTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // heads fastest: the last query tiles of every head, which visit the
  // most causal key tiles, start first
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int bh = blockIdx.x;
  const int hk = bh / group;
  int t0, t1;
  key_tiles(q0, min(q0 + kTile, s), s, kTile, causal, window, &t0, &t1);
  const int items = t1 - t0;

  auto issue = [&](int i) {                // key tile t0 + i into its stage
    unsigned char* st = ring + (i % kStages) * 2 * kTileBytes;
    uint64_t* bar = full + i % kStages;
    const int k0 = (t0 + i) * kTile;
    hopper::mbar_expect_tx(bar, 2 * kTileBytes);
    load_rows(st, &tk, bar, k0, hk);
    load_rows(st + kTileBytes, &tv, bar, k0, hk);
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(full + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(kStages, items); ++i) issue(i);
  }

  // this thread's Q fragments: k step kk, pair e at row qrow + 8 (e & 1),
  // columns 16 kk + 8 (e >> 1) + 2 t (the register A operand's layout);
  // rows past s are 0
  const int qrow = q0 + warp * 16 + g;       // queries qrow, qrow + 8
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = qrow + 8 * (e & 1);
    const __nv_bfloat16* src = q + (static_cast<int64_t>(bh) * s + row) * kD +
                               8 * (e >> 1) + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qa[kk][e] = row < s ? *reinterpret_cast<const uint32_t*>(src + 16 * kk)
                          : 0u;
    }
  }

  // the keys [lo, hi] each of this thread's two rows sees (visible()), and
  // the keys [wlo, whi] every row of the tile sees: a key tile inside the
  // latter needs no mask
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = causal ? min(qrow + 8 * r, s - 1) : s - 1;
    lo[r] = window > 0 ? qrow + 8 * r - window + 1 : 0;
  }
  const int whi = causal ? min(q0, s - 1) : s - 1;
  const int wlo = window > 0 ? q0 + kTile - window : 0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};   // this thread's columns only; summed over
                                 // the quad at the end
  for (int i = 0; i < items; ++i) {
    const unsigned char* ks = ring + (i % kStages) * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    const int k0 = (t0 + i) * kTile;
    hopper::mbar_wait(full + i % kStages, (i / kStages) & 1);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(qa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {      // S = Q K^T
      hopper::wgmma_m64n64k16_rs(sc, qa[kk], kmajor(ks, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(qa);

    // mask (only a tile that crosses the diagonal, the window's lower edge
    // or the ragged tail needs one), the running max of the raw scores over
    // the quad that shares a row
    const bool whole = k0 >= wlo && k0 + kTile - 1 <= whi;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      const int key = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
      if (!whole && (key < lo[r] || key > hi[r])) sc[x] = -INFINITY;
      mx[r] = fmaxf(mx[r], sc[x]);
    }
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m_run[r] - mx[r]) * scale_log2);
      m_run[r] = mx[r];
      mc[r] = mx[r] * scale_log2;
      l_run[r] *= corr[r];
    }
    // p = exp(s scale - m scale) = 2^(s c - m c), c = scale log2e, one FMA
    // and one ex2 a score (0 where masked); l from the f32 p; P as the bf16
    // register A operand of the PV product
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      sc[x] = ex2(fmaf(sc[x], scale_log2, -mc[r]));
      l_run[r] += sc[x];
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] *= corr[(x >> 1) & 1];
    uint32_t pa[4][4];
    hopper::acc_to_a(pa, sc);
    hopper::fence_regs(pa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {   // O += P V
      hopper::wgmma_m64n128k16_rs_tb(acc, pa[kk], mnmajor(vs, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);

    __syncthreads();                         // the stage's readers are done
    if (tid == 0 && i + kStages < items) issue(i + kStages);
  }

  const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = qrow + r * 8;
    if (row >= s) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* out = o + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
    }
    if (t == 0) {
      lse[static_cast<int64_t>(bh) * s + row] =
          m_run[r] * scale_log2 * kLn2 + logf(l);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           long long bh, int group, int s, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap tk, tv;
  int rc = hopper::tensor_map_bf16(&tk, k, kD, s, bh / group, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&tv, v, kD, s, bh / group, kTile);
  if (rc == 0) rc = set_smem(flash_fwd_wgmma_kernel, kSmem);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>(bh), (s + kTile - 1) / kTile);
  flash_fwd_wgmma_kernel<<<grid, kThreadsWg, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), tk, tv,
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), s, group,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 at D = 256 on wgmma: two consumer warpgroups and a producer
// ---------------------------------------------------------------------------

namespace wg256 {

using hopper::ex2;
using hopper::wg::aligned_shared;
using hopper::wg::kmajor;
using hopper::wg::kTile;
using hopper::wg::load_rows;
using hopper::wg::mnmajor;
using wg::kLn2;

constexpr int kH = 4;                               // 64-column halves
constexpr int kD = 64 * kH;
constexpr int kTileBytes = hopper::wg::tile_bytes<kH>();   // [64, 256]: 32 KB
constexpr int kConsumers = 256;                     // two warpgroups
constexpr int kThreads256 = kConsumers + 128;       // and the producer
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 2;                          // the copy ring of K, V
constexpr size_t kSmem = 1024 + 2 * kTileBytes + kStages * 2 * kTileBytes +
                         64;                        // 193 KB: one block an SM

// One block per (KV head, pair of its query heads, 64-query tile). The two
// heads of a pair walk the same key band, so each K, V tile that the
// producer warpgroup brings in feeds both consumer warpgroups, one head
// each (an odd group leaves the last pair's second warpgroup idle: it only
// paces the ring). A warpgroup keeps its Q tile in shared memory (S = Q K^T as SS
// m64n64k16, 16 k steps: Q as a register A operand would cost 64 registers
// beside O's 128) and P from S's accumulator goes straight into O += P V
// (RS m64n256k16, V read MN-major). The producer keeps kStages tiles in
// flight: it refills a stage once all 256 consumer threads have released it
// (the empty barrier), so copies overlap both warpgroups' products. Masking
// and the online softmax are the D = 128 kernel's.
__global__ void __launch_bounds__(kThreads256, 1)
    flash_fwd_wgmma256_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int s, int group,
                              int pairs, int causal, int window,
                              float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = aligned_shared(smem_raw);     // a Q tile a warpgroup
  unsigned char* ring = qs + 2 * kTileBytes;        // K, V a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 *
                                               kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // pairs fastest: the last query tiles of every head, which visit the most
  // causal key tiles, start first
  const int nq = (s + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int hk = static_cast<int>(blockIdx.x) / pairs;
  const int h0 = 2 * (static_cast<int>(blockIdx.x) % pairs);
  const int nheads = min(2, group - h0);
  int t0, t1;
  key_tiles(q0, min(q0 + kTile, s), s, kTile, causal, window, &t0, &t1);
  const int items = t1 - t0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {             // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      hopper::mbar_expect_tx(q_bar, nheads * kTileBytes);
      for (int c = 0; c < nheads; ++c) {
        load_rows<kH>(qs + c * kTileBytes, &tq, q_bar, q0,
                      hk * group + h0 + c);
      }
      for (int i = 0; i < items; ++i) {
        const int st = i % kStages;
        if (i >= kStages) hopper::mbar_wait(empty + st, (i / kStages - 1) & 1);
        unsigned char* ks = ring + st * 2 * kTileBytes;
        const int k0 = (t0 + i) * kTile;
        hopper::mbar_expect_tx(full + st, 2 * kTileBytes);
        load_rows<kH>(ks, &tk, full + st, k0, hk);
        load_rows<kH>(ks + kTileBytes, &tv, full + st, k0, hk);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wgi = warp >> 2;                        // this warpgroup's head
  const bool active = wgi < nheads;
  const int bh = hk * group + h0 + wgi;
  const unsigned char* qt = qs + wgi * kTileBytes;
  const int g = lane >> 2, t = lane & 3;
  const int qrow = q0 + (warp & 3) * 16 + g;        // queries qrow, qrow + 8
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = causal ? min(qrow + 8 * r, s - 1) : s - 1;
    lo[r] = window > 0 ? qrow + 8 * r - window + 1 : 0;
  }
  const int whi = causal ? min(q0, s - 1) : s - 1;
  const int wlo = window > 0 ? q0 + kTile - window : 0;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};
  hopper::mbar_wait(q_bar, 0);
  for (int i = 0; i < items; ++i) {
    const int st = i % kStages;
    const unsigned char* ks = ring + st * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    const int k0 = (t0 + i) * kTile;
    hopper::mbar_wait(full + st, (i / kStages) & 1);
    if (active) {
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {        // S = Q K^T
        hopper::wgmma_m64n64k16_ss(sc, kmajor(qt, kk), kmajor(ks, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      const bool whole = k0 >= wlo && k0 + kTile - 1 <= whi;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        const int key = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
        const bool in = whole | ((key >= lo[r]) & (key <= hi[r]));
        sc[x] = in ? sc[x] : -INFINITY;          // a select, no branch
        mx[r] = fmaxf(mx[r], sc[x]);
      }
      float corr[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m_run[r] - mx[r]) * scale_log2);
        m_run[r] = mx[r];
        mc[r] = mx[r] * scale_log2;
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        sc[x] = ex2(fmaf(sc[x], scale_log2, -mc[r]));
        l_run[r] += sc[x];
      }
#pragma unroll
      for (int x = 0; x < 128; ++x) acc[x] *= corr[(x >> 1) & 1];
      uint32_t pa[4][4];
      hopper::acc_to_a(pa, sc);
      hopper::fence_regs(pa);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {     // O += P V
        hopper::wgmma_m64n256k16_rs_tb(acc, pa[kk], mnmajor(vs, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
    }
    hopper::mbar_arrive(empty + st);                // the stage is read
  }
  if (!active) return;

  const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = qrow + r * 8;
    if (row >= s) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* out = o + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
    }
    if (t == 0) {
      lse[static_cast<int64_t>(bh) * s + row] =
          m_run[r] * scale_log2 * kLn2 + logf(l);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           long long bh, int group, int s, int causal, int window,
           float scale, cudaStream_t stream) {
  const long long bkv = bh / group;
  const int pairs = (group + 1) / 2;
  CUtensorMap tq, tk, tv;
  int rc = hopper::tensor_map_bf16(&tq, q, kD, s, bh, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&tk, k, kD, s, bkv, kTile);
  if (rc == 0) rc = hopper::tensor_map_bf16(&tv, v, kD, s, bkv, kTile);
  if (rc == 0) rc = set_smem(flash_fwd_wgmma256_kernel, kSmem);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>(bkv * pairs), (s + kTile - 1) / kTile);
  flash_fwd_wgmma256_kernel<<<grid, kThreads256, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      s, group, pairs, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg256

// ---------------------------------------------------------------------------
// bf16 at D = 64 on wgmma: two consumer warpgroups and a producer
// ---------------------------------------------------------------------------

namespace wg64 {

using hopper::ex2;
using hopper::wg::aligned_shared;
using hopper::wg::kmajor;
using hopper::wg::load_rows;
using hopper::wg::mnmajor;
using wg::kLn2;

constexpr int kD = 64;
constexpr int kWgs = 3;                             // consumer warpgroups
constexpr int kBq = 64 * kWgs;                      // queries a block: 192
constexpr int kBk = 128;                            // keys a streamed tile
constexpr int kQBytes = 64 * 128;                   // a warpgroup's Q tile
constexpr int kKvBytes = kBk * 128;                 // [128, 64] swizzled: 16 KB
constexpr int kConsumers = 128 * kWgs;
constexpr int kThreads64 = kConsumers + 128;        // and the producer
// launched at 128 registers a thread (512 threads): the producer drops to
// 24, which frees 32 more for each consumer thread
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
constexpr int kStages = 4;                          // the copy ring of K, V
constexpr size_t kSmem = 1024 + kWgs * kQBytes + kStages * 2 * kKvBytes +
                         128;                       // 153 KB

// One block per (query head, 192-query tile): each of three consumer
// warpgroups owns 64 of the queries, with its Q tile in shared memory, and
// all three share the band's 128-key K and V tiles, which the producer
// warpgroup streams through a ring of kStages stages (a stage is refilled
// once all consumer threads have released it). S = Q K^T is one m64n128k16
// product over D (4 k steps, both operands K-major in shared memory), O +=
// P V eight m64n64k16 steps with P from S's registers and V read MN-major.
// At D = 64 the ex2 of the softmax costs about as much as the two products,
// so the products of one warpgroup have to run under the softmax of
// another: a warpgroup issues tile j's S and tile j - 1's PV together,
// waits for both, then runs tile j's softmax, rescales O and converts P,
// while the other two warpgroups' products occupy the tensor cores. (A
// warpgroup that also overlaps its own softmax with its PV, two warpgroups
// with Q in registers, explicit ping-pong turns and a second S buffer were
// each slower on the H100.) Three warpgroups need Q out of the
// registers: 64 of S, 32 of P and 32 of O fit the 160 a consumer gets. A
// warpgroup walks only the key tiles its own queries see, and releases the
// others untouched. Masking and the online softmax are the D = 128
// kernel's.
__global__ void __launch_bounds__(kThreads64, 1)
    flash_fwd_wgmma64_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int s, int group,
                             int causal, int window, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = aligned_shared(smem_raw);     // Q a warpgroup
  unsigned char* ring = qs + kWgs * kQBytes;        // K, V a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 *
                                               kKvBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // heads fastest: the last query tiles of every head, which visit the
  // most causal key tiles, start first
  const int nq = (s + kBq - 1) / kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBq;
  const int bh = blockIdx.x;
  int t0, t1;
  key_tiles(q0, min(q0 + kBq, s), s, kBk, causal, window, &t0, &t1);
  const int items = t1 - t0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {             // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      const int hk = bh / group;
      hopper::mbar_expect_tx(q_bar, kWgs * kQBytes);
      for (int w = 0; w < kWgs; ++w) {
        load_rows<1>(qs + w * kQBytes, &tq, q_bar, q0 + 64 * w, bh);
      }
      for (int i = 0; i < items; ++i) {
        const int st = i % kStages;
        if (i >= kStages) hopper::mbar_wait(empty + st, (i / kStages - 1) & 1);
        unsigned char* ks = ring + st * 2 * kKvBytes;
        const int k0 = (t0 + i) * kBk;
        hopper::mbar_expect_tx(full + st, 2 * kKvBytes);
        load_rows<1>(ks, &tk, full + st, k0, hk);         // 128-row boxes
        load_rows<1>(ks + kKvBytes, &tv, full + st, k0, hk);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // the warpgroup's index, read from lane 0 so that the compiler knows it
  // is the same in every thread of a warp: the branches that depend on it
  // (the warpgroup's range of items, its masks) then do not count as
  // divergent, and ptxas keeps the wgmma products asynchronous rather than
  // serialising them
  const int wgi = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * wgi;                    // this warpgroup's queries
  const int qrow = qw0 + (warp & 3) * 16 + g;       // queries qrow, qrow + 8
  // the block's items [a, b) that this warpgroup's queries see
  int a = 0, b = 0;
  if (qw0 < s) {
    int w0, w1;
    key_tiles(qw0, min(qw0 + 64, s), s, kBk, causal, window, &w0, &w1);
    a = w0 - t0;
    b = w1 - t0;
  }
  const unsigned char* qt = qs + wgi * kQBytes;
  hopper::mbar_wait(q_bar, 0);
  // the keys [lo, hi] each of this thread's two rows sees (visible()), and
  // the keys [wlo, whi] every row of the warpgroup sees: a key tile inside
  // the latter needs no mask
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = causal ? min(qrow + 8 * r, s - 1) : s - 1;
    lo[r] = window > 0 ? qrow + 8 * r - window + 1 : 0;
  }
  const int whi = causal ? min(qw0, s - 1) : s - 1;
  const int wlo = window > 0 ? qw0 + 64 - window : 0;

  float sc[64];           // S of the newest tile, then its f32 p
  uint32_t pa[8][4];      // p of the tile before, the PV product's A
  float acc[32];          // O
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};   // this thread's columns only; summed over
                                 // the quad at the end
  float corr[2];
  auto stage = [&](int i) { return ring + (i % kStages) * 2 * kKvBytes; };
  auto release = [&](int i) { hopper::mbar_arrive(empty + i % kStages); };
  auto issue_s = [&](int i) {                       // S = Q K^T of item i
    const unsigned char* ks = stage(i);
    hopper::mbar_wait(full + i % kStages, (i / kStages) & 1);
    hopper::wgmma_fence();
    hopper::wgmma_m64n128k16_ss_z(sc, kmajor(qt, 0), kmajor(ks, 0));
#pragma unroll
    for (int kk = 1; kk < kD / 16; ++kk) {
      hopper::wgmma_m64n128k16_ss(sc, kmajor(qt, kk), kmajor(ks, kk), 1);
    }
    hopper::wgmma_commit();
  };
  auto issue_pv = [&](int i) {                      // O += P V of item i
    const unsigned char* vs = stage(i) + kKvBytes;
    hopper::fence_regs(pa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      hopper::wgmma_m64n64k16_rs_tb(acc, pa[kk], mnmajor(vs, kk), 1);
    }
    hopper::wgmma_commit();
  };
  // mask (only a tile that crosses the diagonal, the window's lower edge or
  // the ragged tail needs one), the running max of the raw scores over the
  // quad that shares a row, then p = 2^(s c - m c), c = scale log2e, one
  // FMA and one ex2 a score (0 where masked), and l from the f32 p
  auto softmax = [&](int i) {
    const int k0 = (t0 + i) * kBk;
    if (k0 < wlo || k0 + kBk - 1 > whi) {
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        const int r = (x >> 1) & 1;
        const int key = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
        sc[x] = (key >= lo[r]) & (key <= hi[r]) ? sc[x] : -INFINITY;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m_run[r] - mx[r]) * scale_log2);
      m_run[r] = mx[r];
      mc[r] = mx[r] * scale_log2;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      const int r = (x >> 1) & 1;
      sc[x] = ex2(fmaf(sc[x], scale_log2, -mc[r]));
      l_run[r] += sc[x];
    }
  };

  for (int i = 0; i < a; ++i) {              // tiles only the other sees
    hopper::mbar_wait(full + i % kStages, (i / kStages) & 1);
    release(i);
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  if (a < b) {
    issue_s(a);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax(a);                              // O is 0: nothing to rescale
    hopper::acc_to_a128(pa, sc);
    // tile i's S and tile i - 1's PV go to the tensor cores together and
    // are waited for together; one warpgroup's softmax runs under the
    // others' products
    for (int i = a + 1; i < b; ++i) {
      issue_s(i);
      issue_pv(i - 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      release(i - 1);
      softmax(i);
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x] *= corr[(x >> 1) & 1];
      hopper::acc_to_a128(pa, sc);
    }
    issue_pv(b - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    release(b - 1);
  }
  for (int i = b; i < items; ++i) {
    hopper::mbar_wait(full + i % kStages, (i / kStages) & 1);
    release(i);
  }

  const int64_t qoff = static_cast<int64_t>(bh) * s * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = qrow + r * 8;
    if (row >= s) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* out = o + qoff + static_cast<int64_t>(row) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
    }
    if (t == 0) {
      lse[static_cast<int64_t>(bh) * s + row] =
          m_run[r] * scale_log2 * kLn2 + logf(l);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           long long bh, int group, int s, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = hopper::tensor_map_bf16(&tq, q, kD, s, bh, 64);
  if (rc == 0) rc = hopper::tensor_map_bf16(&tk, k, kD, s, bh / group, kBk);
  if (rc == 0) rc = hopper::tensor_map_bf16(&tv, v, kD, s, bh / group, kBk);
  if (rc == 0) rc = set_smem(flash_fwd_wgmma64_kernel, kSmem);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>(bh), (s + kBq - 1) / kBq);
  flash_fwd_wgmma64_kernel<<<grid, kThreads64, kSmem, stream>>>(
      tq, tk, tv,
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), s, group,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg64

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, long long bh, int group, int s, int causal,
               int window, float scale, cudaStream_t stream) {
  using T = MmaTile<D>;
  const int rc = set_smem(flash_fwd_mma_kernel<D>, T::kSmem);
  if (rc != 0) return rc;
  const dim3 grid((s + T::kBq - 1) / T::kBq, static_cast<unsigned>(bh));
  flash_fwd_mma_kernel<D><<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s, group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, long long bh, int group, int s, int causal,
               int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  const int rc = set_smem(flash_fwd_f32_kernel<D>, smem);
  if (rc != 0) return rc;
  const dim3 grid((s + kF32Bq - 1) / kF32Bq, static_cast<unsigned>(bh));
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s, group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* lse, long long bh, int group, int s, int causal, int window,
           float scale, cudaStream_t stream) {
  if (dtype == 2) {
    if constexpr (D == wg::kD) {
      return wg::launch(q, k, v, o, lse, bh, group, s, causal, window, scale,
                        stream);
    } else if constexpr (D == wg256::kD) {
      return wg256::launch(q, k, v, o, lse, bh, group, s, causal, window,
                           scale, stream);
    } else if constexpr (D == wg64::kD) {
      return wg64::launch(q, k, v, o, lse, bh, group, s, causal, window,
                          scale, stream);
    } else {
      return launch_mma<D>(q, k, v, o, lse, bh, group, s, causal, window,
                           scale, stream);
    }
  }
  if (dtype == 0) {
    return launch_f32<D>(q, k, v, o, lse, bh, group, s, causal, window,
                         scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o [bh, s, d]; k, v [bkv, s, d]; lse [bh, s] f32; all contiguous.
// dtype: 0 = float32, 2 = bfloat16 (q, k, v and o share it). window <= 0:
// no window. d in {16, 32, 64, 96, 128, 256}.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int dtype, long long bh,
                               long long bkv, int s, int d, int causal,
                               int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bkv <= 0 || bh % bkv != 0 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s == 0) return static_cast<int>(cudaGetLastError());
  const int group = static_cast<int>(bh / bkv);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, o, lse, bh, group, s, causal, window, scale, st);
    case 32: return launch<32>(dtype, q, k, v, o, lse, bh, group, s, causal, window, scale, st);
    case 64: return launch<64>(dtype, q, k, v, o, lse, bh, group, s, causal, window, scale, st);
    case 96: return launch<96>(dtype, q, k, v, o, lse, bh, group, s, causal, window, scale, st);
    case 128: return launch<128>(dtype, q, k, v, o, lse, bh, group, s, causal, window, scale, st);
    case 256: return launch<256>(dtype, q, k, v, o, lse, bh, group, s, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

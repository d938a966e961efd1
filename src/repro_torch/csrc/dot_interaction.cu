// K2 interaction_fwd: DLRM pairwise dot interaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dot_interaction.py::
// interaction_fwd (_fwd_kernel). That kernel computed the whole F x F Gram
// matrix per sample on the matrix unit and compacted its lower triangle with
// a second matmul against a constant 0/1 selection matrix [F*F, P], because a
// TPU dislikes gathers. Here the Gram's lower triangle is cut into 4 x 4
// register tiles and each entry goes straight to its triangle index: no
// selection matrix, and of the upper triangle only the diagonal tiles' spare
// entries are computed.
//
// What bounds it: memory. Per sample it reads F*D floats and writes P floats
// (P = F(F-1)/2, or F(F+1)/2 with the diagonal), and does 2*P*D flops on
// them; at F=27, D=128 that is 13.8 KB read for 90 KFLOP, about 6.5 flops a
// byte, far below the card's ridge point; over a batch of 4096, 62 MB, 0.019
// ms at 3.35 TB/s. It stays on the CUDA cores: the products are f32, and
// TF32 tensor cores would break the 1e-5 agreement with the reference, while
// the f32 FMAs (184 M at B = 4096, ~0.006 ms) are not what bounds it. The
// trap is shared memory: one thread a pair, reading x[i, d] and x[j, d] for
// every FMA, moves 1.5 GB of shared-memory loads at B = 4096, more than the
// HBM traffic costs.
//
// Design: a thread item (tile, slice) owns the 16 entries of one 4 x 4 tile
// (rows i of tile row I, rows j of tile column J <= I; 28 tiles at F = 27)
// over one of 8 slices of D: slice s takes the column quads q = s, s + 8,
// ..., so the 8 lanes of a tile read 32 consecutive floats of a row in one
// load phase (no bank conflicts whatever the row stride). Per quad a thread
// reads x[i, 4q:4q+4] and x[j, 4q:4q+4] of its 4 + 4 rows as float4 loads:
// 8 vector loads feed 64 FMAs. The 8 slices' partial tiles are then summed
// by a three-step shuffle reduce-scatter (xor 4, 2, 1; 14 shuffles a
// thread), after which lane s holds entries 2s and 2s + 1 of the tile, in
// a fixed order of adds: no atomics, the same bits on every run. A map the
// block builds once sends each (tile, entry) to its triangle index p in
// np.tril_indices order, or to nothing (above the diagonal, past F); no
// square roots. Blocks fill the card once and walk the batch; while a block
// computes one sample, the next one's x[b] is in flight into the other of
// two buffers (16-byte cp.async). A sample's P outputs are gathered in
// shared memory and leave as 16-byte stores where they are aligned, with
// scalar stores at the row's ragged ends. f32 x with D a multiple of 4 and
// a 16-byte-aligned x takes the cp.async path; any other x is staged
// element by element (columns padded to a quad with zeros).
//
// K4 interaction_bwd: the adjoint, replacing repro/kernels/dot_interaction.py
// ::interaction_bwd (_bwd_kernel). There the TPU scattered dtri into the F x F
// Gram gradient G with a second selection matmul, symmetrized it and took
// dx = (G + G^T) x on the matrix unit. Here S = G + G^T is built in shared
// memory straight from the triangle: S[i, j] = dtri[p(i, j)] below the
// diagonal, dtri[p(j, i)] above it and, with self_interaction, 2 dtri[p(i,
// i)] on it (the symmetrization doubles the diagonal, which is d(x.x)/dx),
// through an (i, j) -> p map each block computes once. dx[i, d] = sum_j S[i,
// j] x[j, d] in f32, in order of j, written in x's type.
//
// What bounds it: memory. Per sample it reads F*D values of x and P floats
// of dtri and writes F*D values of dx, for 2*F*F*D flops: at F = 27, D = 128,
// f32, that is 29 KB for 187 KFLOP, about 6.4 flops a byte; over a batch of
// 4096, 119 MB, 0.036 ms at 3.35 TB/s. A design that reads S[i, j] and x[j,
// d] from shared memory for every FMA (one thread an output) is bound by
// shared-memory bandwidth instead: 7.6e8 four-byte loads at 4096 x 27 x 128.
//
// Design: a thread owns one column quad (a float4 of x[j, d:d+4]; a warp
// covers D = 128) and 8 rows i of dx[b], and S is stored transposed, S^T[j,
// i], so that per j it reads x[j, d:d+4] once and its 8 rows of S^T as two
// broadcast float4 loads, for 32 FMAs. Blocks fill the card once and walk
// the batch; while a block computes one sample, the next one's x[b] and
// dtri[b] are in flight into the other of two buffers (16-byte cp.async for
// x, 4-byte for dtri, both coalesced), so loads overlap FMAs and there is
// no tail of one-sample blocks. dx goes out in 16-byte stores. Each output
// is one thread's sum in a fixed order: no atomics, the same bits on every
// run. f32 x with D a multiple of 4 takes the 16-byte path; bf16 x or any
// other D is staged element by element as f32 and written so.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;           // K4's block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The number of blocks of `kernel` that fit on the card at once, at most
// `batch`: each then walks its samples b = blockIdx.x, + gridDim.x, ...
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                          int64_t batch, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  *grid = static_cast<unsigned>(std::min<int64_t>(
      batch, static_cast<int64_t>(sms) * std::max(per_sm, 1)));
  return err;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

constexpr int kFwdSlices = 8;         // lanes that split one tile's D
constexpr int kFwdMaxThreads = 256;
constexpr int kFwdMinBlocks = 4;      // blocks an SM (caps the registers)

// The forward's shared-memory layout in floats, for F, D and P: x[b] twice
// (f32, F padded to whole tiles of 4 rows with zero rows, D to whole
// quads), the outputs twice (P + 3 floats, so that a sample's row can start
// at any of the four positions of a 16-byte group, padded to a quad), the
// tile map (tile -> I << 16 | J) and the entry map (tile, entry -> p or -1).
struct FwdLayout {
  int fp, dp, tiles, pp;
  __host__ __device__ FwdLayout(int f, int dim, int pairs)
      : fp((f + 3) & ~3), dp((dim + 3) & ~3),
        tiles((fp / 4) * (fp / 4 + 1) / 2), pp((pairs + 6) & ~3) {}
  __host__ __device__ int xs(int buf) const { return buf * fp * dp; }
  __host__ __device__ int os(int buf) const { return 2 * fp * dp + buf * pp; }
  __host__ __device__ int tmap() const { return os(2); }
  __host__ __device__ int pmap() const { return tmap() + tiles; }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(pmap() + 16 * tiles) * 4;
  }
  __host__ __device__ int items() const { return tiles * kFwdSlices; }
  // whole warps, so that every lane of a warp reaches the shuffles
  __host__ __device__ int threads() const {
    const int t = (items() + 31) & ~31;
    return t < kFwdMaxThreads ? t : kFwdMaxThreads;
  }
};

// Each block walks samples b = blockIdx.x, + gridDim.x, ...; while it
// computes one, the next one's x[b] is in flight into the other buffer.
// Thread item (tile, s) sums its tile's 16 entries over column quads q = s,
// s + 8, ...; the tile's 8 lanes then reduce-scatter them. kVec: x is f32
// with D a multiple of 4 and 16-byte aligned (16-byte cp.async); otherwise
// x is staged element by element.
template <bool kVec>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks)
    interaction_fwd_kernel(const float* __restrict__ x,
                           float* __restrict__ out, long long batch, int f,
                           int dim, int pairs, int self_interaction) {
  extern __shared__ __align__(16) float smem[];
  const FwdLayout lay(f, dim, pairs);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nq = lay.dp / 4;
  const int items = lay.items();
  int* tmap = reinterpret_cast<int*>(smem + lay.tmap());
  int* pmap = reinterpret_cast<int*>(smem + lay.pmap());

  // tile t = I(I+1)/2 + J (J <= I); entry e is (i, j) = (4I + e / 4, 4J +
  // e % 4), sent to p = i(i-1)/2 + j (j < i), or i(i+1)/2 + j (j <= i)
  // under self_interaction
  for (int t = tid; t < lay.tiles; t += nthr) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int tj = t - ti * (ti + 1) / 2;
    tmap[t] = ti << 16 | tj;
    for (int e = 0; e < 16; ++e) {
      const int i = 4 * ti + (e >> 2), j = 4 * tj + (e & 3);
      int p = -1;
      if (i < f && (j < i || (self_interaction && j == i))) {
        p = (self_interaction ? i * (i + 1) / 2 : i * (i - 1) / 2) + j;
      }
      pmap[16 * t + e] = p;
    }
  }
  // the pad rows of both buffers stay zero
  for (int e = tid; e < (lay.fp - f) * lay.dp; e += nthr) {
    smem[lay.xs(0) + f * lay.dp + e] = 0.f;
    smem[lay.xs(1) + f * lay.dp + e] = 0.f;
  }

  auto stage = [&](long long b, int buf) {
    float* xd = smem + lay.xs(buf);
    const float* xb = x + b * f * dim;
    if constexpr (kVec) {
      for (int e = tid; e < f * nq; e += nthr) {
        cp_async16(xd + 4 * e, xb + 4 * e);
      }
    } else {
      for (int e = tid; e < f * lay.dp; e += nthr) {
        const int r = e / lay.dp, c = e - r * lay.dp;
        xd[e] = c < dim ? xb[r * dim + c] : 0.f;
      }
    }
    cp_async_commit();
  };

  const int s = tid & (kFwdSlices - 1);
  const bool h4 = s & 4, h2 = s & 2, h1 = s & 1;
  long long b = blockIdx.x;
  if (b < batch) stage(b, 0);
  for (int it = 0; b < batch; ++it, b += gridDim.x) {
    const int cur = it & 1;
    if (b + gridDim.x < batch) {
      // the buffer the last sample was read from: every thread is past
      // that sample's second barrier
      stage(b + gridDim.x, cur ^ 1);
    } else {
      cp_async_commit();                     // keeps one group a sample
    }
    cp_async_wait_prior();
    __syncthreads();                         // sample b has landed

    float* ob = out + b * pairs;
    // where the row starts in its 16-byte group: the staged outputs keep
    // that offset, so that whole groups leave as one float4 each
    const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(ob) >> 2 & 3);
    float* os = smem + lay.os(cur);
    const float* xc = smem + lay.xs(cur);
    for (int base = 0; base < items; base += nthr) {
      const int item = base + tid;
      const int tile = item < items ? item / kFwdSlices : 0;
      const int code = tmap[tile];
      const float* xi = xc + 4 * (code >> 16) * lay.dp;
      const float* xj = xc + 4 * (code & 0xffff) * lay.dp;
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.f;
#pragma unroll 1
      for (int q = s; q < nq; q += kFwdSlices) {
        float4 a[4], c[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = *reinterpret_cast<const float4*>(xi + r * lay.dp + 4 * q);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          c[r] = *reinterpret_cast<const float4*>(xj + r * lay.dp + 4 * q);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float v = acc[4 * r + k];
            v = fmaf(a[r].x, c[k].x, v);
            v = fmaf(a[r].y, c[k].y, v);
            v = fmaf(a[r].z, c[k].z, v);
            v = fmaf(a[r].w, c[k].w, v);
            acc[4 * r + k] = v;
          }
        }
      }
      // reduce-scatter over the tile's 8 lanes: after the xor-4 step a
      // lane holds entries 8 h4 + k, after xor 2 8 h4 + 4 h2 + k, after
      // xor 1 entries 2s and 2s + 1
      float v8[8], v4[4], v2[2];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float send = h4 ? acc[k] : acc[k + 8];
        const float keep = h4 ? acc[k + 8] : acc[k];
        v8[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float send = h2 ? v8[k] : v8[k + 4];
        const float keep = h2 ? v8[k + 4] : v8[k];
        v4[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float send = h1 ? v4[k] : v4[k + 2];
        const float keep = h1 ? v4[k + 2] : v4[k];
        v2[k] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      if (item < items) {
        const int p0 = pmap[16 * tile + 2 * s];
        const int p1 = pmap[16 * tile + 2 * s + 1];
        if (p0 >= 0) os[sh + p0] = v2[0];
        if (p1 >= 0) os[sh + p1] = v2[1];
      }
    }
    __syncthreads();                         // x[b] is read, os is full

    // 16-byte group g of the staged row is out[b] - sh + 4g .. + 4
    float* og = ob - sh;
    const int groups = (sh + pairs + 3) >> 2;
    for (int g = tid; g < groups; g += nthr) {
      const float4 val = *reinterpret_cast<const float4*>(os + 4 * g);
      const int e0 = 4 * g - sh;
      if (e0 >= 0 && e0 + 4 <= pairs) {
        *reinterpret_cast<float4*>(og + 4 * g) = val;
      } else {
        const float w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e0 + u >= 0 && e0 + u < pairs) og[4 * g + u] = w[u];
        }
      }
    }
  }
}

template <bool kVec>
int launch_fwd(const void* x, void* out, int64_t batch, int f, int dim,
               int pairs, int self_interaction, cudaStream_t stream) {
  const FwdLayout lay(f, dim, pairs);
  const size_t smem = lay.bytes();
  auto kernel = interaction_fwd_kernel<kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0 && pairs > 0) {
    unsigned grid = 0;
    err = resident_grid(kernel, lay.threads(), smem, batch, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, lay.threads(), smem, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(out), batch, f, dim,
        pairs, self_interaction);
  }
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kBwdRows = 8;   // rows of dx a thread holds, one column quad

// the backward's shared-memory layout in floats, for F and D: x[b] twice
// (f32, rows padded to whole quads), dtri[b] twice, S^T with each row i
// padded to whole groups of kBwdRows, and the (j, i) -> dtri code map
struct BwdLayout {
  int dp, rp, pp, f;
  __host__ __device__ BwdLayout(int f_, int dim, int pairs)
      : dp((dim + 3) & ~3), rp((f_ + kBwdRows - 1) / kBwdRows * kBwdRows),
        pp((pairs + 3) & ~3), f(f_) {}
  __host__ __device__ int xs(int buf) const { return buf * f * dp; }
  __host__ __device__ int db(int buf) const { return 2 * f * dp + buf * pp; }
  __host__ __device__ int st() const { return 2 * f * dp + 2 * pp; }
  __host__ __device__ int pmap() const { return st() + f * rp; }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(pmap() + f * rp) * 4;
  }
};

// Each block walks samples b = blockIdx.x, + gridDim.x, ...; while it
// computes one, the next one's x[b] and dtri[b] are in flight into the
// other buffer (cp.async). Thread item (c, g) owns column quad c and rows
// [8g, 8g + 8) of dx[b]: per j it reads x[b][j, 4c:4c+4] once and S^T[j,
// 8g:8g+8] as two broadcast float4 loads, for 32 FMAs. kVec: f32 x and dx
// with D a multiple of 4, 16-byte aligned (16-byte copies and stores);
// otherwise x is staged element by element as f32 and dx is written so.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    interaction_bwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ dtri, T* __restrict__ dx,
                           long long batch, int f, int dim, int pairs,
                           int self_interaction) {
  extern __shared__ __align__(16) float smem[];
  const BwdLayout lay(f, dim, pairs);
  const int tid = threadIdx.x;
  const int nqd = lay.dp / 4;                // column quads
  const int items = nqd * (lay.rp / kBwdRows);
  float* st = smem + lay.st();
  int* pmap = reinterpret_cast<int*>(smem + lay.pmap());

  // S^T[j, i] = code c: dtri[c >> 1], doubled when c is odd (the diagonal
  // under self_interaction); -1: 0 (the diagonal without it, padding rows)
  for (int e = tid; e < f * lay.rp; e += kThreads) {
    const int j = e / lay.rp, i = e - j * lay.rp;
    int code = -1;
    if (i < f && i != j) {
      const int hi = max(i, j), lo = min(i, j);
      code = 2 * ((self_interaction ? hi * (hi + 1) : hi * (hi - 1)) / 2 + lo);
    } else if (i < f && self_interaction) {
      code = 2 * (i * (i + 1) / 2 + i) + 1;
    }
    pmap[e] = code;
  }

  auto stage = [&](long long b, int buf) {
    float* xd = smem + lay.xs(buf);
    const T* xb = x + b * f * dim;
    if constexpr (kVec) {
      for (int e = tid; e < f * nqd; e += kThreads) {
        cp_async16(xd + 4 * e, xb + 4 * e);
      }
    } else {
      for (int e = tid; e < f * dim; e += kThreads) {
        const int r = e / dim;
        xd[r * lay.dp + (e - r * dim)] = to_f32(xb[e]);
      }
    }
    float* dd = smem + lay.db(buf);
    const float* src = dtri + b * pairs;
    for (int e = tid; e < pairs; e += kThreads) cp_async4(dd + e, src + e);
    cp_async_commit();
  };

  long long b = blockIdx.x;
  if (b < batch) stage(b, 0);
  for (int it = 0; b < batch; ++it, b += gridDim.x) {
    const int cur = it & 1;
    if (b + gridDim.x < batch) {
      stage(b + gridDim.x, cur ^ 1);
    } else {
      cp_async_commit();                     // keeps one group a sample
    }
    cp_async_wait_prior();
    __syncthreads();                         // sample b has landed
    const float* dd = smem + lay.db(cur);
    for (int e = tid; e < f * lay.rp; e += kThreads) {
      const int code = pmap[e];
      st[e] = code < 0 ? 0.f : ((code & 1) ? 2.f : 1.f) * dd[code >> 1];
    }
    __syncthreads();

    const float* xc = smem + lay.xs(cur);
    T* ob = dx + b * f * dim;
    for (int item = tid; item < items; item += kThreads) {
      const int c = item % nqd;
      const int r0 = (item / nqd) * kBwdRows;
      float4 acc[kBwdRows];
#pragma unroll
      for (int k = 0; k < kBwdRows; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 3
      for (int j = 0; j < f; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xc + j * lay.dp +
                                                           4 * c);
        const float4 s0 = *reinterpret_cast<const float4*>(st + j * lay.rp +
                                                           r0);
        const float4 s1 = *reinterpret_cast<const float4*>(st + j * lay.rp +
                                                           r0 + 4);
        const float sv[kBwdRows] = {s0.x, s0.y, s0.z, s0.w,
                                    s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int k = 0; k < kBwdRows; ++k) {
          acc[k].x = fmaf(sv[k], xv.x, acc[k].x);
          acc[k].y = fmaf(sv[k], xv.y, acc[k].y);
          acc[k].z = fmaf(sv[k], xv.z, acc[k].z);
          acc[k].w = fmaf(sv[k], xv.w, acc[k].w);
        }
      }
#pragma unroll
      for (int k = 0; k < kBwdRows; ++k) {
        const int i = r0 + k;
        if (i >= f) break;
        if constexpr (kVec) {
          *reinterpret_cast<float4*>(ob + i * dim + 4 * c) = acc[k];
        } else {
          const float a[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (4 * c + u < dim) store(ob + i * dim + 4 * c + u, a[u]);
          }
        }
      }
    }
    __syncthreads();                         // buffer cur may be refilled
  }
}

template <typename T, bool kVec>
int launch_bwd(const void* x, const void* dtri, void* dx, int64_t batch, int f,
               int dim, int pairs, int self_interaction, cudaStream_t stream) {
  const size_t smem = BwdLayout(f, dim, pairs).bytes();
  auto kernel = interaction_bwd_kernel<T, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0) {
    unsigned grid = 0;
    err = resident_grid(kernel, kThreads, smem, batch, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dtri),
        static_cast<T*>(dx), batch, f, dim, pairs, self_interaction);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 = float32, 2 = bfloat16 (dx has x's type).
extern "C" int repro_interaction_bwd(const void* x, int x_dtype,
                                     const void* dtri, void* dx,
                                     long long batch, int f, int dim,
                                     int self_interaction, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = self_interaction ? f * (f + 1) / 2 : f * (f - 1) / 2;
  const int si = self_interaction ? 1 : 0;
  if (x_dtype == 0) {
    const bool vec = dim % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dx) % 16 == 0;
    return vec ? launch_bwd<float, true>(x, dtri, dx, batch, f, dim, pairs,
                                         si, s)
               : launch_bwd<float, false>(x, dtri, dx, batch, f, dim, pairs,
                                          si, s);
  }
  if (x_dtype == 2) {
    return launch_bwd<__nv_bfloat16, false>(x, dtri, dx, batch, f, dim,
                                            pairs, si, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [batch, f, dim] f32 -> out [batch, P] f32 (P with the diagonal when
// self_interaction).
extern "C" int repro_interaction_fwd(const void* x, void* out, long long batch,
                                     int f, int dim, int self_interaction,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = self_interaction ? f * (f + 1) / 2 : f * (f - 1) / 2;
  const int si = self_interaction ? 1 : 0;
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch_fwd<true>(x, out, batch, f, dim, pairs, si, s)
             : launch_fwd<false>(x, out, batch, f, dim, pairs, si, s);
}

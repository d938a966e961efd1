// K2 interaction_fwd: DLRM pairwise dot interaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dot_interaction.py::
// interaction_fwd (_fwd_kernel). That kernel computed the whole F x F Gram
// matrix per sample on the matrix unit and compacted its lower triangle with
// a second matmul against a constant 0/1 selection matrix [F*F, P], because a
// TPU dislikes gathers. Here each thread computes the dots of its own pairs
// and writes them straight to their triangle index: no selection matrix, no
// upper-triangle work.
//
// What bounds it: memory. Per sample it reads F*D floats and writes P floats
// (P = F(F-1)/2, or F(F+1)/2 with the diagonal), and does 2*P*D flops on
// them; at F=27, D=128 that is 13.8 KB read for 90 KFLOP, about 6.5 flops a
// byte, far below the card's ridge point.
//
// Design: one block per sample. The block stages x[b] in shared memory once
// (row stride D+1, so threads on different rows hit different banks), then
// thread t takes pairs p = t, t + blockDim, ... It recovers (i, j) from p
// (p = i(i-1)/2 + j with j < i, or i(i+1)/2 + j with j <= i), which is
// exactly np.tril_indices order, and sums x[i,d]*x[j,d] over d in f32.
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
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;

template <bool kSelf>
__device__ __forceinline__ int tri_base(int i) {
  return kSelf ? i * (i + 1) / 2 : i * (i - 1) / 2;
}

template <bool kSelf>
__global__ void interaction_fwd_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int f,
                                       int dim, int pairs) {
  extern __shared__ float xs[];
  const int stride = dim + 1;
  const int64_t b = blockIdx.x;
  const float* xb = x + b * f * dim;
  for (int idx = threadIdx.x; idx < f * dim; idx += blockDim.x) {
    const int i = idx / dim;
    xs[i * stride + (idx - i * dim)] = xb[idx];
  }
  __syncthreads();
  float* ob = out + b * pairs;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const float root = sqrtf(1.f + 8.f * static_cast<float>(p));
    int i = static_cast<int>(kSelf ? (root - 1.f) * 0.5f : (root + 1.f) * 0.5f);
    while (i > 0 && tri_base<kSelf>(i) > p) --i;
    while (tri_base<kSelf>(i + 1) <= p) ++i;
    const int j = p - tri_base<kSelf>(i);
    const float* xi = xs + i * stride;
    const float* xj = xs + j * stride;
    float acc = 0.f;
    for (int d = 0; d < dim; ++d) acc = fmaf(xi[d], xj[d], acc);
    ob[p] = acc;
  }
}

template <bool kSelf>
int launch(const void* x, void* out, int64_t batch, int f, int dim, int pairs,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(f) * (dim + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        interaction_fwd_kernel<kSelf>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0) {
    interaction_fwd_kernel<kSelf>
        <<<static_cast<unsigned>(batch), kThreads, smem, stream>>>(
            static_cast<const float*>(x), static_cast<float*>(out), f, dim,
            pairs);
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
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0) {
    // as many blocks as fit on the card at once, each walking its samples
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t grid =
        std::min<int64_t>(batch, static_cast<int64_t>(sms) *
                                     std::max(per_sm, 1));
    kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
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

extern "C" int repro_interaction_fwd(const void* x, void* out, long long batch,
                                     int f, int dim, int self_interaction,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_interaction) {
    return launch<true>(x, out, batch, f, dim, f * (f + 1) / 2, s);
  }
  return launch<false>(x, out, batch, f, dim, f * (f - 1) / 2, s);
}

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
// dx = (G + G^T) x on the matrix unit. Here one block per sample stages x[b]
// (as f32) in shared memory and builds S = G + G^T there straight from the
// triangle: S[i, j] = dtri[p(i, j)] below the diagonal, dtri[p(j, i)] above
// it and, with self_interaction, 2 dtri[p(i, i)] on it (the symmetrization
// doubles the diagonal, which is d(x.x)/dx). Then thread (i, d) computes
// dx[i, d] = sum_j S[i, j] x[j, d]: a warp reads one row of S (a broadcast)
// and 32 consecutive columns of x (no bank conflicts). dx is written in x's
// type.
//
// What bounds it: memory. Per sample it reads F*D values of x and P floats
// of dtri and writes F*D values of dx, for 2*F*F*D flops: at F = 27, D = 128,
// f32, that is 29 KB for 187 KFLOP, about 6.4 flops a byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, bool kSelf>
__global__ void interaction_bwd_kernel(const T* __restrict__ x,
                                       const float* __restrict__ dtri,
                                       T* __restrict__ dx, int f, int dim,
                                       int pairs) {
  extern __shared__ float smem[];
  float* xs = smem;                       // x[b] as f32, [f, dim]
  float* ss = smem + f * dim;             // S = G + G^T, [f, f]
  const int64_t b = blockIdx.x;
  const int n = f * dim;
  const T* xb = x + b * n;
  const float* db = dtri + b * pairs;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    xs[idx] = to_f32(xb[idx]);
  }
  for (int e = threadIdx.x; e < f * f; e += blockDim.x) {
    const int i = e / f;
    const int j = e - i * f;
    float s;
    if (j < i) {
      s = db[tri_base<kSelf>(i) + j];
    } else if (j > i) {
      s = db[tri_base<kSelf>(j) + i];
    } else {
      s = kSelf ? 2.f * db[tri_base<kSelf>(i) + i] : 0.f;
    }
    ss[e] = s;
  }
  __syncthreads();
  T* ob = dx + b * n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int i = idx / dim;
    const int d = idx - i * dim;
    const float* srow = ss + i * f;       // the same row across a warp
    float acc = 0.f;
    for (int j = 0; j < f; ++j) acc = fmaf(srow[j], xs[j * dim + d], acc);
    store(ob + idx, acc);
  }
}

template <typename T, bool kSelf>
int launch_bwd(const void* x, const void* dtri, void* dx, int64_t batch, int f,
               int dim, int pairs, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(f) * dim + static_cast<size_t>(f) * f) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        interaction_bwd_kernel<T, kSelf>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch > 0) {
    interaction_bwd_kernel<T, kSelf>
        <<<static_cast<unsigned>(batch), kThreads, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(dtri),
            static_cast<T*>(dx), f, dim, pairs);
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
  switch (x_dtype * 2 + (self_interaction ? 1 : 0)) {
    case 0: return launch_bwd<float, false>(x, dtri, dx, batch, f, dim, pairs, s);
    case 1: return launch_bwd<float, true>(x, dtri, dx, batch, f, dim, pairs, s);
    case 4:
      return launch_bwd<__nv_bfloat16, false>(x, dtri, dx, batch, f, dim,
                                              pairs, s);
    case 5:
      return launch_bwd<__nv_bfloat16, true>(x, dtri, dx, batch, f, dim, pairs,
                                             s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

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

}  // namespace

extern "C" int repro_interaction_fwd(const void* x, void* out, long long batch,
                                     int f, int dim, int self_interaction,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_interaction) {
    return launch<true>(x, out, batch, f, dim, f * (f + 1) / 2, s);
  }
  return launch<false>(x, out, batch, f, dim, f * (f - 1) / 2, s);
}

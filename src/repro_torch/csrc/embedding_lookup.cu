// K1 lookup_fwd: sum-pooled multi-hot embedding lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_lookup.py::lookup_fwd
// (_fwd_kernel and _count_matrix). That kernel turned the gather into a
// one-hot count matrix times a streamed table tile, so the TPU's matrix unit
// could do the work; it read the whole table once per batch tile. A GPU reads
// scattered rows cheaply, so this kernel reads only the rows it needs.
//
// What bounds it: memory. An output row reads H table rows of D elements and
// writes D floats: about B*H*D*sizeof(T) + B*D*4 bytes (plus B*H*4 bytes of
// ids), with no arithmetic to speak of. At the served shape (B=1024, H=1,
// D=128, f32) that is about 1 MB a call, so launch overhead dominates.
//
// Design: one warp per output row. Lane l owns columns l, l+32, ..., so the
// 32 lanes read 32 consecutive elements of a table row (coalesced), the H ids
// of the row are read through the read-only cache and shared by the warp, and
// the sum stays in an f32 register until the one store. A -1 id is skipped,
// so a padded slot adds nothing and duplicate ids count once per occurrence.
// The h loop runs in order from a zero start, so H=1 is bit-exact with the
// plain version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void lookup_fwd_kernel(const T* __restrict__ table,
                                  const int32_t* __restrict__ rows,
                                  float* __restrict__ out, int64_t batch,
                                  int hot, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= batch) return;
  const int32_t* r = rows + b * hot;
  float* o = out + b * dim;
  for (int d = lane; d < dim; d += 32) {
    float acc = 0.f;
    for (int h = 0; h < hot; ++h) {
      const int32_t id = __ldg(r + h);
      if (id >= 0) acc += to_f32(table[static_cast<int64_t>(id) * dim + d]);
    }
    o[d] = acc;
  }
}

template <typename T>
int launch(const void* table, const void* rows, void* out, int64_t batch,
           int hot, int dim, cudaStream_t stream) {
  if (batch > 0) {
    const int64_t blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lookup_fwd_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                           0, stream>>>(
        static_cast<const T*>(table), static_cast<const int32_t*>(rows),
        static_cast<float*>(out), batch, hot, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table_dtype: 0 = float32, 1 = float16, 2 = bfloat16.
extern "C" int repro_lookup_fwd(const void* table, int table_dtype,
                                const void* rows, void* out, long long batch,
                                int hot, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0: return launch<float>(table, rows, out, batch, hot, dim, s);
    case 1: return launch<__half>(table, rows, out, batch, hot, dim, s);
    case 2: return launch<__nv_bfloat16>(table, rows, out, batch, hot, dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

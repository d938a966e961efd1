// K5 gather_rows and K6 dequant_gather_rows: the HPS L1 row read for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/hps_gather.py::gather_rows
// (_gather_kernel) and ::dequant_gather_rows (_dq_gather_kernel). Those built
// a one-hot matrix per (slot tile, payload tile) and multiplied it into the
// payload on the matrix unit, streaming the whole payload once per slot tile;
// K6 folded the per-row scale into the one-hot. Here each output row reads
// its one payload row directly.
//
// What bounds it: memory. Each valid slot reads one payload row
// (D * sizeof(T) bytes, plus a 4-byte scale for K6) and every output row
// writes D floats: about N*D*(sizeof(T) + 4) bytes a call.
//
// K5: one warp per output row; lane l converts columns l, l+32, ... so a
// warp reads a payload row in coalesced 32-element runs. The payload type is
// a template parameter (f32, f16). A -1 slot writes a zero row.
//
// K6: the grouped pooled read of pooled_read.cuh with the per-row scale: one
// launch reads every table of a served int8 batch and sums each output row's
// H dequantized rows into the [B, T, D] result in place (a warp per int8
// row of 128 bytes, each lane dequantizing 4 bytes into one float4 store).
// The cache's row read (slots [N]) is the same kernel with one
// table and H = 1. Each row is float(q) * scale[s], rounded before it is
// added, which at H = 1 is bit-exact with the plain version
// payload[s].float() * scales[s].
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pooled_read.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ payload,
                                   const int32_t* __restrict__ slots,
                                   float* __restrict__ out, int64_t n,
                                   int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int32_t s = __ldg(slots + row);
  float* o = out + row * dim;
  if (s < 0) {
    for (int d = lane; d < dim; d += 32) o[d] = 0.f;
    return;
  }
  const T* p = payload + static_cast<int64_t>(s) * dim;
  for (int d = lane; d < dim; d += 32) o[d] = to_f32(p[d]);
}

template <typename T>
int launch(const void* payload, const void* slots, void* out, int64_t n,
           int dim, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gather_rows_kernel<T>
        <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
            static_cast<const T*>(payload),
            static_cast<const int32_t*>(slots), static_cast<float*>(out), n,
            dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// payload_dtype: 0 = float32, 1 = float16.
extern "C" int repro_gather_rows(const void* payload, int payload_dtype,
                                 const void* slots, void* out, long long n,
                                 int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payload_dtype) {
    case 0: return launch<float>(payload, slots, out, n, dim, s);
    case 1: return launch<__half>(payload, slots, out, n, dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The grouped K6: `tables` (<= 64) payloads of `dim` columns and one type
// (payload_dtype 1 = float16, 3 = int8) with their [C] f32 scales; slots
// [batch, H] int32 (-1 = hole), hots each table's H; out[b * out_stride + t
// * dim + d] f32. The pointer arrays live in host memory and travel in the
// launch's parameters.
extern "C" int repro_dequant_gather_rows(const void* const* payloads,
                                         const void* const* scales,
                                         const void* const* slots,
                                         const int* hots, int tables,
                                         int payload_dtype, long long batch,
                                         int dim, void* out,
                                         long long out_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payload_dtype) {
    case 1:
      return pooled::launch<__half, true>(payloads, scales, slots, hots,
                                          tables, batch, dim, out, out_stride,
                                          s);
    case 3:
      return pooled::launch<int8_t, true>(payloads, scales, slots, hots,
                                          tables, batch, dim, out, out_stride,
                                          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

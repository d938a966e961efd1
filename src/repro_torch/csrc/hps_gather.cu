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
// Design: one warp per output row; lane l converts columns l, l+32, ... so a
// warp reads a payload row in coalesced 32-element runs. The payload type is
// a template parameter (f32, f16, int8) and kScaled selects K6. A -1 slot
// writes a zero row. K6 dequantizes with one multiply, float(q) * scale[s],
// which is bit-exact with the plain version payload[s].float() * scales[s].
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T, bool kScaled>
__global__ void gather_rows_kernel(const T* __restrict__ payload,
                                   const float* __restrict__ scales,
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
  if (kScaled) {
    const float sc = __ldg(scales + s);
    for (int d = lane; d < dim; d += 32) o[d] = to_f32(p[d]) * sc;
  } else {
    for (int d = lane; d < dim; d += 32) o[d] = to_f32(p[d]);
  }
}

template <typename T, bool kScaled>
int launch(const void* payload, const void* scales, const void* slots,
           void* out, int64_t n, int dim, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gather_rows_kernel<T, kScaled>
        <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
            static_cast<const T*>(payload), static_cast<const float*>(scales),
            static_cast<const int32_t*>(slots), static_cast<float*>(out), n,
            dim);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kScaled>
int dispatch(const void* payload, int payload_dtype, const void* scales,
             const void* slots, void* out, long long n, int dim,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payload_dtype) {
    case 0: return launch<float, kScaled>(payload, scales, slots, out, n, dim, s);
    case 1: return launch<__half, kScaled>(payload, scales, slots, out, n, dim, s);
    case 3: return launch<int8_t, kScaled>(payload, scales, slots, out, n, dim, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// payload_dtype: 0 = float32, 1 = float16, 3 = int8.
extern "C" int repro_gather_rows(const void* payload, int payload_dtype,
                                 const void* slots, void* out, long long n,
                                 int dim, void* stream) {
  return dispatch<false>(payload, payload_dtype, nullptr, slots, out, n, dim,
                         stream);
}

extern "C" int repro_dequant_gather_rows(const void* payload, int payload_dtype,
                                         const void* scales, const void* slots,
                                         void* out, long long n, int dim,
                                         void* stream) {
  return dispatch<true>(payload, payload_dtype, scales, slots, out, n, dim,
                        stream);
}

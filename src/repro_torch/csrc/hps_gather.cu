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
// What bounds it: memory, and at the cache query's size the launch. Each
// valid slot reads one payload row (D * sizeof(T) bytes, plus a 4-byte
// scale for K6) and every output row writes D floats: about N*D*(sizeof(T)
// + 4) bytes a call, 0.5 MB at the served query (slots [1024], D = 128 f32).
//
// Both are the pooled read of pooled_read.cuh (a warp per 128-wide row, each
// lane moving four elements as one vector load and one float4 store; an
// element-wise path for D % 4 != 0 or an unaligned payload):
//
// K5: the one-table launch with hot = 1 and no scale, f32 or f16 payload. A
// -1 slot adds nothing, so its row is zero. Each row is 0 + float(payload[s]):
// the plain version's rows, bit for bit.
//
// K6: the same kernel with the per-row scale. The grouped entry reads every
// table of a served int8 batch in one launch and sums each output row's H
// dequantized rows into the [B, T, D] result in place; the cache's row read
// (slots [N]) is the one-table launch with hot = 1. Each row is float(q) *
// scale[s], rounded before it is added, which at H = 1 is bit-exact with the
// plain version payload[s].float() * scales[s].
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pooled_read.cuh"

// K5, one table: payload [C, dim] (payload_dtype 0 = float32, 1 =
// float16), slots [batch, hot] int32 (-1 = hole) -> out [batch, dim] f32;
// the cache's row read is hot = 1.
extern "C" int repro_gather_rows(const void* payload, const void* slots,
                                 int hot, int payload_dtype, long long batch,
                                 int dim, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payload_dtype) {
    case 0:
      return pooled::launch_one<float, false>(payload, nullptr, slots, hot,
                                              batch, dim, out, s);
    case 1:
      return pooled::launch_one<__half, false>(payload, nullptr, slots, hot,
                                               batch, dim, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6, one table: as repro_gather_rows with scales [C] f32 (payload_dtype 1 =
// float16, 3 = int8).
extern "C" int repro_dequant_gather_rows_one(const void* payload,
                                             const void* scales,
                                             const void* slots, int hot,
                                             int payload_dtype,
                                             long long batch, int dim,
                                             void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payload_dtype) {
    case 1:
      return pooled::launch_one<__half, true>(payload, scales, slots, hot,
                                              batch, dim, out, s);
    case 3:
      return pooled::launch_one<int8_t, true>(payload, scales, slots, hot,
                                              batch, dim, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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

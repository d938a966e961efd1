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
//
// The mesh half: the owner-mapped twins below also replace the per-device
// bodies of repro/kernels/hps_gather.py::sharded_gather_rows
// (_local_stripe_gather) and ::sharded_dequant_gather_rows
// (_local_stripe_dequant_gather). A striped L1 lies over a cache mesh, each
// entry holding the block [k, Cl, D] of stripes first .. first + k - 1. The
// TPU body remapped the global slots to local rows with a handful of array
// ops, ran the one-hot gather (a zero row for another device's slot), then
// one psum of the rows, then the pool over H. Here one launch an entry
// takes the global slots as they are and does the remap per slot inside the
// pooled read (stripe = s % N; owned when first <= stripe < first + k; row
// (stripe - first) * Cl + s / N), for every table of a read at once: each
// later entry places the rows of its own stripes in a rows buffer on the
// first entry's device (an entry on another device in a zeroed buffer of
// its own that is then added there: the psum, exact, as each row has one
// owner), then the first entry pools each output row's slots in order of h,
// its own rows from its block and the others' from the buffer, so the sums
// are the one-device read's bit for bit. With H = 1 (the served tables, the
// row read) the buffer is the output itself. That removes the remap ops,
// the launch a table and the per-entry stack and sum of the port's first
// mesh read. What bounds it: at one table's row read (slots [1024]) the
// launch, about a microsecond an entry; at a served batch of 26 tables the
// bytes, the one-device read's plus a write and a read of the rows that
// the later entries own.
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

// ---------------------------------------------------------------------------
// The owner-mapped twins: one cache-mesh entry's read of a striped L1 (the
// mesh half). The slots stay GLOBAL (stripe s % stripes, row s / stripes);
// the payload is the entry's block [owned, stripe_rows, dim] of the stripes
// first .. first + owned - 1 (scales [owned, stripe_rows]). rows [batch, W,
// dim] f32 at rows_stride floats a b (table t's slot h at column cols[t] +
// h; a one-table read at column h): with pool = 0 the entry writes there
// the rows of its own stripes and nothing else; with pool = 1 it writes out
// (out_stride floats a b), each row the sum in order of h of its slots'
// rows, its own from the block and the others' from rows. With hot = 1
// everywhere rows may be out.
// ---------------------------------------------------------------------------

// K5, one table (payload_dtype 0 = float32, 1 = float16).
extern "C" int repro_gather_rows_mesh(const void* payload, const void* slots,
                                      int hot, int stripe_rows,
                                      int payload_dtype, long long batch,
                                      int dim, void* out, void* rows,
                                      long long rows_stride, int stripes,
                                      int first, int owned, int pool,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const pooled::Mesh m{static_cast<float*>(rows), rows_stride, stripes,
                       first, owned, pool};
  switch (payload_dtype) {
    case 0:
      return pooled::launch_one<float, false, true>(
          payload, nullptr, slots, hot, batch, dim, out, s, stripe_rows, m);
    case 1:
      return pooled::launch_one<__half, false, true>(
          payload, nullptr, slots, hot, batch, dim, out, s, stripe_rows, m);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5, grouped: `tables` (<= 64) blocks of one type and `dim` columns, each
// with its slots [batch, H], stripe_rows and column in rows.
extern "C" int repro_gather_rows_grouped_mesh(
    const void* const* payloads, const void* const* slots, const int* hots,
    const int* stripe_rows, const int* cols, int tables, int payload_dtype,
    long long batch, int dim, void* out, long long out_stride, void* rows,
    long long rows_stride, int stripes, int first, int owned, int pool,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const pooled::Mesh m{static_cast<float*>(rows), rows_stride, stripes,
                       first, owned, pool};
  switch (payload_dtype) {
    case 0:
      return pooled::launch<float, false, true>(
          payloads, nullptr, slots, hots, tables, batch, dim, out,
          out_stride, s, stripe_rows, cols, m);
    case 1:
      return pooled::launch<__half, false, true>(
          payloads, nullptr, slots, hots, tables, batch, dim, out,
          out_stride, s, stripe_rows, cols, m);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6, one table (payload_dtype 1 = float16, 3 = int8), scales [owned,
// stripe_rows] f32.
extern "C" int repro_dequant_gather_rows_one_mesh(
    const void* payload, const void* scales, const void* slots, int hot,
    int stripe_rows, int payload_dtype, long long batch, int dim, void* out,
    void* rows, long long rows_stride, int stripes, int first, int owned,
    int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const pooled::Mesh m{static_cast<float*>(rows), rows_stride, stripes,
                       first, owned, pool};
  switch (payload_dtype) {
    case 1:
      return pooled::launch_one<__half, true, true>(
          payload, scales, slots, hot, batch, dim, out, s, stripe_rows, m);
    case 3:
      return pooled::launch_one<int8_t, true, true>(
          payload, scales, slots, hot, batch, dim, out, s, stripe_rows, m);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6, grouped.
extern "C" int repro_dequant_gather_rows_mesh(
    const void* const* payloads, const void* const* scales,
    const void* const* slots, const int* hots, const int* stripe_rows,
    const int* cols, int tables, int payload_dtype, long long batch, int dim,
    void* out, long long out_stride, void* rows, long long rows_stride,
    int stripes, int first, int owned, int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const pooled::Mesh m{static_cast<float*>(rows), rows_stride, stripes,
                       first, owned, pool};
  switch (payload_dtype) {
    case 1:
      return pooled::launch<__half, true, true>(
          payloads, scales, slots, hots, tables, batch, dim, out, out_stride,
          s, stripe_rows, cols, m);
    case 3:
      return pooled::launch<int8_t, true, true>(
          payloads, scales, slots, hots, tables, batch, dim, out, out_stride,
          s, stripe_rows, cols, m);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

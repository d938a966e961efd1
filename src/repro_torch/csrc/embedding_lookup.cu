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
//
// K3 lookup_bwd: the adjoint, replacing repro/kernels/embedding_lookup.py::
// lookup_bwd (_bwd_kernel). dtable[v] = sum of dpooled[b] over every (b, h)
// with rows[b, h] == v, into a dense [V, D] f32 gradient as in the TPU
// contract. The TPU kernel was a count-matrix transpose times dpooled, which
// is deterministic; a scatter with f32 atomicAdd would not be, because the
// order of the adds would change from run to run. So the wrapper sorts the
// flat ids with a stable sort (bookkeeping on B*H int32 ids) and zero-fills
// dtable (a memset), and two kernels sum each run of equal ids in a fixed
// order:
//
// * chunk pass: the sorted positions are cut into chunks of kChunk = 16 (one
//   id a lane of the first 16) and the columns into tiles of 128; one warp
//   owns one (chunk, column tile). It walks its chunk in order and sums
//   each segment of equal ids from zero. A segment whose run lies wholly
//   inside the chunk is written to dtable[id]; a run that crosses the
//   chunk's start or end leaves its segment as a partial in
//   partial[chunk][0] (the segment that continues a run from the previous
//   chunk) or partial[chunk][1] (the one that starts a run which goes on
//   into the next chunk).
// * merge pass: one warp per (chunk boundary, column tile) that a run
//   crosses first adds that run's partials in chunk order and writes the
//   row once.
//
// So a Zipf head id's long run is summed by many warps at once (a 562-row
// run at D = 3072: 36 chunks x 24 column tiles in the chunk pass, then one
// walk over 36 partials a column tile), where one warp used to walk it
// alone. No atomics, the same bits on every run; the order of the f32 adds
// is ref.embedding_grad_chunked_ref's, which repeats it in torch. The
// scratch is sized from B*H alone (no count of runs comes back to the host),
// so the wrapper stays capturable in a CUDA graph.
//
// What bounds it: memory. The function reads dpooled once and the ids, and
// its output is the dense [V, D] table: V*D*4 bytes, which at V = 5.8M, D =
// 128 is 2.97 GB, against 29 MB of dpooled at B*T = 57,344. The zero-fill
// writes those bytes; the kernels write only the touched rows and the
// partials of the runs that cross a chunk boundary.
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

constexpr int kChunk = 16;             // sorted positions a chunk
constexpr int kColsPerLane = 4;        // a column tile: 4 x 32 columns
constexpr int kTileCols = kColsPerLane * 32;
constexpr int kPrefetch = 4;           // dpooled rows loaded ahead

__device__ __forceinline__ bool valid_id(int32_t id, int64_t vocab) {
  return id >= 0 && id < vocab;
}

// The warps of a block take chunks gridDim.x apart, so that a stretch of
// busy chunks (the valid ids of a hybrid table sort together) spreads over
// many blocks and SMs.
__device__ __forceinline__ int64_t strided_warp() {
  return blockIdx.x + static_cast<int64_t>(threadIdx.x >> 5) * gridDim.x;
}

// sorted: the flat ids rows[b, h] sorted (stable), order: the flat position
// b * hot + h each came from. Warp (c, blockIdx.y) owns chunk c's positions
// [c * kChunk, c * kChunk + len) and columns [d0, d0 + 128); lane l holds
// columns d0 + l, d0 + l + 32, ... Each lane reads one id and its dpooled
// row index, and the warp walks the chunk in order through shuffles, so
// every branch below is warp-uniform. Rows are loaded kPrefetch ahead; the
// adds stay in position order.
__global__ void lookup_bwd_chunk_kernel(const int32_t* __restrict__ sorted,
                                        const int64_t* __restrict__ order,
                                        const float* __restrict__ dpooled,
                                        float* __restrict__ dtable,
                                        float* __restrict__ partial,
                                        int64_t n, int hot, int64_t vocab,
                                        int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t c = strided_warp();
  const int64_t p0 = c * kChunk;
  if (p0 >= n) return;
  const int len = static_cast<int>(min(static_cast<int64_t>(kChunk), n - p0));
  const int d0 = static_cast<int>(blockIdx.y) * kTileCols;
  const int32_t my_id = lane < len ? __ldg(sorted + p0 + lane) : -1;
  // ids sort -1 first and past-the-table last: a chunk of only those (most
  // of a masked hybrid table's) has nothing to add
  const int32_t lo = __shfl_sync(0xffffffffu, my_id, 0);
  const int32_t hi = __shfl_sync(0xffffffffu, my_id, len - 1);
  if (hi < 0 || lo >= vocab) return;
  const int my_row =
      lane < len ? static_cast<int>(__ldg(order + p0 + lane) / hot) : 0;
  // the ids just before and after the chunk: does a run cross its edges?
  const int32_t before = p0 > 0 ? __ldg(sorted + p0 - 1) : -1;
  const int32_t after = p0 + kChunk < n ? __ldg(sorted + p0 + kChunk) : -1;
  float acc[kColsPerLane];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
  int start = 0;                        // the open segment's first position
  for (int j0 = 0; j0 < len; j0 += kPrefetch) {
    float x[kPrefetch][kColsPerLane];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int j = j0 + u;
      const int32_t id = __shfl_sync(0xffffffffu, my_id, j & 31);
      const int row = __shfl_sync(0xffffffffu, my_row, j & 31);
      const bool use = j < len && valid_id(id, vocab);
      const float* src = dpooled + static_cast<int64_t>(row) * dim;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int d = d0 + k * 32 + lane;
        x[u][k] = use && d < dim ? src[d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int j = j0 + u;
      if (j >= len) break;
      const int32_t id = __shfl_sync(0xffffffffu, my_id, j);
      const int32_t next = __shfl_sync(0xffffffffu, my_id, (j + 1) & 31);
      const bool ok = valid_id(id, vocab);
      if (ok) {
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) acc[k] += x[u][k];
      }
      if (j + 1 < len && next == id) continue;      // the segment goes on
      if (ok) {
        const bool enters = start == 0 && before == id;
        const bool leaves = j == kChunk - 1 && after == id;
        float* dst = enters   ? partial + (2 * c) * dim
                     : leaves ? partial + (2 * c + 1) * dim
                              : dtable + static_cast<int64_t>(id) * dim;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int d = d0 + k * 32 + lane;
          if (d < dim) dst[d] = acc[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
      start = j + 1;
    }
  }
}

// Warp (b, blockIdx.y) looks at the boundary between chunks b - 1 and b
// (b >= 1). If a valid run crosses it and crosses no earlier boundary, the
// warp finds the run's last chunk e by ballot over the next boundaries, then
// adds the run's partials in chunk order, loaded kPrefetch ahead: chunk b -
// 1's leaving segment, then the entering segments of chunks b, ..., e; and
// writes dtable[id] once.
__global__ void lookup_bwd_merge_kernel(const int32_t* __restrict__ sorted,
                                        const float* __restrict__ partial,
                                        float* __restrict__ dtable, int64_t n,
                                        int64_t vocab, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t b = 1 + strided_warp();
  const int64_t pb = b * kChunk;
  if (pb >= n) return;
  const int32_t id = __ldg(sorted + pb);
  if (!valid_id(id, vocab) || __ldg(sorted + pb - 1) != id) return;
  if (b >= 2 && __ldg(sorted + pb - kChunk - 1) == id) return;
  int64_t e = b;
  for (int64_t base = b + 1;; base += 32) {
    const int64_t edge = (base + lane) * kChunk;
    const unsigned crossed = __ballot_sync(
        0xffffffffu, edge < n && __ldg(sorted + edge - 1) == id &&
                         __ldg(sorted + edge) == id);
    if (crossed != 0xffffffffu) {
      e = base + __ffs(~crossed) - 2;
      break;
    }
  }
  const int d0 = static_cast<int>(blockIdx.y) * kTileCols;
  float acc[kColsPerLane];
  const float* first = partial + (2 * (b - 1) + 1) * dim;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int d = d0 + k * 32 + lane;
    acc[k] = d < dim ? first[d] : 0.f;
  }
  for (int64_t c0 = b; c0 <= e; c0 += kPrefetch) {
    float x[kPrefetch][kColsPerLane];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const float* part = partial + (2 * (c0 + u)) * dim;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int d = d0 + k * 32 + lane;
        x[u][k] = c0 + u <= e && d < dim ? part[d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (c0 + u > e) break;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) acc[k] += x[u][k];
    }
  }
  float* o = dtable + static_cast<int64_t>(id) * dim;
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int d = d0 + k * 32 + lane;
    if (d < dim) o[d] = acc[k];
  }
}

}  // namespace

// order: int64 positions from the stable sort; partial: scratch of [2 *
// ceil(n / 16), dim] f32 (nothing in it is read before the chunk pass
// writes it). Both passes go on the stream in order.
extern "C" int repro_lookup_bwd(const void* sorted, const void* order,
                                const void* dpooled, void* dtable,
                                void* partial, long long n, int hot,
                                long long vocab, int dim, int chunk,
                                void* stream) {
  // the caller sized partial for chunks of `chunk` positions
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + kChunk - 1) / kChunk;
  const unsigned tiles = static_cast<unsigned>((dim + kTileCols - 1) /
                                               kTileCols);
  const dim3 grid(static_cast<unsigned>((chunks + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock), tiles);
  lookup_bwd_chunk_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int32_t*>(sorted), static_cast<const int64_t*>(order),
      static_cast<const float*>(dpooled), static_cast<float*>(dtable),
      static_cast<float*>(partial), n, hot, vocab, dim);
  if (chunks > 1) {
    const dim3 mgrid(static_cast<unsigned>((chunks - 1 + kWarpsPerBlock - 1) /
                                           kWarpsPerBlock), tiles);
    lookup_bwd_merge_kernel<<<mgrid, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int32_t*>(sorted),
        static_cast<const float*>(partial), static_cast<float*>(dtable), n,
        vocab, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

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

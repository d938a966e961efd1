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
// dtable (a memset); then one warp per sorted position p that starts a run of
// equal ids sums the dpooled rows of that run in their stable order (b, then
// h) and writes dtable[id] once. No atomics, the same bits on every run. A
// run is summed by one warp alone, so a skewed batch (a Zipf head id in a
// large share of the samples) makes one long serial walk.
//
// What bounds it: memory. The function reads dpooled once and the ids, and
// its output is the dense [V, D] table: V*D*4 bytes, which at V = 5.8M, D =
// 128 is 2.97 GB, against 29 MB of dpooled at B*T = 57,344. The zero-fill
// writes those bytes; the kernel writes only the touched rows.
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

// sorted: the flat ids rows[b, h] sorted (stable), order: the flat position
// b * hot + h each came from. Warp w owns sorted position w; only the first
// position of a run of equal valid ids does work (p and id are the same for
// every lane, so the early returns are warp-uniform). The warp finds the
// run's end 32 ids at a time with a ballot, then walks the run once, lane l
// summing columns l, l + 32, ... of each dpooled row into registers (up to
// kChunks * 32 columns a pass): the loads of consecutive run entries do not
// wait on each other.
constexpr int kChunks = 8;

__global__ void lookup_bwd_kernel(const int32_t* __restrict__ sorted,
                                  const int32_t* __restrict__ order,
                                  const float* __restrict__ dpooled,
                                  float* __restrict__ dtable, int64_t n,
                                  int hot, int64_t vocab, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n) return;
  const int32_t id = __ldg(sorted + p);
  if (id < 0 || id >= vocab) return;
  if (p > 0 && __ldg(sorted + p - 1) == id) return;
  int64_t end = n;
  for (int64_t base = p + 1; base < n; base += 32) {
    const int64_t q = base + lane;
    const unsigned same =
        __ballot_sync(0xffffffffu, q < n && __ldg(sorted + q) == id);
    if (same != 0xffffffffu) {
      end = base + __ffs(~same) - 1;
      break;
    }
  }
  float* o = dtable + static_cast<int64_t>(id) * dim;
  for (int d0 = 0; d0 < dim; d0 += kChunks * 32) {
    float acc[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int64_t q = p; q < end; ++q) {
      const float* row = dpooled + (__ldg(order + q) / hot) *
                                       static_cast<int64_t>(dim);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = d0 + c * 32 + lane;
        if (d < dim) acc[c] += row[d];
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = d0 + c * 32 + lane;
      if (d < dim) o[d] = acc[c];
    }
  }
}

}  // namespace

extern "C" int repro_lookup_bwd(const void* sorted, const void* order,
                                const void* dpooled, void* dtable, long long n,
                                int hot, long long vocab, int dim,
                                void* stream) {
  if (n > 0) {
    const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lookup_bwd_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sorted), static_cast<const int32_t*>(order),
        static_cast<const float*>(dpooled), static_cast<float*>(dtable), n, hot,
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

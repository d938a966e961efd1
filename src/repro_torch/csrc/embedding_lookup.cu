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
// ids), with no arithmetic to speak of. At the served shape (26 tables of
// B=1024, H=1, D=128, f32) that is 27 MB a batch.
//
// Design: the grouped pooled read of pooled_read.cuh, one launch for up to 64
// tables that share D and the table type (f32, f16 or bf16): every table of
// a served batch in one launch, each output row written in place in the
// [B, T, D] result, rows moved in vector units of four elements. The
// single-table lookup of training and of the LM's token tables is the same
// kernel through its one-table launch (repro_lookup_fwd_one).
// The h loop runs in order from a zero start, so H=1 is bit-exact with the
// plain version; a row whose ids are all -1 reads nothing and writes zeros.
//
// K3 lookup_bwd: the adjoint, replacing repro/kernels/embedding_lookup.py::
// lookup_bwd (_bwd_kernel). dtable[v] = sum of dpooled[b] over every (b, h)
// with rows[b, h] == v, into a dense [V, D] f32 gradient as in the TPU
// contract. The TPU kernel was a count-matrix transpose times dpooled, which
// is deterministic; a scatter with f32 atomicAdd would not be, because the
// order of the adds would change from run to run. So the flat ids are sorted
// (stable), dtable is zero-filled, and two passes sum each run of equal ids
// in a fixed order:
//
// * chunk pass: the sorted positions are cut into chunks of kChunk = 16. A
//   chunk's walk runs over its positions in order and sums each segment of
//   equal ids from zero. A segment whose run lies wholly inside the chunk is
//   written to dtable[id]; a run that crosses the chunk's start or end
//   leaves its segment as a partial in partial[chunk][0] (the segment that
//   continues a run from the previous chunk) or partial[chunk][1] (the one
//   that starts a run which goes on into the next chunk).
// * merge pass: for each chunk boundary that a run crosses first, that
//   run's partials are added in chunk order and the row is written once.
//
// Routes, by shape:
//
// * the sort: a list of up to kSortMax = 32,768 ids is sorted by hand in
//   the same launch that zero-fills dtable (lookup_bwd_sort_kernel): one
//   cluster of up to 8 blocks holds the list in shared memory and runs an
//   LSD radix sort over only the bits the table needs (ceil(log2(V + 2)):
//   ids below 0 sort as one key first, ids past the table as one key
//   last), 5 bits a pass, each pass a raking radix rank (each thread's
//   own column of 16-bit counters, one block-wide scan) and a scatter into
//   the block that holds the slot through distributed shared memory; every
//   other block of the launch zero-fills dtable meanwhile. Where the fill
//   is long the cluster is as small as the list allows, so the fill keeps
//   its SMs and the sort runs under it; where it is short the cluster
//   takes a block per 1024 ids, and the sort sets the pace. A longer list
//   is sorted by torch.sort and dtable zero-filled by torch.zeros: there
//   the hand sort's passes (scattered 8-byte stores through distributed
//   shared memory, two cluster barriers each) take longer than the fill
//   they would hide under.
// * the passes at D <= 32: one group of g lanes a chunk (g the smallest power
//   of two >= D, one lane a column), so a warp walks 32 / g chunks at once;
//   each lane loads its chunk's 16 ids, positions and dpooled values before
//   it adds, and the merge folds 32 / g chunks' partials a round through
//   shuffles. At D > 32 one warp owns one (chunk, 128-column tile), with one
//   id a lane shuffled to the others and the chunk's 16 rows loaded before
//   the adds.
//
// So a Zipf head id's long run is summed by many warps at once (a 562-row
// run at D = 3072: 36 chunks x 24 column tiles in the chunk pass, then one
// walk over 36 partials a column tile), where one warp used to walk it
// alone. No atomics, the same bits on every run and on every route: a stable
// sort has one result, and the order of the f32 adds is
// ref.embedding_grad_chunked_ref's, which repeats it in torch. The scratch is
// sized from B*H alone (no count of runs comes back to the host), so the
// wrapper stays capturable in a CUDA graph.
//
// What bounds it: memory. The function reads dpooled once and the ids, and
// its output is the dense [V, D] table: V*D*4 bytes, which at V = 5.8M, D =
// 128 is 2.97 GB, against 29 MB of dpooled at B*T = 57,344. The zero-fill
// writes those bytes; the passes write only the touched rows and the
// partials of the runs that cross a chunk boundary.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pooled_read.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 8;

constexpr int kChunk = 16;             // sorted positions a chunk
constexpr int kColsPerLane = 4;        // a column tile: 4 x 32 columns
constexpr int kTileCols = kColsPerLane * 32;
constexpr int kPrefetch = 4;           // partials loaded ahead by the merge
constexpr int kNarrow = 32;            // widest D of the grouped passes

// the sort: 1024 threads a block, up to 16 slots a thread, up to 8 blocks
constexpr int kSortThreads = 1024;
constexpr int kSortRounds = 16;
constexpr int kSortCluster = 8;
constexpr long long kSortMax = 32768;          // ids the sort takes
constexpr long long kLongFillBytes = 32ll << 20;   // a fill the sort hides in
constexpr int kDigitBits = 5;          // bits a pass
constexpr int kMaxBins = 1 << kDigitBits;
constexpr int kHalfBins = kMaxBins / 2;   // rows of packed counters

__device__ __forceinline__ bool valid_id(int32_t id, int64_t vocab) {
  return id >= 0 && id < vocab;
}

// The warps of a block take chunks gridDim.x apart, so that a stretch of
// busy chunks (the valid ids of a hybrid table sort together) spreads over
// many blocks and SMs.
__device__ __forceinline__ int64_t strided_warp() {
  return blockIdx.x + static_cast<int64_t>(threadIdx.x >> 5) * gridDim.x;
}

// ---------------------------------------------------------------------------
// the sort, with the zero-fill beside it
// ---------------------------------------------------------------------------

// word f of the sort's counters in (row, thread) order, one word of padding
// after every 32: a warp's column accesses and its raking segments (16
// words a thread at most) each fall on 32 banks
__device__ __forceinline__ int cidx(int f) { return f + (f >> 5); }

// the sort key of an id: 0 below the table, id + 1 in it, V + 1 past it
__device__ __forceinline__ uint32_t sort_key(int32_t id, int64_t vocab) {
  return id < 0 ? 0u
                : (id >= vocab ? static_cast<uint32_t>(vocab) + 1u
                               : static_cast<uint32_t>(id) + 1u);
}

// Blocks [0, cs) form the cluster that sorts; the others zero-fill dtable
// (`words` floats) meanwhile. The cluster's block q holds sorted slots [q *
// slots, (q + 1) * slots) in shared memory, thread t of a block the
// R consecutive slots from t * R. A slot is (key << 32 |
// position); slots past n hold the largest key and stay last. A pass of
// `width` <= 5 bits ranks the slots by their digit as a raking radix rank
// does: each thread counts its slots' digits in its own column of 16-bit
// counters (two digits a 32-bit word: d and d + half), remembering each
// slot's count before it; one block-wide exclusive scan of the words in
// (digit, thread) order gives every (digit, thread) its first rank in the
// block; the blocks' digit counts, pushed into every block of the cluster
// (distributed shared memory), give each block its first slot of each
// digit; then each slot goes to the block that holds its destination. The
// slots start in position order and every pass is stable, so equal ids
// keep their positions' order, as torch.sort(stable=True) keeps it.
template <int R>
__global__ void __launch_bounds__(kSortThreads, 1)
    lookup_bwd_sort_kernel(const int32_t* __restrict__ rows,
                           int32_t* __restrict__ sorted,
                           int64_t* __restrict__ order,
                           float* __restrict__ dtable, long long n,
                           long long vocab, long long words, int bits,
                           unsigned magic) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= cs) {     // the zero-fill
    const long long z = blockIdx.x - cs, zn = gridDim.x - cs;
    const long long w4 = words >> 2;
    float4* t4 = reinterpret_cast<float4*>(dtable);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (long long i = z * kSortThreads + tid; i < w4;
         i += zn * kSortThreads) {
      t4[i] = zero;
    }
    if (z == 0 && tid < (words & 3)) dtable[(w4 << 2) + tid] = 0.f;
    return;
  }
  extern __shared__ __align__(16) unsigned char sort_smem[];
  const int slots = R * kSortThreads;
  uint64_t* data = reinterpret_cast<uint64_t*>(sort_smem);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(data + slots);  // [row][thread]
  int* totals =
      reinterpret_cast<int*>(cnt + cidx(kHalfBins * kSortThreads));
  int* first = totals + kSortCluster * kMaxBins;  // [digit]: G, see below
  int* wsum = first + kMaxBins;                   // [warp]
  const int q = static_cast<int>(cluster.block_rank());
  const int w = tid >> 5, lane = tid & 31;
  const int mine = tid * R;                  // this thread's first slot
  const long long at = static_cast<long long>(q) * slots + mine;
  uint64_t e[R];
  {
    int32_t id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      id[r] = at + r < n ? __ldg(rows + at + r) : 0;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t key = at + r < n ? sort_key(id[r], vocab) : 0xffffffffu;
      e[r] = (static_cast<uint64_t>(key) << 32) |
             static_cast<uint32_t>(at + r);
    }
  }
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int width = (bits + passes - 1) / passes;
  const int half = width > 1 ? 1 << (width - 1) : 1;   // rows of counters
  const uint32_t mask = (1u << width) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int shift = 32 + p * width;
    for (int r = 0; r < half; ++r) cnt[cidx(r * kSortThreads + tid)] = 0;
    // this thread's slots in order: the count of the digit before each
    uint64_t before = 0;                          // 4 bits a slot
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t d = static_cast<uint32_t>(e[r] >> shift) & mask;
      const int hi = d >= static_cast<uint32_t>(half);
      uint32_t* c = cnt + cidx((d - hi * half) * kSortThreads + tid);
      const uint32_t word = *c;
      before |= static_cast<uint64_t>((word >> (16 * hi)) & 15u) << (4 * r);
      *c = word + (1u << (16 * hi));
    }
    __syncthreads();
    // exclusive scan of the words in (row, thread) order, both halves at
    // once: thread t rakes words [t * half, t * half + half)
    const int seg = tid * half;
    uint32_t sum = 0;
    for (int r = 0; r < half; ++r) sum += cnt[cidx(seg + r)];
    uint32_t x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[w] = static_cast<int>(x);
    __syncthreads();
    if (w == 0) {
      uint32_t v = static_cast<uint32_t>(wsum[lane]), u = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, u, o);
        if (lane >= o) u += y;
      }
      wsum[lane] = static_cast<int>(u - v);         // warps below
      if (lane == 31) wsum[32] = static_cast<int>(u);  // the block's total
    }
    __syncthreads();
    uint32_t run = x - sum + static_cast<uint32_t>(wsum[w]);
    for (int r = 0; r < half; ++r) {
      const uint32_t v = cnt[cidx(seg + r)];
      cnt[cidx(seg + r)] = run;
      run += v;
    }
    __syncthreads();
    // the block's count and first rank of each digit (digit d of the high
    // half ranks after every digit of the low one), pushed to the cluster
    const uint32_t all = static_cast<uint32_t>(wsum[32]);
    const uint32_t low = all & 0xffffu;
    auto start_of = [&](int d) -> uint32_t {       // d <= 2 * half
      if (d < half) return cnt[cidx(d * kSortThreads)] & 0xffffu;
      if (d == half) return low;
      if (d < 2 * half) {
        return low + (cnt[cidx((d - half) * kSortThreads)] >> 16);
      }
      return low + (all >> 16);
    };
    const int bins = 2 * half;
    int count = 0, begin = 0;
    if (tid < bins) {
      begin = static_cast<int>(start_of(tid));
      count = static_cast<int>(start_of(tid + 1)) - begin;
      for (int b = 0; b < cs; ++b) {
        cluster.map_shared_rank(totals, b)[q * kMaxBins + tid] = count;
      }
    }
    cluster.sync();
    // G[d]: the cluster's first slot of digit d in this block, less the
    // block's own first rank of d
    if (w == 0) {
      int col = 0, below = 0;
      if (lane < bins) {
        for (int b = 0; b < cs; ++b) {
          const int c = totals[b * kMaxBins + lane];
          col += c;
          if (b < q) below += c;
        }
      }
      int y = col;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) y += z;
      }
      if (lane < bins) first[lane] = y - col + below - begin;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t d = static_cast<uint32_t>(e[r] >> shift) & mask;
      const int hi = d >= static_cast<uint32_t>(half);
      const uint32_t word = cnt[cidx((d - hi * half) * kSortThreads + tid)];
      const uint32_t rank = hi ? low + (word >> 16) : word & 0xffffu;
      const int dst = first[d] + static_cast<int>(rank) +
                      static_cast<int>((before >> (4 * r)) & 15u);
      const int b =
          static_cast<int>(__umulhi(static_cast<unsigned>(dst), magic));
      cluster.map_shared_rank(data, b)[dst - b * slots] = e[r];
    }
    cluster.sync();
#pragma unroll
    for (int r = 0; r < R; ++r) e[r] = data[mine + r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (at + r < n) {
      sorted[at + r] =
          static_cast<int32_t>(static_cast<int64_t>(e[r] >> 32) - 1);
      order[at + r] = static_cast<int64_t>(static_cast<uint32_t>(e[r]));
    }
  }
}

// ---------------------------------------------------------------------------
// the passes at D > 32: a warp a (chunk, 128-column tile)
// ---------------------------------------------------------------------------

// sorted: the flat ids rows[b, h] sorted (stable), order: the flat position
// b * hot + h each came from. Warp (c, blockIdx.y) owns chunk c's positions
// [c * kChunk, c * kChunk + len) and columns [d0, d0 + 128); lane l holds
// columns d0 + l, d0 + l + 32, ... Each lane reads one id and its dpooled
// row index, and the warp walks the chunk in order through shuffles, so
// every branch below is warp-uniform. All of the chunk's rows are loaded
// before the adds, which stay in position order.
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
  float x[kChunk][kColsPerLane];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int32_t id = __shfl_sync(0xffffffffu, my_id, j);
    const int row = __shfl_sync(0xffffffffu, my_row, j);
    const bool use = j < len && valid_id(id, vocab);
    const float* src = dpooled + static_cast<int64_t>(row) * dim;
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int d = d0 + k * 32 + lane;
      x[j][k] = use && d < dim ? src[d] : 0.f;
    }
  }
  float acc[kColsPerLane];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) acc[k] = 0.f;
  int start = 0;                        // the open segment's first position
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j >= len) break;
    const int32_t id = __shfl_sync(0xffffffffu, my_id, j);
    const int32_t next = __shfl_sync(0xffffffffu, my_id, (j + 1) & 31);
    const bool ok = valid_id(id, vocab);
    if (ok) {
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) acc[k] += x[j][k];
    }
    if (j + 1 < len && next == id) continue;        // the segment goes on
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

// ---------------------------------------------------------------------------
// the passes at D <= 32: a group of G lanes a chunk, one lane a column
// ---------------------------------------------------------------------------

// Group c (G consecutive lanes of the grid) owns chunk c; lane j of the
// group column j (j < dim). Every lane loads the chunk's 16 ids and rows
// itself (16-byte loads where the chunk is whole), then its 16 dpooled
// values, and walks the chunk in order as the D > 32 kernel does, with no
// shuffles: the groups of a warp walk different chunks.
template <int G>
__global__ void lookup_bwd_chunk_narrow_kernel(
    const int32_t* __restrict__ sorted, const int64_t* __restrict__ order,
    const float* __restrict__ dpooled, float* __restrict__ dtable,
    float* __restrict__ partial, int64_t n, int hot, int64_t vocab,
    int dim) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t c = t / G;
  const int j = static_cast<int>(t % G);
  const int64_t p0 = c * kChunk;
  if (p0 >= n) return;
  const int len = static_cast<int>(min(static_cast<int64_t>(kChunk), n - p0));
  int32_t ids[kChunk];
  int64_t pos[kChunk];
  if (len == kChunk) {
    const int4* i4 = reinterpret_cast<const int4*>(sorted + p0);
    const longlong2* o2 = reinterpret_cast<const longlong2*>(order + p0);
#pragma unroll
    for (int k = 0; k < kChunk / 4; ++k) {
      const int4 v = __ldg(i4 + k);
      ids[4 * k] = v.x;
      ids[4 * k + 1] = v.y;
      ids[4 * k + 2] = v.z;
      ids[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kChunk / 2; ++k) {
      const longlong2 v = __ldg(o2 + k);
      pos[2 * k] = v.x;
      pos[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      ids[k] = k < len ? __ldg(sorted + p0 + k) : -1;
      pos[k] = k < len ? __ldg(order + p0 + k) : 0;
    }
  }
  int32_t hi = -1;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k < len) hi = ids[k];
  }
  if (hi < 0 || ids[0] >= vocab) return;
  const int32_t before = p0 > 0 ? __ldg(sorted + p0 - 1) : -1;
  const int32_t after = p0 + kChunk < n ? __ldg(sorted + p0 + kChunk) : -1;
  float x[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const bool use = k < len && valid_id(ids[k], vocab) && j < dim;
    const int64_t row = hot == 1 ? pos[k] : pos[k] / hot;
    x[k] = use ? __ldg(dpooled + row * dim + j) : 0.f;
  }
  float acc = 0.f;
  int start = 0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k >= len) break;
    const int32_t id = ids[k];
    const bool ok = valid_id(id, vocab);
    if (ok) acc += x[k];
    if (k + 1 < len && ids[k + 1] == id) continue;
    if (ok && j < dim) {
      const bool enters = start == 0 && before == id;
      const bool leaves = k == kChunk - 1 && after == id;
      float* dst = enters   ? partial + (2 * c) * dim
                   : leaves ? partial + (2 * c + 1) * dim
                            : dtable + static_cast<int64_t>(id) * dim;
      dst[j] = acc;
    }
    acc = 0.f;
    start = k + 1;
  }
}

// Warp b looks at the boundary between chunks b - 1 and b, as the D > 32
// merge does. Its lanes are 32 / G slots of G columns: a round loads the
// entering partials of the next 32 / G chunks at once (slot s chunk c0 +
// s, while the run goes on into it) and folds them in chunk order through
// shuffles onto chunk b - 1's leaving segment; slot 0 writes dtable[id].
template <int G>
__global__ void lookup_bwd_merge_narrow_kernel(
    const int32_t* __restrict__ sorted, const float* __restrict__ partial,
    float* __restrict__ dtable, int64_t n, int64_t vocab, int dim) {
  constexpr int kSlots = 32 / G;
  const int lane = threadIdx.x & 31;
  const int slot = lane / G, j = lane % G;
  const int64_t b = 1 + strided_warp();
  const int64_t pb = b * kChunk;
  if (pb >= n) return;
  const int32_t id = __ldg(sorted + pb);
  if (!valid_id(id, vocab) || __ldg(sorted + pb - 1) != id) return;
  if (b >= 2 && __ldg(sorted + pb - kChunk - 1) == id) return;
  float acc = j < dim ? partial[(2 * (b - 1) + 1) * dim + j] : 0.f;
  for (int64_t c0 = b;; c0 += kSlots) {
    const int64_t c = c0 + slot;
    // the run is contiguous and began before chunk b: it goes on into
    // chunk c > b iff c's first id is still this one
    const bool in =
        c == b || (c * kChunk < n && __ldg(sorted + c * kChunk) == id);
    const float x = in && j < dim ? partial[(2 * c) * dim + j] : 0.f;
    const unsigned ins = __ballot_sync(0xffffffffu, in);
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const float y = __shfl_sync(0xffffffffu, x, u * G + j);
      if ((ins >> (u * G)) & 1u) acc += y;
    }
    if (ins != 0xffffffffu) break;
  }
  if (slot == 0 && j < dim) dtable[static_cast<int64_t>(id) * dim + j] = acc;
}

template <int G>
void launch_narrow(const int32_t* sorted, const int64_t* order,
                   const float* dpooled, float* dtable, float* partial,
                   long long n, long long chunks, int hot, long long vocab,
                   int dim, cudaStream_t s) {
  // small blocks for the chunk pass: a short list's few chunks still
  // spread over many SMs
  constexpr int kThreads = 64;
  const long long groups = chunks * G;
  lookup_bwd_chunk_narrow_kernel<G>
      <<<static_cast<unsigned>((groups + kThreads - 1) / kThreads), kThreads,
         0, s>>>(sorted, order, dpooled, dtable, partial, n, hot, vocab,
                 dim);
  if (chunks > 1) {
    lookup_bwd_merge_narrow_kernel<G>
        <<<static_cast<unsigned>((chunks - 1 + kWarpsPerBlock - 1) /
                                 kWarpsPerBlock),
           kWarpsPerBlock * 32, 0, s>>>(sorted, partial, dtable, n, vocab,
                                        dim);
  }
}

template <int R>
int launch_sort_r(const int32_t* rows, int32_t* sorted, int64_t* order,
                  float* dtable, long long n, long long vocab,
                  long long words, int cs, int bits, size_t smem,
                  unsigned magic, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      lookup_bwd_sort_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kSortThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cs);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, lookup_bwd_sort_kernel<R>,
                                       &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(static_cast<unsigned>(cs * (clusters > 1 ? clusters
                                                              : 2)));
  err = cudaLaunchKernelEx(&cfg, lookup_bwd_sort_kernel<R>, rows, sorted,
                           order, dtable, n, vocab, words, bits, magic);
  return static_cast<int>(err);
}

// the fused sort and zero-fill: a cluster of the fewest blocks that hold
// the list (a power of two, at most 8) sorts; as many clusters of the same
// size as the card holds at once, less one, zero-fill
int launch_sort(const int32_t* rows, int32_t* sorted, int64_t* order,
                float* dtable, long long n, long long vocab, long long words,
                cudaStream_t s) {
  if (n > kSortMax || vocab >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the fewest blocks that hold the list where the fill is long (the sort
  // runs under it, and the fill's pace is the blocks that run it), a slot
  // a thread where it is short (the sort sets the pace)
  const long long per_block =
      words * static_cast<long long>(sizeof(float)) > kLongFillBytes
          ? static_cast<long long>(kSortThreads) * kSortRounds
          : kSortThreads;
  int cs = 1;
  while (cs < kSortCluster && cs * per_block < n) cs *= 2;
  const long long per = (n + cs - 1) / cs;
  // slots a thread: a power of two, so that few kernels cover every list
  int rounds = 1;
  while (static_cast<long long>(rounds) * kSortThreads < per) rounds *= 2;
  int bits = 1;
  while (bits < 32 && (1ull << bits) <= static_cast<uint64_t>(vocab) + 1) {
    ++bits;
  }
  auto smem_of = [](int r) {
    return static_cast<size_t>(r) * kSortThreads * sizeof(uint64_t) +
           static_cast<size_t>(kHalfBins) * kSortThreads * 33 / 32 *
               sizeof(uint32_t) +
           (kSortCluster * kMaxBins + kMaxBins + 33) * sizeof(int);
  };
  const size_t smem = smem_of(rounds);
  // dst / slots as a multiply-high (dst < 2^17, slots >= 1024)
  const unsigned magic = static_cast<unsigned>(
      ((1ull << 32) + rounds * kSortThreads - 1) / (rounds * kSortThreads));
  switch (rounds) {
    case 1: return launch_sort_r<1>(rows, sorted, order, dtable, n, vocab,
                                    words, cs, bits, smem, magic, s);
    case 2: return launch_sort_r<2>(rows, sorted, order, dtable, n, vocab,
                                    words, cs, bits, smem, magic, s);
    case 4: return launch_sort_r<4>(rows, sorted, order, dtable, n, vocab,
                                    words, cs, bits, smem, magic, s);
    case 8: return launch_sort_r<8>(rows, sorted, order, dtable, n, vocab,
                                    words, cs, bits, smem, magic, s);
    default: return launch_sort_r<16>(rows, sorted, order, dtable, n, vocab,
                                      words, cs, bits, smem, magic, s);
  }
}

}  // namespace

// rows: the flat ids (int32, n = B * hot); sorted: int32 [n] and order:
// int64 [n] positions, written here (sort = 1: n <= 32,768, dtable
// uninitialised and zero-filled here) or by the caller's stable sort (sort
// = 0: dtable already zero); partial: scratch of [2 * ceil(n / 16), dim]
// f32 (nothing in it is read before the chunk pass writes it). The
// launches go on the stream in order.
extern "C" int repro_lookup_bwd(const void* rows, void* sorted, void* order,
                                const void* dpooled, void* dtable,
                                void* partial, long long n, int hot,
                                long long vocab, int dim, int chunk, int sort,
                                void* stream) {
  // the caller sized partial for chunks of `chunk` positions
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(sorted);
  const int64_t* pos = static_cast<const int64_t*>(order);
  const float* dp = static_cast<const float*>(dpooled);
  float* dt = static_cast<float*>(dtable);
  float* part = static_cast<float*>(partial);
  if (sort) {
    const int rc = launch_sort(static_cast<const int32_t*>(rows),
                               static_cast<int32_t*>(sorted),
                               static_cast<int64_t*>(order), dt, n, vocab,
                               vocab * dim, s);
    if (rc != 0) return rc;
  }
  const long long chunks = (n + kChunk - 1) / kChunk;
  if (dim <= kNarrow) {
    const int g = dim <= 1 ? 1 : dim <= 2 ? 2 : dim <= 4 ? 4
                  : dim <= 8 ? 8 : dim <= 16 ? 16 : 32;
    switch (g) {
      case 1: launch_narrow<1>(ids, pos, dp, dt, part, n, chunks, hot, vocab,
                               dim, s); break;
      case 2: launch_narrow<2>(ids, pos, dp, dt, part, n, chunks, hot, vocab,
                               dim, s); break;
      case 4: launch_narrow<4>(ids, pos, dp, dt, part, n, chunks, hot, vocab,
                               dim, s); break;
      case 8: launch_narrow<8>(ids, pos, dp, dt, part, n, chunks, hot, vocab,
                               dim, s); break;
      case 16: launch_narrow<16>(ids, pos, dp, dt, part, n, chunks, hot,
                                 vocab, dim, s); break;
      default: launch_narrow<32>(ids, pos, dp, dt, part, n, chunks, hot,
                                 vocab, dim, s); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned tiles = static_cast<unsigned>((dim + kTileCols - 1) /
                                               kTileCols);
  const dim3 grid(static_cast<unsigned>((chunks + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock), tiles);
  lookup_bwd_chunk_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
      ids, pos, dp, dt, part, n, hot, vocab, dim);
  if (chunks > 1) {
    const dim3 mgrid(static_cast<unsigned>((chunks - 1 + kWarpsPerBlock - 1) /
                                           kWarpsPerBlock), tiles);
    lookup_bwd_merge_kernel<<<mgrid, kWarpsPerBlock * 32, 0, s>>>(
        ids, part, dt, n, vocab, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1, one table: payload [V, dim] (table_dtype 0 = float32, 1 = float16, 2
// = bfloat16), slots [batch, hot] int32 (-1 = pad) -> out [batch, dim] f32.
extern "C" int repro_lookup_fwd_one(const void* payload, const void* slots,
                                    int hot, int table_dtype, long long batch,
                                    int dim, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0:
      return pooled::launch_one<float, false>(payload, nullptr, slots, hot,
                                              batch, dim, out, s);
    case 1:
      return pooled::launch_one<__half, false>(payload, nullptr, slots, hot,
                                               batch, dim, out, s);
    case 2:
      return pooled::launch_one<__nv_bfloat16, false>(payload, nullptr, slots,
                                                      hot, batch, dim, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The grouped K1: `tables` (<= 64) tables of `dim` columns and one type
// (table_dtype 0 = float32, 1 = float16, 2 = bfloat16); payloads and slots
// hold each table's device pointer, hots its H (slots [batch, H] int32, -1 =
// pad); out[b * out_stride + t * dim + d] f32. The pointer arrays live in
// host memory and travel in the launch's parameters.
extern "C" int repro_lookup_fwd(const void* const* payloads,
                                const void* const* slots, const int* hots,
                                int tables, int table_dtype, long long batch,
                                int dim, void* out, long long out_stride,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0:
      return pooled::launch<float, false>(payloads, nullptr, slots, hots,
                                          tables, batch, dim, out, out_stride,
                                          s);
    case 1:
      return pooled::launch<__half, false>(payloads, nullptr, slots, hots,
                                           tables, batch, dim, out,
                                           out_stride, s);
    case 2:
      return pooled::launch<__nv_bfloat16, false>(payloads, nullptr, slots,
                                                  hots, tables, batch, dim,
                                                  out, out_stride, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The grouped pooled row read shared by K1 (lookup_fwd, embedding_lookup.cu)
// and K6 (dequant_gather_rows, hps_gather.cu), for Hopper (sm_90a).
//
// out[b, t, :] = sum over h < hot_t, in order of h from a zero start, of
// row(payload_t, slots_t[b, h]) in f32, where a -1 slot adds nothing and
// row() is float(payload[s]) (K1) or float(payload[s]) * scales[s] (K6, the
// product rounded before the add). One launch covers up to kMaxTables
// tables that share the row width D and the payload type; each table has
// its own payload, scales, slots [B, hot_t] and hot_t. The descriptors
// travel in one struct by value (kernel parameter space, read through the
// constant cache): no host-to-device copy and no sync, so a launch can be
// captured in a CUDA graph. One table is the training and LM lookup (K1's
// lookup_fwd), and one table with hot = 1 the cache's row read (K5's
// gather_rows, K6's dequant_gather_rows). A one-table launch (launch_one)
// takes its pointers as scalars and carries a one-entry descriptor array,
// so its parameters are about 70 bytes, not 2 KB, and the host builds no
// pointer arrays.
//
// The owner-mapped form (kMesh, K5 / K6's mesh half) reads one cache-mesh
// entry's block of a striped L1 at GLOBAL slots, an owned slot at its local
// row: an entry that does not pool places the rows of its own stripes in a
// rows buffer; the pooling entry sums every output row's slots in order of
// h from a zero start, its own from its block and the others' from the
// buffer. The sum is the one-device read's, bit for bit. Same units and
// lanes.
//
// What bounds it: memory, and at the served shape the launch. A row of the
// output reads hot_t payload rows and writes D floats.
//
// Design: output rows are numbered r = b * tables + t, so consecutive rows
// are consecutive in out. A row moves in units of four elements, each read
// by one vector load (16 bytes of f32, 8 of f16 or bf16, 4 of int8) and
// written as one float4, wherever D is a multiple of 4 and the pointers are
// aligned to a unit; otherwise in single elements (D = 1, D = 33, a payload
// that starts off a unit). A row has the largest power of two of lanes, up
// to 32, that its units fill: a warp per row of 128 in every type, so each
// store instruction writes 512 contiguous bytes whatever the payload type.
// A lane group takes one item: a whole row, one unit a lane, or, for a row
// with more units than lanes (D = 3072: 768 f32 units), one pass of
// kWideItems units a lane, consecutive groups taking a row's consecutive
// passes. A lane reads its row's slots itself (the lanes of a row read the
// same word, one transaction), then issues the pass's payload loads, then
// adds. Small items and many warps, rather than several rows in flight a
// warp, keep the card's memory busy at these shapes.
//
// Why not 16-byte loads for every type: a quarter-warp per int8 row then
// writes each float4 64 bytes from its neighbour lane's, and the grouped
// int8 read took twice as long; and several rows in flight a warp lost to
// more, smaller warps (PERF.md section 6 has the variants' times).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace pooled {

constexpr int kMaxTables = 64;
constexpr int kWarpsPerBlock = 8;
constexpr int kWideItems = 4;   // units a lane keeps in flight, wide rows

struct Table {
  const void* payload;       // [C, D] of the payload type
  const float* scales;       // [C] f32 (K6 only)
  const int32_t* slots;      // [B, hot] int32, -1 = hole
  int hot;
  int stripe_rows;           // kMesh: rows a stripe (Cl)
  int col;                   // kMesh: the table's first row column in rows
};

// The owner-mapped read (kMesh): the L1 has `stripes` stripes, slot s in
// stripe s % stripes at row s / stripes of it; the launch's blocks hold
// the `owned` stripes from `first` on ([owned, Cl, D] a table). rows [B,
// W, D] f32 (W the tables' H summed, table t's slot h at column col + h)
// carries the other entries' rows: an entry that does not pool (pool = 0)
// writes there the rows of its own stripes and nothing else; the pooling
// entry sums each output row's H rows in order, its own from its block and
// the others' from rows. With H = 1 everywhere, rows may be out itself.
struct Mesh {
  float* rows;
  long long rows_stride;     // floats from one b of rows to the next
  int stripes;
  int first;
  int owned;
  int pool;
};

template <int N>
struct GroupN {
  Table t[N];
  float* out;                // out[b * out_stride + t * dim + d]
  long long out_stride;
  int batch;
  int tables;
  int dim;
  int units;                 // units (or elements) of a row
  int lanes_log;             // log2 of the lanes of a row
  Mesh mesh;                 // kMesh only
};
using Group = GroupN<kMaxTables>;

template <typename To>
__device__ __forceinline__ To bits(uint32_t w) {
  To v;
  memcpy(&v, &w, sizeof(To));
  return v;
}

// A unit: four elements of T, one float4 of the output. Load is the
// vector type that reads it (16 bytes of f32, 8 of f16 or bf16, 4 of int8).
template <typename T> struct Unit;
template <> struct Unit<float> {
  using Load = uint4;
  static __device__ __forceinline__ float4 unpack(Load v) {
    return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                       __uint_as_float(v.z), __uint_as_float(v.w));
  }
};
template <> struct Unit<__half> {
  using Load = uint2;
  static __device__ __forceinline__ float4 unpack(Load v) {
    const float2 a = __half22float2(bits<__half2>(v.x));
    const float2 b = __half22float2(bits<__half2>(v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
template <> struct Unit<__nv_bfloat16> {
  using Load = uint2;
  static __device__ __forceinline__ float4 unpack(Load v) {
    const float2 a = __bfloat1622float2(bits<__nv_bfloat162>(v.x));
    const float2 b = __bfloat1622float2(bits<__nv_bfloat162>(v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
template <> struct Unit<int8_t> {
  using Load = uint32_t;
  static __device__ __forceinline__ float4 unpack(Load v) {
    return make_float4(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                       static_cast<float>(static_cast<int8_t>(v >> 8 & 0xff)),
                       static_cast<float>(static_cast<int8_t>(v >> 16 & 0xff)),
                       static_cast<float>(static_cast<int8_t>(v >> 24)));
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// kVec: units of four elements (one float4 of the output each), else
// single elements. kWide: a row has more units than lanes, and a lane group
// takes one pass over it (kWideItems units a lane); else a lane group takes a
// whole row, one unit a lane. One such item a lane group. kOne: every table
// has hot = 1, so a row's one slot is read without a loop (at the cache
// query's size the loop's test before the first load showed, PERF.md
// section 6). kMesh: the slots are GLOBAL slots of a striped L1 and the
// payload one mesh entry's block of its stripes (the owner-mapped read,
// struct Mesh). N: the capacity of the descriptor array (kMaxTables, or 1
// for a one-table launch).
template <typename T, bool kScaled, bool kVec, bool kWide, bool kOne,
          bool kMesh, int N>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    pooled_read_kernel(const __grid_constant__ GroupN<N> g) {
  using Load = typename Unit<T>::Load;
  constexpr int kItems = kWide ? kWideItems : 1;
  const int lane = threadIdx.x & 31;
  const int lanes_log = g.lanes_log;
  const int li = lane & ((1 << lanes_log) - 1);
  // consecutive lane groups take consecutive items, so a warp's stores run
  // over consecutive rows (narrow) or one row's consecutive passes (wide)
  const long long item =
      ((static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
        (threadIdx.x >> 5)) << (5 - lanes_log)) + (lane >> lanes_log);
  const int span = kItems << lanes_log;          // units a pass covers
  const int passes = kWide ? (g.units + span - 1) / span : 1;
  const long long row = item / passes;
  if (row >= static_cast<long long>(g.batch) * g.tables) return;
  const int u0 = static_cast<int>(item - row * passes) * span + li;
  const int b = static_cast<int>(N == 1 ? row : row / g.tables);
  const int t = N == 1 ? 0 : static_cast<int>(
      row - static_cast<long long>(b) * g.tables);
  const Table& tb = g.t[t];
  float4 acc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int hot = kOne ? 1 : tb.hot;
  // kMesh: this entry places its rows (write) or pools every row (pool)
  const bool write = kMesh && !g.mesh.pool;
  for (int h = 0; h < hot; ++h) {
    int32_t id = __ldg(tb.slots + static_cast<long long>(b) * hot + h);
    if (id < 0) continue;
    float* w = nullptr;      // write: where this slot's row goes in rows
    if (kMesh) {
      const unsigned stripe = static_cast<unsigned>(id) %
                              static_cast<unsigned>(g.mesh.stripes);
      float* const r = g.mesh.rows + static_cast<long long>(b) *
                       g.mesh.rows_stride +
                       static_cast<long long>(tb.col + h) * g.dim;
      if (stripe - static_cast<unsigned>(g.mesh.first) >=
          static_cast<unsigned>(g.mesh.owned)) {
        if (write) continue;           // another entry's stripe
        // pool: its owner placed the row in rows before this launch
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int u = u0 + (i << lanes_log);
          if (u >= g.units) continue;
          if (kVec) {
            const float4 f = reinterpret_cast<const float4*>(r)[u];
            acc[i].x += f.x;
            acc[i].y += f.y;
            acc[i].z += f.z;
            acc[i].w += f.w;
          } else {
            acc[i].x += r[u];
          }
        }
        continue;
      }
      id = static_cast<int32_t>(
          (stripe - g.mesh.first) * static_cast<unsigned>(tb.stripe_rows) +
          static_cast<unsigned>(id) / static_cast<unsigned>(g.mesh.stripes));
      if (write) w = r;
    }
    const float sc = kScaled ? __ldg(tb.scales + id) : 1.f;
    const T* src = static_cast<const T*>(tb.payload) +
                   static_cast<long long>(id) * g.dim;
    if (kVec) {
      Load v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int u = u0 + (i << lanes_log);
        if (u < g.units) v[i] = __ldg(reinterpret_cast<const Load*>(src) + u);
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int u = u0 + (i << lanes_log);
        if (u >= g.units) continue;
        float4 f = Unit<T>::unpack(v[i]);
        if (kScaled) {
          f.x = __fmul_rn(f.x, sc);
          f.y = __fmul_rn(f.y, sc);
          f.z = __fmul_rn(f.z, sc);
          f.w = __fmul_rn(f.w, sc);
        }
        if (write) {
          reinterpret_cast<float4*>(w)[u] = f;
          continue;
        }
        acc[i].x += f.x;
        acc[i].y += f.y;
        acc[i].z += f.z;
        acc[i].w += f.w;
      }
    } else {
      T v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int u = u0 + (i << lanes_log);
        if (u < g.units) v[i] = src[u];
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int u = u0 + (i << lanes_log);
        if (u >= g.units) continue;
        const float f0 = to_f32(v[i]);
        const float f = kScaled ? __fmul_rn(f0, sc) : f0;
        if (write)
          w[u] = f;
        else
          acc[i].x += f;
      }
    }
  }
  if (write) return;
  float* o = g.out + static_cast<long long>(b) * g.out_stride +
             static_cast<long long>(t) * g.dim;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int u = u0 + (i << lanes_log);
    if (u >= g.units) continue;
    if (kVec)
      reinterpret_cast<float4*>(o)[u] = acc[i];
    else
      o[u] = acc[i].x;
  }
}

template <typename T, bool kScaled, bool kVec, bool kWide, bool kOne,
          bool kMesh, int N>
void start(const GroupN<N>& g, long long nrows, cudaStream_t stream) {
  const int span = (kWide ? kWideItems : 1) << g.lanes_log;
  const long long items = nrows * ((g.units + span - 1) / span);
  const long long warps = (items + (32 >> g.lanes_log) - 1) >>
                          (5 - g.lanes_log);
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pooled_read_kernel<T, kScaled, kVec, kWide, kOne, kMesh, N>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(g);
}

template <typename T, bool kScaled, bool kVec, bool kMesh, int N>
void start_rows(const GroupN<N>& g, bool wide, bool one, long long nrows,
                cudaStream_t stream) {
  if (wide) {
    if (one) start<T, kScaled, kVec, true, true, kMesh>(g, nrows, stream);
    else start<T, kScaled, kVec, true, false, kMesh>(g, nrows, stream);
  } else {
    if (one) start<T, kScaled, kVec, false, true, kMesh>(g, nrows, stream);
    else start<T, kScaled, kVec, false, false, kMesh>(g, nrows, stream);
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Choose the unit (vec: every payload and out aligned to four elements)
// and the lanes a row of g's filled descriptors, and launch; one: every
// table has hot = 1.
template <typename T, bool kScaled, bool kMesh, int N>
int run(GroupN<N>& g, bool vec, bool one, cudaStream_t stream) {
  g.units = vec ? g.dim / 4 : g.dim;
  g.lanes_log = 0;
  while (g.lanes_log < 5 && (2 << g.lanes_log) <= g.units) ++g.lanes_log;
  const bool wide = g.units > (1 << g.lanes_log);
  const long long nrows = static_cast<long long>(g.batch) * g.tables;
  if (vec) start_rows<T, kScaled, true, kMesh>(g, wide, one, nrows, stream);
  else start_rows<T, kScaled, false, kMesh>(g, wide, one, nrows, stream);
  return static_cast<int>(cudaGetLastError());
}

// The owner-mapped geometry a launch may take: stripes >= 1, the owned
// stripes inside them.
inline bool mesh_ok(const Mesh& m) {
  return m.rows_stride >= 0 && m.stripes >= 1 && m.first >= 0 &&
         m.owned >= 1 && m.first + m.owned <= m.stripes;
}

// The grouped C entry points' common body: pack the descriptors, choose the
// unit and the lanes a row, launch. payloads, scales (K6; nullptr for K1),
// slots: `tables` device pointers each, in host memory; hots: H per table.
// kMesh: the owner-mapped read of `mesh`, stripe_rows each table's Cl and
// cols its first column in mesh.rows.
template <typename T, bool kScaled, bool kMesh = false>
int launch(const void* const* payloads, const void* const* scales,
           const void* const* slots, const int* hots, int tables,
           long long batch, int dim, void* out, long long out_stride,
           cudaStream_t stream, const int* stripe_rows = nullptr,
           const int* cols = nullptr, Mesh mesh = Mesh{}) {
  if (tables < 1 || tables > kMaxTables || batch < 0 || dim < 0 ||
      batch * tables > 0x7fffffffLL || (kMesh && !mesh_ok(mesh)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || dim == 0) return static_cast<int>(cudaGetLastError());
  Group g;
  memset(&g, 0, sizeof(g));
  // units of four elements: the payload rows and out (and rows) aligned
  // to them
  bool vec = dim % 4 == 0 && out_stride % 4 == 0 && aligned(out, 16) &&
             (!kMesh || (mesh.rows_stride % 4 == 0 && aligned(mesh.rows, 16)));
  bool one = true;
  for (int t = 0; t < tables; ++t) {
    g.t[t].payload = payloads[t];
    g.t[t].scales = kScaled ? static_cast<const float*>(scales[t]) : nullptr;
    g.t[t].slots = static_cast<const int32_t*>(slots[t]);
    g.t[t].hot = hots[t];
    g.t[t].stripe_rows = kMesh ? stripe_rows[t] : 0;
    g.t[t].col = kMesh ? cols[t] : 0;
    vec = vec && aligned(payloads[t], 4 * sizeof(T));
    one = one && hots[t] == 1;
  }
  g.out = static_cast<float*>(out);
  g.out_stride = out_stride;
  g.batch = static_cast<int>(batch);
  g.tables = tables;
  g.dim = dim;
  g.mesh = mesh;
  return run<T, kScaled, kMesh>(g, vec, one, stream);
}

// The one-table entry points' body: payload [C, dim], scales [C] (K6;
// nullptr for K1 and K5), slots [batch, hot] int32 -> out [batch, dim] f32,
// contiguous. kMesh: the owner-mapped read of `mesh`, the payload [owned,
// stripe_rows, dim], its rows from column 0 of mesh.rows.
template <typename T, bool kScaled, bool kMesh = false>
int launch_one(const void* payload, const void* scales, const void* slots,
               int hot, long long batch, int dim, void* out,
               cudaStream_t stream, int stripe_rows = 0,
               Mesh mesh = Mesh{}) {
  if (hot < 0 || batch < 0 || dim < 0 || batch > 0x7fffffffLL ||
      (kMesh && (!mesh_ok(mesh) || stripe_rows < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || dim == 0) return static_cast<int>(cudaGetLastError());
  GroupN<1> g;
  g.t[0].payload = payload;
  g.t[0].scales = static_cast<const float*>(scales);
  g.t[0].slots = static_cast<const int32_t*>(slots);
  g.t[0].hot = hot;
  g.t[0].stripe_rows = stripe_rows;
  g.t[0].col = 0;
  g.out = static_cast<float*>(out);
  g.out_stride = dim;
  g.batch = static_cast<int>(batch);
  g.tables = 1;
  g.dim = dim;
  g.mesh = mesh;
  const bool vec =
      dim % 4 == 0 && aligned(out, 16) && aligned(payload, 4 * sizeof(T)) &&
      (!kMesh || (mesh.rows_stride % 4 == 0 && aligned(mesh.rows, 16)));
  return run<T, kScaled, kMesh>(g, vec, hot == 1, stream);
}

}  // namespace pooled

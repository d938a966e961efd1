// The HPS host stage's index and row passes, in host C++: the exact
// id -> slot map behind the L1's and each L2 shard's index, the L1 probe's
// two passes, an L2 shard's query and insert, and the L3's row gather.
//
// Built by the host compiler (no CUDA, no PyTorch headers) into a library
// of its own and bound with ctypes.PyDLL (core/hps/_host.py): a call keeps
// the interpreter lock. Nothing here is thread-safe: the caller
// holds the owner's lock (the cache's, the namespace's, the store's) for
// the whole call, and keeps every buffer it passes alive until it returns.
// Every decision these passes make is the numpy reference's: np.unique's
// ascending order, the misses in that order, the same IEEE double adds.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

namespace {

inline uint64_t mix(int64_t key) {  // splitmix64's finaliser
  uint64_t x = static_cast<uint64_t>(key) + 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Open addressing with linear probing over a power-of-two table kept at a
// load of at most 0.5; a negative value marks an empty cell (slots are >=
// 0), so every int64 key can be mapped. Deletion shifts the cluster back:
// no tombstones, so a map that evicts as often as it inserts stays short.
struct Map {
  struct Cell {
    int64_t key, val;  // val < 0: empty
  };
  std::vector<Cell> cells;  // a key and its slot share a cache line
  uint64_t mask = 0;
  int64_t size = 0;

  explicit Map(int64_t want) { alloc(want); }

  void alloc(int64_t want) {
    uint64_t cap = 16;
    while (cap < 2 * static_cast<uint64_t>(want)) cap <<= 1;
    cells.assign(cap, Cell{0, -1});
    mask = cap - 1;
  }

  // start the load of key's home cell (a table of 100,000s of ids lies
  // in memory, not in cache: the passes prefetch a few keys ahead)
  void prefetch(int64_t key) const {
    __builtin_prefetch(&cells[mix(key) & mask]);
  }

  int64_t find(int64_t key) const {
    for (uint64_t i = mix(key) & mask;; i = (i + 1) & mask) {
      const Cell& c = cells[i];
      if (c.val < 0) return -1;
      if (c.key == key) return c.val;
    }
  }

  // room for `more` new keys at a load of at most 0.5
  void reserve(int64_t more) {
    if (2 * (size + more) <= static_cast<int64_t>(mask + 1)) return;
    std::vector<Cell> old = std::move(cells);
    alloc(size + more);
    for (const Cell& c : old) {
      if (c.val < 0) continue;
      uint64_t j = mix(c.key) & mask;
      while (cells[j].val >= 0) j = (j + 1) & mask;
      cells[j] = c;
    }
  }

  // map key -> val (val >= 0), over an old value; room reserved
  void put(int64_t key, int64_t val) {
    uint64_t i = mix(key) & mask;
    for (; cells[i].val >= 0; i = (i + 1) & mask) {
      if (cells[i].key == key) {
        cells[i].val = val;
        return;
      }
    }
    cells[i] = Cell{key, val};
    ++size;
  }

  bool erase(int64_t key) {
    uint64_t i = mix(key) & mask;
    for (;; i = (i + 1) & mask) {
      if (cells[i].val < 0) return false;
      if (cells[i].key == key) break;
    }
    // the hole at i takes each later cluster member whose probe path from
    // its home cell passes over i
    for (uint64_t j = (i + 1) & mask; cells[j].val >= 0; j = (j + 1) & mask) {
      uint64_t home = mix(cells[j].key) & mask;
      if (((j - home) & mask) >= ((j - i) & mask)) {
        cells[i] = cells[j];
        i = j;
      }
    }
    cells[i].val = -1;
    --size;
    return true;
  }
};

// how many keys ahead a pass prefetches
constexpr int64_t AHEAD = 8;

// the per-thread scratch of a pass's sort: (id, position) pairs
using Pair = std::pair<int64_t, int64_t>;
thread_local std::vector<Pair> sort_buf, sort_tmp;

// Sort a[0..n) by id (the positions ride along): an LSD radix sort of
// 8-bit digits over id - min, as many passes as max - min has bytes
// (three for a vocabulary of millions), with no data-dependent branch.
void sort_by_id(Pair* a, Pair* tmp, int64_t n) {
  if (n < 2) return;
  int64_t lo = a[0].first, hi = a[0].first;
  for (int64_t i = 1; i < n; ++i) {
    lo = std::min(lo, a[i].first);
    hi = std::max(hi, a[i].first);
  }
  const uint64_t base = static_cast<uint64_t>(lo);
  const uint64_t span = static_cast<uint64_t>(hi) - base;
  Pair* src = a;
  Pair* dst = tmp;
  for (int shift = 0; shift < 64 && (span >> shift); shift += 8) {
    int64_t start[257] = {0};
    for (int64_t i = 0; i < n; ++i)
      ++start[1 + (((static_cast<uint64_t>(src[i].first) - base) >> shift)
                   & 255)];
    for (int d = 0; d < 256; ++d) start[d + 1] += start[d];
    for (int64_t i = 0; i < n; ++i)
      dst[start[((static_cast<uint64_t>(src[i].first) - base) >> shift)
                & 255]++] = src[i];
    std::swap(src, dst);
  }
  if (src != a) std::copy(src, src + n, a);
}

}  // namespace

extern "C" {

// -- the map ---------------------------------------------------------------

// A map of ids[i] -> slots[i] (n may be 0); null when a slot is negative,
// an id repeats, or memory runs out.
void* hps_map_new(const int64_t* ids, const int64_t* slots, int64_t n) {
  Map* m = new (std::nothrow) Map(n);
  if (m == nullptr) return nullptr;
  try {
    for (int64_t i = 0; i < n; ++i) {
      if (slots[i] < 0) throw 0;
      m->put(ids[i], slots[i]);
    }
    if (m->size != n) throw 0;
  } catch (...) {
    delete m;
    return nullptr;
  }
  return m;
}

void hps_map_free(void* map) { delete static_cast<Map*>(map); }

int64_t hps_map_size(const void* map) {
  return static_cast<const Map*>(map)->size;
}

// out[i]: the slot of ids[i], -1 where it is not mapped
void hps_map_find(const void* map, const int64_t* ids, int64_t n,
                  int64_t* out) {
  const Map* m = static_cast<const Map*>(map);
  for (int64_t i = 0; i < n; ++i) {
    if (i + AHEAD < n) m->prefetch(ids[i + AHEAD]);
    out[i] = m->find(ids[i]);
  }
}

// Unmap gone[0..ng), then map ids[i] -> slots[i]. Returns 0; 1 + i when
// gone[i] was not mapped (nothing after it done); -1 for a negative slot;
// -2 when memory runs out.
int64_t hps_map_update(void* map, const int64_t* gone, int64_t ng,
                       const int64_t* ids, const int64_t* slots, int64_t n) {
  Map* m = static_cast<Map*>(map);
  for (int64_t i = 0; i < n; ++i)
    if (slots[i] < 0) return -1;
  for (int64_t i = 0; i < ng; ++i)
    if (!m->erase(gone[i])) return 1 + i;
  try {
    m->reserve(n);
  } catch (...) {
    return -2;
  }
  for (int64_t i = 0; i < n; ++i) m->put(ids[i], slots[i]);
  return 0;
}

// every (id, slot) in the table's order
void hps_map_dump(const void* map, int64_t* ids, int64_t* slots) {
  const Map* m = static_cast<const Map*>(map);
  int64_t k = 0;
  for (const Map::Cell& c : m->cells) {
    if (c.val < 0) continue;
    ids[k] = c.key;
    slots[k] = c.val;
    ++k;
  }
}

// -- the L1 probe ------------------------------------------------------------

// The rows of `work` ([L1_ROWS, ld] int64, ld >= n), as core/hps/_host.py
// names them.
enum {
  W_IDS,         // in: the probe's ids
  W_UNIQ,        // np.unique(max(ids, -1)): ascending, the pad entry first
  W_COUNTS,      // each unique id's count
  W_INV,         // each id's position in W_UNIQ
  W_SLOTS_U,     // each unique id's slot, -1 for a miss and the pad
  W_MISS_POS,    // the misses' positions in W_UNIQ, in its order
  W_MISS_IDS,    // the misses' ids
  W_MISS_COUNTS, // the misses' counts
  W_HIT_SLOTS,   // the hits' slots, in W_UNIQ's order
  W_OUT,         // out: each id's slot
  L1_ROWS
};

// Pass 1: the dedup, the search, the counts, the hits' LFU update and each
// id's slot (-1 for a miss or a pad). info: [unique ids, hit ids, pad ids,
// unique misses, unique hits]. Returns 0, or -2 when memory runs out.
int64_t hps_l1_pass1(const void* map, int64_t n, double* freq,
                     int64_t* work, int64_t ld, int64_t* info) {
  const Map* m = static_cast<const Map*>(map);
  const int64_t* ids = work + W_IDS * ld;
  int64_t* uniq = work + W_UNIQ * ld;
  int64_t* counts = work + W_COUNTS * ld;
  int64_t* inv = work + W_INV * ld;
  int64_t* slots_u = work + W_SLOTS_U * ld;
  int64_t* miss_pos = work + W_MISS_POS * ld;
  int64_t* miss_ids = work + W_MISS_IDS * ld;
  int64_t* miss_counts = work + W_MISS_COUNTS * ld;
  int64_t* hit_slots = work + W_HIT_SLOTS * ld;
  int64_t* out = work + W_OUT * ld;
  try {
    sort_buf.resize(n);
    sort_tmp.resize(n);
  } catch (...) {
    return -2;
  }
  for (int64_t i = 0; i < n; ++i)
    sort_buf[i] = {ids[i] < -1 ? -1 : ids[i], i};
  sort_by_id(sort_buf.data(), sort_tmp.data(), n);
  int64_t nu = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (nu == 0 || sort_buf[i].first != uniq[nu - 1]) {
      uniq[nu] = sort_buf[i].first;
      counts[nu] = 0;
      ++nu;
    }
    ++counts[nu - 1];
    inv[sort_buf[i].second] = nu - 1;
  }
  int64_t n_hit = 0, k = 0, nh = 0;
  for (int64_t u = 0; u < nu; ++u) {
    if (u + AHEAD < nu) m->prefetch(uniq[u + AHEAD]);
    if (uniq[u] < 0) {  // the pad entry
      slots_u[u] = -1;
      continue;
    }
    int64_t s = m->find(uniq[u]);
    slots_u[u] = s;
    if (s >= 0) {
      freq[s] += static_cast<double>(counts[u]);
      n_hit += counts[u];
      hit_slots[nh++] = s;
    } else {
      miss_pos[k] = u;
      miss_ids[k] = uniq[u];
      miss_counts[k] = counts[u];
      ++k;
    }
  }
  for (int64_t i = 0; i < n; ++i) out[i] = slots_u[inv[i]];
  info[0] = nu;
  info[1] = n_hit;
  info[2] = (nu && uniq[0] < 0) ? counts[0] : 0;
  info[3] = k;
  info[4] = nh;
  return 0;
}

// Pass 2: the misses sel[j] (j < ins; sel null: j itself) move into slots
// dest[j], of which dest[n_free..ins) are evicted residents. Unmaps the
// evicted ids and maps the new ones, writes id_of, freq (the miss counts)
// and dirty (cleared) at dest, and each id's slot into W_OUT (-1 for an
// overflowed miss). Returns 0; 1 + j when dest[n_free + j] held no mapped
// id; -2 when memory runs out.
int64_t hps_l1_pass2(void* map, int64_t n, int64_t* id_of, double* freq,
                     uint8_t* dirty, int64_t* work, int64_t ld,
                     const int64_t* sel, const int64_t* dest, int64_t ins,
                     int64_t n_free) {
  Map* m = static_cast<Map*>(map);
  int64_t* inv = work + W_INV * ld;
  int64_t* slots_u = work + W_SLOTS_U * ld;
  const int64_t* miss_pos = work + W_MISS_POS * ld;
  const int64_t* miss_ids = work + W_MISS_IDS * ld;
  const int64_t* miss_counts = work + W_MISS_COUNTS * ld;
  int64_t* out = work + W_OUT * ld;
  for (int64_t j = n_free; j < ins; ++j)
    if (!m->erase(id_of[dest[j]])) return 1 + (j - n_free);
  try {
    m->reserve(ins);
  } catch (...) {
    return -2;
  }
  for (int64_t j = 0; j < ins; ++j) {
    int64_t s = sel ? sel[j] : j;
    int64_t d = dest[j];
    m->put(miss_ids[s], d);
    id_of[d] = miss_ids[s];
    freq[d] = static_cast<double>(miss_counts[s]);
    dirty[d] = 0;
    slots_u[miss_pos[s]] = d;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = slots_u[inv[i]];
  return 0;
}

// -- an L2 shard ---------------------------------------------------------------

// The ids at pos[0..m) (pos null: 0..m) searched in one shard: each hit's
// row copied from srows into out_rows at its position, its tick set to now,
// its mask byte set. Returns the hits.
int64_t hps_l2_query(const void* map, const int64_t* ids, const int64_t* pos,
                     int64_t m, const float* srows, int64_t dim,
                     int64_t* tick, int64_t now, float* out_rows,
                     uint8_t* mask) {
  const Map* mp = static_cast<const Map*>(map);
  int64_t hits = 0;
  for (int64_t j = 0; j < m; ++j) {
    if (j + AHEAD < m) mp->prefetch(ids[pos ? pos[j + AHEAD] : j + AHEAD]);
    int64_t p = pos ? pos[j] : j;
    int64_t s = mp->find(ids[p]);
    if (s < 0) continue;
    std::memcpy(out_rows + p * dim, srows + s * dim, dim * sizeof(float));
    tick[s] = now;
    mask[p] = 1;
    ++hits;
  }
  return hits;
}

// Insert k ids, strictly ascending, with their rows: each resident id's row
// and tick updated in place; the others' positions written to miss, in
// order. When they fit in the free slots [n, cap) they are appended there
// (mapped, id_of, rows, tick). info: [misses, 1 if appended]. Returns 0;
// 1 when the ids are not strictly ascending (nothing done); -2 when memory
// runs out.
int64_t hps_l2_insert(void* map, const int64_t* ids, const float* rows,
                      int64_t k, int64_t dim, float* srows, int64_t* tick,
                      int64_t* id_of, int64_t now, int64_t n, int64_t cap,
                      int64_t* miss, int64_t* info) {
  Map* mp = static_cast<Map*>(map);
  for (int64_t j = 1; j < k; ++j)
    if (ids[j] <= ids[j - 1]) return 1;
  int64_t nm = 0;
  for (int64_t j = 0; j < k; ++j) {
    if (j + AHEAD < k) mp->prefetch(ids[j + AHEAD]);
    int64_t s = mp->find(ids[j]);
    if (s < 0) {
      miss[nm++] = j;
      continue;
    }
    std::memcpy(srows + s * dim, rows + j * dim, dim * sizeof(float));
    tick[s] = now;
  }
  info[0] = nm;
  info[1] = 0;
  if (nm == 0 || nm > cap - n) return 0;
  try {
    mp->reserve(nm);
  } catch (...) {
    return -2;
  }
  for (int64_t t = 0; t < nm; ++t) {
    int64_t j = miss[t], s = n + t;
    mp->put(ids[j], s);
    id_of[s] = ids[j];
    std::memcpy(srows + s * dim, rows + j * dim, dim * sizeof(float));
    tick[s] = now;
  }
  info[1] = 1;
  return 0;
}

// The first nd misses miss[t] (positions into ids / rows) placed at
// dest[t], of which dest[n_free..nd) are LRU victims: their ids unmapped,
// then the new ids mapped, id_of, rows and tick written. Returns 0; 1 + t
// when dest[n_free + t] held no mapped id; -2 when memory runs out.
int64_t hps_l2_place(void* map, const int64_t* ids, const float* rows,
                     const int64_t* miss, const int64_t* dest, int64_t nd,
                     int64_t n_free, int64_t dim, float* srows, int64_t* tick,
                     int64_t* id_of, int64_t now) {
  Map* mp = static_cast<Map*>(map);
  for (int64_t t = n_free; t < nd; ++t)
    if (!mp->erase(id_of[dest[t]])) return 1 + (t - n_free);
  try {
    mp->reserve(nd);
  } catch (...) {
    return -2;
  }
  for (int64_t t = 0; t < nd; ++t) {
    int64_t j = miss[t], s = dest[t];
    mp->put(ids[j], s);
    id_of[s] = ids[j];
    std::memcpy(srows + s * dim, rows + j * dim, dim * sizeof(float));
    tick[s] = now;
  }
  return 0;
}

// -- the L3 ----------------------------------------------------------------------

// out[i] = base[ids[i]] for rows of dim floats in a table of vocab rows, a
// negative id counted from the end (numpy's indexing). Returns -1, or the
// position of the first id out of range (nothing copied).
int64_t hps_gather_rows(const float* base, int64_t vocab, int64_t dim,
                        const int64_t* ids, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i)
    if (ids[i] >= vocab || ids[i] < -vocab) return i;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = ids[i] < 0 ? ids[i] + vocab : ids[i];
    std::memcpy(out + i * dim, base + r * dim, dim * sizeof(float));
  }
  return -1;
}

}  // extern "C"

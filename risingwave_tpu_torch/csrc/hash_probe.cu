// Batched find-or-insert and find in the device hash table (kernel B3).
//
// Replaces risingwave_tpu/ops/hash_table.py::ht_lookup_or_insert and
// ::ht_lookup, which have no Pallas kernel: the reference runs the probe as a
// lax.while_loop of gather / compare / claim rounds that stays on the TPU.
// The table is open addressing with linear probing over a power-of-two
// capacity: per slot, one value and one null mask per key column and an
// `occupied` byte. Keys compare GROUP-BY style (NULL == NULL); a float64 key
// compares by value (NaN != NaN, -0.0 == 0.0).
//
// Find-or-insert must reproduce the reference's slot layout exactly (flush
// output follows slot order), so it keeps the reference's global rounds. In
// round r every unsettled row
//   A. reads `occupied` and the stored key at its candidate slot: a match
//      settles the row, an occupied slot with another key advances it to
//      the next slot, an empty slot makes it want that slot, and it bids
//      its row index with atomicMin on the slot's claim word;
//   B. after a barrier, reads the claim word: the smallest bidder wins,
//      writes its key, masks and `occupied`, sets is_new, and puts the word
//      back to kClaimFree. A loser does not advance; in the next round it
//      reads the winner's key. A loser that reads the word after the
//      winner reset it sees kClaimFree, which is no row index, so it still
//      knows it lost; a word is only bid on while its slot is empty, so no
//      bid of a later round can meet the reset.
// then, after a second barrier, the rows still unsettled are counted; the
// loop ends when none is left or after kMaxRounds rounds in all. Rows left
// unsettled get slot = capacity and set `overflow`. A row's state lives in
// its `slots` entry: >= 0 once settled (capacity for an invalid row),
// -(candidate + 1) while it probes.
//
// Two paths give the same layout: one block of 1024 threads, the rows in a
// block-stride loop and __syncthreads() as the barrier (every chunk of the
// paths here, N <= 4096); and a cooperative launch of as many blocks as fit
// on the card at once, the rows in a grid-stride loop and a grid barrier,
// for large N (the join's rehash). L1 is not coherent across SMs, so the
// table and the claim words are read with __ldcg (from L2), and the table
// pointers are never const __restrict__ (no read-only-cache loads); each
// thread fences (__threadfence) before every barrier, so its bids and
// writes are visible in L2 to the loads after it.
//
// The claim words are a workspace of `capacity` int32 words, all
// kClaimFree between calls, kept by the caller per device and stream: no
// capacity-sized memset per round or per call. The round counters of the
// grid path (three words, used in turn) are zeroed by a 16-byte memset.
// Nothing is read back to the host, and the launch allocates nothing.
//
// Find is read-only: one thread per row probes on its own, up to
// kMaxRounds slots, until a match or an empty slot.
//
// Each row's hash is computed here, bit for bit the function of
// common/hashing.py::hash_columns (the splitmix64 finalizer per column, a
// NULL tag, a float64 key hashed as the bits of its float32 after -0.0 is
// folded onto 0.0; the conversion is the same cvt.rn.f32.f64 that PyTorch's
// cast runs on the card), so a probe is one launch and no hashing pass.
//
// Bound on an H100: the bytes the function must move at 3.35 TB/s — per
// row its key words, masks and `valid` read and `slots` and `is_new`
// written; per probe taken one `occupied` byte and one key word and mask
// per column read; per inserted key its words, masks and `occupied`
// written. At the q5 shape (N = 4096, two int64 keys, most rows found at
// their first probe) that is about 0.2 MB, some 60 ns. The kernel is far
// from it (PERF.md): each round is a few dependent global reads per row,
// a thread's rows taken one after another, and two barriers, so its time
// follows the number of rounds, not the bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCols = 4;
constexpr int kMaxRounds = 128;      // MAX_PROBE_ROUNDS of the reference
constexpr int kClaimFree = 0x7fffffff;
constexpr int kBlockThreads = 1024;  // the one-block path
constexpr int kGridThreads = 256;    // the cooperative path, per block

enum Dtype { kBool = 0, kInt32 = 1, kInt64 = 2, kFloat64 = 3 };

struct Probe {
  const uint8_t* valid;      // [n]
  int64_t n;
  int ncols;
  int dtype[kMaxCols];
  const void* key[kMaxCols];      // [n] per column
  const uint8_t* kmask[kMaxCols];
  void* tab[kMaxCols];            // [cap] per column
  uint8_t* tmask[kMaxCols];
  uint8_t* occupied;              // [cap]
  int64_t cap;                    // a power of two
  int64_t* slots;                 // [n] out
  uint8_t* flag;                  // [n] out: is_new (insert), found (find)
  uint8_t* overflow;              // [] out (insert)
  int* claim;                     // [cap] workspace, kClaimFree at rest
  int* counters;                  // [4] workspace, zeroed per grid call
};

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// common/hashing.py::hash_columns of row i.
__device__ __forceinline__ uint64_t row_hash(const Probe& p, int64_t i) {
  uint64_t h = 0x243F6A8885A308D3ull;
  for (int c = 0; c < p.ncols; ++c) {
    uint64_t hc = 0xA5A5A5A55A5A5A5Aull;  // NULL
    if (p.kmask[c][i]) {
      uint64_t raw;
      switch (p.dtype[c]) {
        case kBool:
          raw = static_cast<const uint8_t*>(p.key[c])[i];
          break;
        case kInt32:  // sign-extended, as int64
          raw = static_cast<uint64_t>(static_cast<int64_t>(
              static_cast<const int*>(p.key[c])[i]));
          break;
        case kInt64:
          raw = static_cast<uint64_t>(
              static_cast<const long long*>(p.key[c])[i]);
          break;
        default: {  // kFloat64; -0.0 and 0.0 both hash as +0.0f
          const double d = static_cast<const double*>(p.key[c])[i];
          raw = d == 0.0 ? 0u : __float_as_uint(static_cast<float>(d));
        }
      }
      hc = splitmix64(raw);
    }
    h = splitmix64(h ^ hc);
  }
  return h;
}

// Does the key stored at slot s equal row i's? Every load is issued
// whatever the masks hold (all are in bounds), so a row's compare waits on
// one memory latency, not on a chain of them.
__device__ __forceinline__ bool keys_equal(const Probe& p, int64_t i,
                                           int64_t s) {
  bool eq = true;
  for (int c = 0; c < p.ncols; ++c) {
    const bool m = p.kmask[c][i] != 0;
    const bool sm = __ldcg(reinterpret_cast<const unsigned char*>(
                        p.tmask[c] + s)) != 0;
    bool same;
    switch (p.dtype[c]) {
      case kBool:
        same = static_cast<const uint8_t*>(p.key[c])[i] ==
               __ldcg(static_cast<const unsigned char*>(p.tab[c]) + s);
        break;
      case kInt32:
        same = static_cast<const int*>(p.key[c])[i] ==
               __ldcg(static_cast<const int*>(p.tab[c]) + s);
        break;
      case kInt64:
        same = static_cast<const long long*>(p.key[c])[i] ==
               __ldcg(static_cast<const long long*>(p.tab[c]) + s);
        break;
      default:  // kFloat64: by value, so NaN != NaN and -0.0 == 0.0
        same = static_cast<const double*>(p.key[c])[i] ==
               __ldcg(static_cast<const double*>(p.tab[c]) + s);
    }
    eq &= (m && sm && same) || (!m && !sm);  // NULL == NULL
  }
  return eq;
}

__device__ __forceinline__ void write_key(const Probe& p, int64_t i,
                                          int64_t s) {
  for (int c = 0; c < p.ncols; ++c) {
    switch (p.dtype[c]) {
      case kBool:
        static_cast<uint8_t*>(p.tab[c])[s] =
            static_cast<const uint8_t*>(p.key[c])[i];
        break;
      case kInt32:
        static_cast<int*>(p.tab[c])[s] = static_cast<const int*>(p.key[c])[i];
        break;
      default:  // kInt64, kFloat64: the same eight bytes
        static_cast<long long*>(p.tab[c])[s] =
            static_cast<const long long*>(p.key[c])[i];
    }
    p.tmask[c][s] = p.kmask[c][i];
  }
  p.occupied[s] = 1;
}

// Phase A of a round for row i: settle on a match, advance past another
// key, bid on an empty slot.
__device__ __forceinline__ void read_and_bid(const Probe& p, int64_t i) {
  const int64_t st = p.slots[i];
  if (st >= 0) return;
  const int64_t cand = -st - 1;
  const bool eq = keys_equal(p, i, cand);  // loads beside occupied's
  if (__ldcg(reinterpret_cast<const unsigned char*>(p.occupied + cand))) {
    if (eq) {
      p.slots[i] = cand;
    } else {
      p.slots[i] = -(((cand + 1) & (p.cap - 1)) + 1);
    }
  } else {
    atomicMin(p.claim + cand, static_cast<int>(i));
  }
}

// Phase B for row i: the smallest bidder on its slot inserts. Returns
// whether the row is still unsettled.
__device__ __forceinline__ bool claim_and_write(const Probe& p, int64_t i) {
  const int64_t st = p.slots[i];
  if (st >= 0) return false;
  const int64_t cand = -st - 1;
  if (__ldcg(p.claim + cand) != static_cast<int>(i)) return true;
  write_key(p, i, cand);
  p.claim[cand] = kClaimFree;
  p.slots[i] = cand;
  p.flag[i] = 1;
  return false;
}

__device__ __forceinline__ void init_row(const Probe& p, int64_t i) {
  p.slots[i] = p.valid[i]
                   ? -(static_cast<int64_t>(row_hash(p, i) & (p.cap - 1)) + 1)
                   : p.cap;
  p.flag[i] = 0;
}

__device__ __forceinline__ void finish_row(const Probe& p, int64_t i) {
  if (p.slots[i] < 0) p.slots[i] = p.cap;
}

__global__ void __launch_bounds__(kBlockThreads)
    insert_block_kernel(Probe p) {
  const int64_t stride = blockDim.x;
  for (int64_t i = threadIdx.x; i < p.n; i += stride) init_row(p, i);
  int pending = 0;
  for (int round = 0; round < kMaxRounds; ++round) {
    for (int64_t i = threadIdx.x; i < p.n; i += stride) read_and_bid(p, i);
    __threadfence();
    __syncthreads();
    bool mine = false;
    for (int64_t i = threadIdx.x; i < p.n; i += stride)
      mine |= claim_and_write(p, i);
    __threadfence();
    pending = __syncthreads_or(mine);
    if (!pending) break;
  }
  for (int64_t i = threadIdx.x; i < p.n; i += stride) finish_row(p, i);
  if (threadIdx.x == 0) *p.overflow = pending != 0;
}

__global__ void __launch_bounds__(kGridThreads)
    insert_grid_kernel(Probe p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first; i < p.n; i += stride) init_row(p, i);
  int pending = 0;
  for (int round = 0; round < kMaxRounds; ++round) {
    // counters[round % 3] counts this round's unsettled blocks; the word
    // for the next round was last read two grid barriers ago
    if (blockIdx.x == 0 && threadIdx.x == 0) p.counters[(round + 1) % 3] = 0;
    for (int64_t i = first; i < p.n; i += stride) read_and_bid(p, i);
    grid.sync();
    bool mine = false;
    for (int64_t i = first; i < p.n; i += stride)
      mine |= claim_and_write(p, i);
    if (__syncthreads_or(mine) && threadIdx.x == 0)
      atomicAdd(p.counters + round % 3, 1);
    grid.sync();
    pending = __ldcg(p.counters + round % 3);
    if (!pending) break;
  }
  for (int64_t i = first; i < p.n; i += stride) finish_row(p, i);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.overflow = pending != 0;
}

__global__ void __launch_bounds__(256) find_kernel(Probe p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= p.n) return;
  int64_t slot = p.cap;
  if (p.valid[i]) {
    int64_t cand = static_cast<int64_t>(row_hash(p, i) & (p.cap - 1));
    for (int round = 0; round < kMaxRounds; ++round) {
      const bool eq = keys_equal(p, i, cand);
      if (!p.occupied[cand]) break;  // an empty slot: the key is absent
      if (eq) {
        slot = cand;
        break;
      }
      cand = (cand + 1) & (p.cap - 1);
    }
  }
  p.slots[i] = slot;
  p.flag[i] = slot != p.cap;
}

int fill(Probe* p, const void* valid, long long n, int ncols,
         void* const* key, void* const* kmask, const int* dtypes,
         void* const* tab, void* const* tmask, void* occupied,
         long long cap, void* slots, void* flag) {
  if (ncols < 1 || ncols > kMaxCols || n < 0 || n >= kClaimFree || cap < 1 ||
      (cap & (cap - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  p->valid = static_cast<const uint8_t*>(valid);
  p->n = n;
  p->ncols = ncols;
  for (int c = 0; c < kMaxCols; ++c) {
    const bool on = c < ncols;
    if (on && (dtypes[c] < kBool || dtypes[c] > kFloat64))
      return static_cast<int>(cudaErrorInvalidValue);
    p->dtype[c] = on ? dtypes[c] : kInt64;
    p->key[c] = on ? key[c] : nullptr;
    p->kmask[c] = on ? static_cast<const uint8_t*>(kmask[c]) : nullptr;
    p->tab[c] = on ? tab[c] : nullptr;
    p->tmask[c] = on ? static_cast<uint8_t*>(tmask[c]) : nullptr;
  }
  p->occupied = static_cast<uint8_t*>(occupied);
  p->cap = cap;
  p->slots = static_cast<int64_t*>(slots);
  p->flag = static_cast<uint8_t*>(flag);
  p->overflow = nullptr;
  p->claim = nullptr;
  p->counters = nullptr;
  return 0;
}

}  // namespace

// Find-or-insert. `key`, `kmask`, `dtypes`, `tab`, `tmask` are host arrays
// of `ncols` entries (device pointers, dtype codes). `workspace` holds four
// counter words and then at least `cap` claim words (kClaimFree at rest;
// tables of any smaller capacity share it).
// `path`: 0 chooses (one block for n <= 4096, else the grid), 1 one block,
// 2 the cooperative grid. Returns a cudaError_t.
extern "C" int hash_probe_insert_launch(
    const void* valid, long long n, int ncols,
    void* const* key, void* const* kmask, const int* dtypes,
    void* const* tab, void* const* tmask, void* occupied, long long cap,
    void* slots, void* is_new, void* overflow, void* workspace, int path,
    void* stream) {
  Probe p;
  int err = fill(&p, valid, n, ncols, key, kmask, dtypes, tab, tmask,
                 occupied, cap, slots, is_new);
  if (err) return err;
  p.overflow = static_cast<uint8_t*>(overflow);
  p.counters = static_cast<int*>(workspace);
  p.claim = p.counters + 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) path = n <= 4096 ? 1 : 2;
  if (path == 1) {
    insert_block_kernel<<<1, kBlockThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 2) return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;  // co-resident blocks on this card
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev))) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)))
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, insert_grid_kernel, kGridThreads, 0)))
      return err;
    max_blocks = sms * per_sm;
    if (max_blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if ((err = cudaMemsetAsync(p.counters, 0, 4 * sizeof(int), s))) return err;
  long long want = (n + kGridThreads - 1) / kGridThreads;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want < max_blocks ? want : max_blocks));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(insert_grid_kernel), dim3(blocks),
      dim3(kGridThreads), args, 0, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// Find: `slots` (capacity where absent) and `found`. Returns a cudaError_t.
extern "C" int hash_probe_find_launch(
    const void* valid, long long n, int ncols,
    void* const* key, void* const* kmask, const int* dtypes,
    void* const* tab, void* const* tmask, void* occupied, long long cap,
    void* slots, void* found, void* stream) {
  Probe p;
  int err = fill(&p, valid, n, ncols, key, kmask, dtypes, tab, tmask,
                 occupied, cap, slots, found);
  if (err) return err;
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  find_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

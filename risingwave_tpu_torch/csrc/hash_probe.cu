// Batched find-or-insert and find in the device hash table (kernel B3).
//
// Replaces risingwave_tpu/ops/hash_table.py::ht_lookup_or_insert and
// ::ht_lookup, which have no Pallas kernel: the reference runs the probe as a
// lax.while_loop of gather / compare / claim rounds that stays on the TPU.
// The table is open addressing with linear probing over a power-of-two
// capacity: per slot, one value and one null mask per key column and an
// `occupied` byte. Keys compare GROUP-BY style (NULL == NULL); a float64 key
// compares by value (NaN != NaN, -0.0 == 0.0). Slots are never freed.
//
// Find-or-insert must reproduce the reference's slot layout exactly (flush
// output follows slot order). In the reference's round r every unsettled
// row reads its candidate slot: its key there settles it, another key
// advances it one slot, and an empty slot is taken by the smallest row index
// among the rows that want it in that round; the others stay and read the
// winner's key in round r + 1. At most kMaxRounds rounds run in all; rows
// left unsettled get slot = capacity and set `overflow`.
//
// No insert writes an occupied slot. So a row whose chain from its home slot
// meets its key before any empty slot settles there, whatever the call
// inserts, as in the reference; a row whose first kMaxRounds slots hold other
// keys never bids and stays unsettled; and only a row whose chain meets an
// empty slot e after k occupied ones (an absent row) takes part in the
// claims, reaching e in round k (its arrival round) and bidding there unless
// e was taken in an earlier round. A row that bids on e later walked there
// from an earlier empty slot, while every row whose first empty slot is e
// was homed past that slot: so the first bids on e come in earlier rounds
// than any other, and e goes to the smallest (k, row) among them. Hence two
// phases in one launch:
//
//   1. the windowed find, over as many blocks as the rows need: a tile of G
//      threads per row reads G consecutive slots a step (coalesced loads of
//      `occupied` and of each key column's words and masks, all issued
//      before any compare) and a ballot picks the first slot that is empty
//      or holds the row's key, so a chain of L slots costs ceil(L / G)
//      dependent steps instead of L. A row that finds its key settles; an
//      absent row records k and e and bids on e at once, atomicMin of
//      (k << 24 | row) on e's claim word, and if the bid it replaces or
//      loses to is another key's, it flags a conflict.
//   2. in the last block to finish phase 1 (the threadfence reduction: a
//      block's writes, a barrier, then its thread 0 fences and takes a
//      ticket; the last block resets the ticket), the gather: e's word holds
//      its winner, which inserts; a row of the winner's key settles at e
//      (without a conflict every row is one); a row of another key walks on
//      from e + 1 and the reference's rounds run among the walking rows
//      only, one pass and one block barrier a round, rounds with no row
//      skipped (claim_rounds says how). Bids there are atomicMin of
//      (round << 24 | row) on the slot's word, and a word keeps its winner
//      until the call ends, so the losers and later readers learn the
//      winner's key from the word (the winner's input row), not from the
//      table. Phase 2 runs in one block, so a barrier orders its memory
//      accesses (bar.sync is a fence at block scope) and no pass waits on a
//      device-wide fence. A thread issues the loads of kBatch rows before it
//      compares any; the walking rows live in the block's shared memory (in
//      the workspace past kSmemRows rows).
//
// A cooperative grid path keeps the reference's rounds over every row, two
// grid barriers a round (the same layout; for large N, the join's rehash,
// where it is 7-15x faster than phase 2's rounds in one block).
// Its round counters are zeroed by a 16-byte memset. L1 is not coherent
// across SMs, so the table and the claim words are read with __ldcg (from
// L2), the table pointers are never const __restrict__, and each thread
// fences (__threadfence) before every grid barrier.
//
// The workspace is kept by the caller per device and stream and every launch
// leaves it at rest: a header (ticket, unsettled and conflict flags, the
// last call's phase-2 passes, the grid path's counters), per-row space for
// `list_rows` rows, then `capacity` claim words, all kClaimFree between
// calls. Nothing
// is read back to the host, and the launch allocates and memsets nothing
// (the grid path's counters aside).
//
// Find is phase 1 alone, read-only: slot and found per row.
//
// Each row's hash is computed here, bit for bit the function of
// common/hashing.py::hash_columns (key_hash), so a probe is one launch and
// no hashing pass.
//
// Bound on an H100: the bytes the function must move at 3.35 TB/s — per
// row its key words, masks and `valid` read and `slots` and `is_new`
// written; per probe one `occupied` byte and one key word and mask per
// column read; per inserted key its words, masks and `occupied` written;
// about 0.2 MB, some 60 ns, on the q5 input. Random probes move whole
// 32-byte sectors, and the path has at least two dependent memory round
// trips (the find, then a bid and its check): the kernel is bound by its
// latency chain, which phase 1 cuts to one step for most rows and the
// gather to one read of each absent row's word.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCols = 4;
constexpr int kMaxRounds = 128;      // MAX_PROBE_ROUNDS of the reference
constexpr int kClaimFree = 0x7fffffff;
constexpr int kThreads = 512;        // per block: the phased path and find
// G, the slots a row reads a step (8 was 17-26% slower for find and within
// 5% for find-or-insert, PERF.md)
constexpr int kWindow = 16;
constexpr int kGridThreads = 256;    // the cooperative path, per block
constexpr int kSmemRows = 4096;      // phase-2 rows kept in shared memory
constexpr int kBatch = 4;            // phase-2 rows a thread loads together
constexpr int kGather = 8;           // rows a thread gathers together
constexpr int kNoRound = 1 << 30;
constexpr int kRowMask = (1 << 24) - 1;  // a claim word's row bits
// phase 1's arrival byte of a row that is not absent
constexpr uint8_t kPresent = 255;
// a walking row's state: the round it next takes part in (0..127), or
constexpr uint8_t kWon = 252,   // inserted its key
    kBid = 253,                 // bid in the last pass's round
    kDone = 254;                // settled, or left unsettled

static_assert(kWindow >= 1 && kWindow <= 32 && (kWindow & (kWindow - 1)) == 0
                  && kMaxRounds % kWindow == 0,
              "a window is a power of two that divides kMaxRounds");

// workspace header, in int32 words
enum Header {
  kTicket = 0,        // phase-1 blocks done
  kUnsettled = 1,     // some row is left unsettled
  kRounds = 2,        // phase-2 passes the last call ran (read by checks)
  kConflict = 3,      // two keys bid on one slot in phase 1
  kGridCounters = 4,  // four words of the grid path
  kHeaderWords = 8
};

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
  int* ws;                        // workspace header (insert)
  uint8_t* arrival;               // [n] phase 1: k, or kPresent
  int* empty_slot;                // [n] phase 1: e of an absent row
  int* g_row;                     // walking rows past kSmemRows
  int* g_cand;
  uint8_t* g_state;
  int* won;                       // [n] slots taken in the gather
  int* claim;                     // [cap] kClaimFree at rest
  int* counters;                  // the grid path's, zeroed per grid call
};

// A row's key, or the key stored at a slot: each column's value
// zero-extended (a float64's bits) and a bit per non-NULL column.
struct Key {
  uint64_t v[kMaxCols];
  unsigned nonnull;
};

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Row i's key. Every load is issued before any is used, so the row waits
// on one memory latency, not on one per column.
__device__ __forceinline__ Key row_key(const Probe& p, int64_t i) {
  Key k;
  uint8_t m[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    k.v[c] = 0;
    m[c] = 0;
    if (c < p.ncols) {
      m[c] = p.kmask[c][i];
      switch (p.dtype[c]) {
        case kBool:
          k.v[c] = static_cast<const uint8_t*>(p.key[c])[i];
          break;
        case kInt32:
          k.v[c] = static_cast<uint32_t>(static_cast<const int*>(p.key[c])[i]);
          break;
        default:
          k.v[c] = static_cast<const unsigned long long*>(p.key[c])[i];
      }
    }
  }
  k.nonnull = 0;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) k.nonnull |= (m[c] != 0 ? 1u : 0u) << c;
  return k;
}

// The key stored at slot s, read from L2 (__ldcg), all loads issued first.
__device__ __forceinline__ Key slot_key(const Probe& p, int64_t s) {
  Key k;
  uint8_t m[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    k.v[c] = 0;
    m[c] = 0;
    if (c < p.ncols) {
      m[c] = __ldcg(reinterpret_cast<const unsigned char*>(p.tmask[c] + s));
      switch (p.dtype[c]) {
        case kBool:
          k.v[c] = __ldcg(static_cast<const unsigned char*>(p.tab[c]) + s);
          break;
        case kInt32:
          k.v[c] = static_cast<uint32_t>(
              __ldcg(static_cast<const int*>(p.tab[c]) + s));
          break;
        default:
          k.v[c] = __ldcg(static_cast<const unsigned long long*>(p.tab[c]) + s);
      }
    }
  }
  k.nonnull = 0;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) k.nonnull |= (m[c] != 0 ? 1u : 0u) << c;
  return k;
}

// GROUP-BY equality: NULL == NULL; a float64 by value, so NaN != NaN and
// -0.0 == 0.0; other types by their bits.
__device__ __forceinline__ bool same_key(const Probe& p, const Key& a,
                                         const Key& b) {
  bool eq = true;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.ncols) break;
    const bool an = (a.nonnull >> c) & 1u, bn = (b.nonnull >> c) & 1u;
    const bool same = p.dtype[c] == kFloat64
                          ? __longlong_as_double(a.v[c]) ==
                                __longlong_as_double(b.v[c])
                          : a.v[c] == b.v[c];
    eq &= (an && bn && same) || (!an && !bn);
  }
  return eq;
}

// common/hashing.py::hash_columns of a row's key: the splitmix64 finalizer
// per column, a NULL tag, a float64 hashed as the bits of its float32 with
// -0.0 folded onto 0.0 (the card's cvt.rn.f32.f64 gives the CPU's bits, NaN
// payloads included), an int32 sign-extended.
__device__ __forceinline__ uint64_t key_hash(const Probe& p, const Key& k) {
  uint64_t h = 0x243F6A8885A308D3ull;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.ncols) break;
    uint64_t raw = k.v[c];
    if (p.dtype[c] == kInt32) {
      raw = static_cast<uint64_t>(static_cast<int64_t>(static_cast<int>(
          static_cast<uint32_t>(raw))));
    } else if (p.dtype[c] == kFloat64) {
      const double d = __longlong_as_double(raw);
      raw = d == 0.0 ? 0u : __float_as_uint(static_cast<float>(d));
    }
    const uint64_t hc = (k.nonnull >> c) & 1u ? splitmix64(raw)
                                              : 0xA5A5A5A55A5A5A5Aull;
    h = splitmix64(h ^ hc);
  }
  return h;
}

__device__ __forceinline__ bool occupied_at(const Probe& p, int64_t s) {
  return __ldcg(reinterpret_cast<const unsigned char*>(p.occupied + s)) != 0;
}

// Writes key `k` into slot s.
__device__ __forceinline__ void write_key(const Probe& p, const Key& k,
                                          int64_t s) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= p.ncols) break;
    switch (p.dtype[c]) {
      case kBool:
        static_cast<uint8_t*>(p.tab[c])[s] = static_cast<uint8_t>(k.v[c]);
        break;
      case kInt32:
        static_cast<uint32_t*>(p.tab[c])[s] = static_cast<uint32_t>(k.v[c]);
        break;
      default:  // kInt64, kFloat64: the same eight bytes
        static_cast<unsigned long long*>(p.tab[c])[s] = k.v[c];
    }
    p.tmask[c][s] = (k.nonnull >> c) & 1u;
  }
  p.occupied[s] = 1;
}

// The probe of key `own` from slot `home`, G slots a step by the G
// threads of `tile` (all of them call it): the offset of the first slot
// that is empty or holds the key, or kMaxRounds if the first kMaxRounds
// slots hold other keys; `slot` gets that slot (capacity if none) and
// `found` whether it holds the key.
template <unsigned G>
__device__ __forceinline__ int window_find(
    const Probe& p, cg::thread_block_tile<G, cg::thread_block>& tile,
    const Key& own, int64_t home, int64_t* slot, bool* found) {
  const int lane = static_cast<int>(tile.thread_rank());
  for (int base = 0; base < kMaxRounds; base += static_cast<int>(G)) {
    const int64_t s = (home + base + lane) & (p.cap - 1);
    const Key there = slot_key(p, s);
    const bool occ = occupied_at(p, s);
    const unsigned stop = tile.ballot(!occ || same_key(p, own, there));
    if (stop) {
      const int first = __ffs(stop) - 1;
      *found = (tile.ballot(occ) >> first) & 1u;
      *slot = (home + base + first) & (p.cap - 1);
      return base + first;
    }
  }
  *found = false;
  *slot = p.cap;
  return kMaxRounds;
}

// The smallest v over the block: each warp's smallest goes into `cell`,
// which holds kNoRound since a barrier before the call. Every thread of the
// block calls it.
__device__ __forceinline__ int block_min(int v, int* cell) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMin(cell, v);
  __syncthreads();
  return *const_cast<volatile int*>(cell);
}

// This lane's place in a list that the lanes of its warp for which `on`
// holds append to together: one shared atomic per warp. Every lane of the
// warp calls it.
__device__ __forceinline__ int warp_append(bool on, int* count) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  int base = 0;
  if (lane == 0 && mask != 0) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// Phase 2's walking rows: the first kSmemRows in shared memory, the rest in
// the workspace.
struct Entries {
  int *s_row, *s_cand, *g_row, *g_cand;
  uint8_t *s_state, *g_state;
  __device__ int& row(int j) {
    return j < kSmemRows ? s_row[j] : g_row[j - kSmemRows];
  }
  __device__ int& cand(int j) {
    return j < kSmemRows ? s_cand[j] : g_cand[j - kSmemRows];
  }
  __device__ uint8_t& state(int j) {
    return j < kSmemRows ? s_state[j] : g_state[j - kSmemRows];
  }
};

// Row r cannot settle within the reference's rounds.
__device__ __forceinline__ void leave(const Probe& p, int r) {
  p.slots[r] = p.cap;
  p.ws[kUnsettled] = 1;
}

// A walking row that read the key at slot u in round rnd: settle there on a
// match, else go on to the next slot in the next round (none after the
// last).
__device__ __forceinline__ void settle_or_walk(const Probe& p, Entries& e,
                                               int j, int r, int u, bool eq,
                                               int rnd) {
  if (eq) {
    p.slots[r] = u;
    e.state(j) = kDone;
  } else if (rnd + 1 < kMaxRounds) {
    e.cand(j) = static_cast<int>((u + 1) & (p.cap - 1));
    e.state(j) = static_cast<uint8_t>(rnd + 1);
  } else {
    leave(p, r);
    e.state(j) = kDone;
  }
}

// Phase 2, run by the last block to finish phase 1. Each absent row bid in
// phase 1 on its first empty slot e with (k << 24 | row), k its arrival
// round. That bid stands against every later one: a row that bids on e in
// the rounds below walked there from an earlier empty slot e' (losing e'
// costs it a round on top of one per slot), while a row whose first empty
// slot is e was homed past e', so it reached e in fewer rounds. So e goes
// to the smallest (k, row) of its first bids, as in the reference, and
// the gather settles every absent row at once:
//   - the row that holds e's word takes e: it writes its key, masks and
//     `occupied` and sets is_new;
//   - a row of the same key settles at e (the round after its bid: none
//     after the last);
//   - a row of another key (only if phase 1 saw a conflict) walks on from
//     e + 1, in round k + 1 if e was taken in an earlier round, else in
//     round k + 2 (it reads the winner's key the round after its bid).
// The walking rows then run the reference's rounds among themselves, one
// pass and one block barrier a round, rounds with no row skipped. In the
// pass of round r a row
//   - that bid in round r - 1 reads its word: the winner writes its key and
//     sets is_new; a loser compares its key with the winner's (from the
//     input, not the table, which the winner writes in this pass);
//   - else reads its slot's word with the slot: a word of an earlier round
//     means the slot was taken, and its key is the word's row's input key;
//     no word means the slot holds what it held before the call, and a
//     word of round r, or no word and an empty slot, means the row bids,
//     atomicMin of (r << 24 | row) on the word.
// Round kMaxRounds only settles round kMaxRounds - 1's bids (its losers
// stay unsettled, as in the reference, whose loop stops there). At the end
// the winners put their words back to kClaimFree.
__device__ void claim_rounds(const Probe& p, Entries& e, int* count,
                             int* won_count, int* smin) {
  const bool conflict = __ldcg(p.ws + kConflict) != 0;
  int first = kNoRound;
  for (int64_t i0 = threadIdx.x; i0 - threadIdx.x < p.n;
       i0 += kGather * kThreads) {
    uint8_t k[kGather];
    int slot[kGather], word[kGather];
#pragma unroll
    for (int b = 0; b < kGather; ++b) {
      const int64_t i = i0 + b * kThreads;
      k[b] = i < p.n ? __ldcg(reinterpret_cast<const unsigned char*>(
                           p.arrival + i))
                     : kPresent;
      slot[b] = i < p.n ? __ldcg(p.empty_slot + i) : 0;
    }
#pragma unroll
    for (int b = 0; b < kGather; ++b)
      if (k[b] != kPresent) word[b] = __ldcg(p.claim + slot[b]);
    // the keys the winners write and a conflict compares, kBatch rows at a
    // time
#pragma unroll
    for (int b0 = 0; b0 < kGather; b0 += kBatch) {
      Key own[kBatch], there[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k[b0 + b] == kPresent) continue;
        const int r = static_cast<int>(i0 + (b0 + b) * kThreads);
        const int h = word[b0 + b] & kRowMask;
        if (h == r || conflict) own[b] = row_key(p, r);
        if (h != r && conflict) there[b] = row_key(p, h);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = static_cast<int>(i0 + (b0 + b) * kThreads);
        const int e_b = slot[b0 + b], k_b = k[b0 + b], w_b = word[b0 + b];
        const bool absent = k_b != kPresent;
        const bool won = absent && (w_b & kRowMask) == r;
        int walk = kNoRound;
        if (won) {
          write_key(p, own[b], e_b);
          p.slots[r] = e_b;
          p.flag[r] = 1;
        } else if (absent && (!conflict || same_key(p, own[b], there[b]))) {
          if (k_b + 1 < kMaxRounds) p.slots[r] = e_b;
          else leave(p, r);
        } else if (absent) {
          walk = k_b + ((w_b >> 24) < k_b ? 1 : 2);
          if (walk >= kMaxRounds) {
            leave(p, r);
            walk = kNoRound;
          }
        }
        const int w = warp_append(won, won_count);
        if (won) p.won[w] = e_b;
        const int j = warp_append(walk != kNoRound, count);
        if (walk != kNoRound) {
          e.row(j) = r;
          e.cand(j) = static_cast<int>((e_b + 1) & (p.cap - 1));
          e.state(j) = static_cast<uint8_t>(walk);
          first = min(first, walk);
        }
      }
    }
  }
  int rnd = block_min(first, smin);
  const int n = *const_cast<volatile int*>(count);
  int passes = 0;
  while (rnd <= kMaxRounds) {
    ++passes;
    // pass k reduces into smin[k % 3] and frees the cell of pass k + 1,
    // which every thread last read two barriers ago
    if (threadIdx.x == 0) smin[(passes + 1) % 3] = kNoRound;
    int mine = kNoRound;
    for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * kThreads) {
      int r[kBatch], u[kBatch], word[kBatch];
      uint8_t st[kBatch];
      bool on[kBatch], occ[kBatch], need[kBatch];
      Key own[kBatch], there[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b * kThreads;
        st[b] = j < n ? e.state(j) : kDone;
        on[b] = st[b] == kBid || st[b] == rnd;
        if (on[b]) {
          r[b] = e.row(j);
          u[b] = e.cand(j);
        } else if (st[b] < kMaxRounds) {
          mine = min(mine, static_cast<int>(st[b]));  // walks on later
        }
      }
      // every load of the batch before any compare
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!on[b]) continue;
        word[b] = __ldcg(p.claim + u[b]);
        own[b] = row_key(p, r[b]);
        if (st[b] == rnd) {
          occ[b] = occupied_at(p, u[b]);
          there[b] = slot_key(p, u[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        need[b] = false;
        if (!on[b]) continue;
        const int j = j0 + b * kThreads;
        if (st[b] == kBid) {
          if ((word[b] & kRowMask) == r[b]) {
            write_key(p, own[b], u[b]);
            p.slots[r[b]] = u[b];
            p.flag[r[b]] = 1;
            e.state(j) = kWon;
          } else if (rnd == kMaxRounds) {
            leave(p, r[b]);
            e.state(j) = kDone;
          } else {
            need[b] = true;  // the winner's key
          }
        } else if (word[b] != kClaimFree && (word[b] >> 24) < rnd) {
          need[b] = true;    // taken in an earlier round
        } else if (word[b] == kClaimFree && occ[b]) {
          settle_or_walk(p, e, j, r[b], u[b], same_key(p, own[b], there[b]),
                         rnd);
        } else {
          atomicMin(p.claim + u[b], (rnd << 24) | r[b]);
          e.state(j) = kBid;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (need[b]) there[b] = row_key(p, word[b] & kRowMask);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!need[b]) continue;
        settle_or_walk(p, e, j0 + b * kThreads, r[b], u[b],
                       same_key(p, own[b], there[b]), rnd);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!on[b]) continue;
        const uint8_t now = e.state(j0 + b * kThreads);
        if (now == kBid) mine = min(mine, rnd + 1);
        else if (now < kMaxRounds) mine = min(mine, static_cast<int>(now));
      }
    }
    rnd = block_min(mine, smin + passes % 3);
  }
  // every word was read for the last time before the last barrier
  const int won = *const_cast<volatile int*>(won_count);
  for (int w = threadIdx.x; w < won; w += kThreads) p.claim[p.won[w]] = kClaimFree;
  for (int j = threadIdx.x; j < n; j += kThreads)
    if (e.state(j) == kWon) p.claim[e.cand(j)] = kClaimFree;
  if (threadIdx.x == 0) {
    *p.overflow = __ldcg(p.ws + kUnsettled) != 0;
    p.ws[kRounds] = passes;
    p.ws[kTicket] = 0;
    p.ws[kUnsettled] = 0;
    p.ws[kConflict] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) insert_phased_kernel(Probe p) {
  __shared__ int s_row[kSmemRows];
  __shared__ int s_cand[kSmemRows];
  __shared__ uint8_t s_state[kSmemRows];
  __shared__ int smin[3];
  __shared__ int count, won_count;
  __shared__ bool last;
  constexpr int kRowsPerBlock = kThreads / kWindow;
  auto tile = cg::tiled_partition<kWindow>(cg::this_thread_block());
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWindow;
  // phase 1: the windowed find against the table as it stands, and each
  // absent row's bid on its first empty slot
  if (i < p.n) {  // the same for the whole tile
    const bool valid = p.valid[i] != 0;
    const Key own = row_key(p, i);
    int64_t slot = p.cap;
    bool found = false;
    int k = kMaxRounds;
    if (valid)
      k = window_find(p, tile, own,
                      static_cast<int64_t>(key_hash(p, own) & (p.cap - 1)),
                      &slot, &found);
    if (tile.thread_rank() == 0) {
      const bool absent = valid && k < kMaxRounds && !found;
      p.flag[i] = 0;
      p.arrival[i] = absent ? static_cast<uint8_t>(k) : kPresent;
      if (absent) {
        p.empty_slot[i] = static_cast<int>(slot);
        const int old = atomicMin(p.claim + slot,
                                  (k << 24) | static_cast<int>(i));
        // two keys met at one slot: phase 2 compares keys and walks
        if (old != kClaimFree &&
            !same_key(p, own, row_key(p, old & kRowMask)))
          p.ws[kConflict] = 1;
      } else {
        p.slots[i] = found ? slot : p.cap;
        if (valid && !found) p.ws[kUnsettled] = 1;
      }
    }
  }
  // the last block to get here runs phase 2: the barrier orders the block's
  // writes before thread 0's fence, which publishes them with the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.ws + kTicket, 1) == static_cast<int>(gridDim.x) - 1;
    __threadfence();
    count = won_count = 0;
    smin[0] = smin[1] = smin[2] = kNoRound;
  }
  __syncthreads();
  if (!last) return;  // the whole block
  Entries e{s_row, s_cand, p.g_row, p.g_cand, s_state, p.g_state};
  claim_rounds(p, e, &count, &won_count, smin);
}

// The grid path's rows keep their state in `slots`: >= 0 once settled
// (capacity for an invalid row), -(candidate + 1) while they probe.

// A round's first half for row i: settle on a match, advance past another
// key, bid on an empty slot.
__device__ __forceinline__ void read_and_bid(const Probe& p, int64_t i) {
  const int64_t st = p.slots[i];
  if (st >= 0) return;
  const int64_t cand = -st - 1;
  const bool eq = same_key(p, row_key(p, i), slot_key(p, cand));
  if (occupied_at(p, cand)) {
    if (eq) {
      p.slots[i] = cand;
    } else {
      p.slots[i] = -(((cand + 1) & (p.cap - 1)) + 1);
    }
  } else {
    atomicMin(p.claim + cand, static_cast<int>(i));
  }
}

// The second half: the smallest bidder on its slot inserts. Returns whether
// the row is still unsettled.
__device__ __forceinline__ bool claim_and_write(const Probe& p, int64_t i) {
  const int64_t st = p.slots[i];
  if (st >= 0) return false;
  const int64_t cand = -st - 1;
  if (__ldcg(p.claim + cand) != static_cast<int>(i)) return true;
  write_key(p, row_key(p, i), cand);
  p.claim[cand] = kClaimFree;
  p.slots[i] = cand;
  p.flag[i] = 1;
  return false;
}

__global__ void __launch_bounds__(kGridThreads)
    insert_grid_kernel(Probe p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first; i < p.n; i += stride) {
    p.slots[i] = p.valid[i] ? -(static_cast<int64_t>(key_hash(
                                    p, row_key(p, i)) & (p.cap - 1)) + 1)
                            : p.cap;
    p.flag[i] = 0;
  }
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
  for (int64_t i = first; i < p.n; i += stride)
    if (p.slots[i] < 0) p.slots[i] = p.cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.overflow = pending != 0;
}

__global__ void __launch_bounds__(kThreads) find_window_kernel(Probe p) {
  constexpr int kRowsPerBlock = kThreads / kWindow;
  auto tile = cg::tiled_partition<kWindow>(cg::this_thread_block());
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWindow;
  if (i >= p.n) return;  // the same for the whole tile
  const bool valid = p.valid[i] != 0;
  const Key own = row_key(p, i);
  int64_t slot = p.cap;
  bool found = false;
  if (valid)
    window_find(p, tile, own,
                static_cast<int64_t>(key_hash(p, own) & (p.cap - 1)), &slot,
                &found);
  if (tile.thread_rank() == 0) {
    p.slots[i] = found ? slot : p.cap;
    p.flag[i] = found;
  }
}

int fill(Probe* p, const void* valid, long long n, int ncols,
         void* const* key, void* const* kmask, const int* dtypes,
         void* const* tab, void* const* tmask, void* occupied,
         long long cap, void* slots, void* flag) {
  if (ncols < 1 || ncols > kMaxCols || n < 0 || n >= kClaimFree || cap < 1 ||
      cap > (1ll << 31) || (cap & (cap - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  *p = Probe{};
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
  return 0;
}

// int32 words of the workspace's per-row part: arrival bytes, empty slots,
// the walking rows past kSmemRows (row, candidate), the slots taken in the
// gather, the walking rows' state bytes.
long long list_words(long long rows) { return 4 * rows + 2 * ((rows + 3) / 4); }

}  // namespace

// int32 words of a workspace for up to `rows` rows a call and tables of up
// to `cap` slots: the header, the per-row part, the claim words. The header
// must start at 0 and the claim words at 0x7fffffff; every launch leaves
// them so.
extern "C" long long hash_probe_workspace_words(long long rows,
                                                long long cap) {
  return kHeaderWords + list_words(rows) + cap;
}

// The workspace's header words (they start at 0), and the word that holds
// the phase-2 passes of the last phased call (for checks).
extern "C" long long hash_probe_header_words() { return kHeaderWords; }
extern "C" long long hash_probe_rounds_word() { return kRounds; }

// Find-or-insert. `key`, `kmask`, `dtypes`, `tab`, `tmask` are host arrays
// of `ncols` entries (device pointers, dtype codes). `workspace` is laid out
// for `list_rows` >= n rows (hash_probe_workspace_words) and at least `cap`
// claim words. `path`: 0 chooses (phased for n <= 4096, else the grid),
// 1 the phased path (n < 2^24 - 1), 2 the cooperative grid. Returns a
// cudaError_t.
extern "C" int hash_probe_insert_launch(
    const void* valid, long long n, int ncols,
    void* const* key, void* const* kmask, const int* dtypes,
    void* const* tab, void* const* tmask, void* occupied, long long cap,
    void* slots, void* is_new, void* overflow, void* workspace,
    long long list_rows, int path, void* stream) {
  Probe p;
  int err = fill(&p, valid, n, ncols, key, kmask, dtypes, tab, tmask,
                 occupied, cap, slots, is_new);
  if (err) return err;
  if (list_rows < n) return static_cast<int>(cudaErrorInvalidValue);
  p.overflow = static_cast<uint8_t*>(overflow);
  p.ws = static_cast<int*>(workspace);
  p.counters = p.ws + kGridCounters;
  int* rows = p.ws + kHeaderWords;
  const long long bytes_words = (list_rows + 3) / 4;
  p.arrival = reinterpret_cast<uint8_t*>(rows);
  p.empty_slot = rows + bytes_words;
  p.g_row = p.empty_slot + list_rows;
  p.g_cand = p.g_row + list_rows;
  p.won = p.g_cand + list_rows;
  p.g_state = reinterpret_cast<uint8_t*>(p.won + list_rows);
  p.claim = rows + list_words(list_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) path = n <= 4096 ? 1 : 2;
  if (path == 1) {
    if (n >= kRowMask) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int kRowsPerBlock = kThreads / kWindow;
    const long long rows_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    const long long blocks = rows_blocks > 0 ? rows_blocks : 1;
    insert_phased_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p);
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
  constexpr int kRowsPerBlock = kThreads / kWindow;
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  find_window_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

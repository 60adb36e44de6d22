// Same-key rank/total counts for the streaming hash join's chunk pass.
//
// Replaces the Pallas TPU kernel risingwave_tpu/ops/pallas_rank.py::_kernel
// (launched by rank_totals_pallas_call). For probe row i and bucket lane w:
//
//   r[i, w] = #{ j < i : ident[j] == ident[i] >= 0, matches[j, w] }
//   t[i, w] = #{ j     : ident[j] == ident[i] >= 0, matches[j, w] }
//
// The TPU kernel builds 256x256 equality tiles in VMEM and feeds two dense
// [N,N]x[N,W] products to the MXU: O(N^2 W) work. Here the function is
// computed as what it is, a stable grouping of the rows by key followed by
// a prefix sum down each lane within each group: O(N log N + N W) work for
// every key pattern. Two launches on the caller's stream, no host sync,
// no allocation beyond a fixed workspace; the sorted positions are cut
// into tiles of kTile rows.
//
//   1. sort_tiles_kernel, one block per tile (N <= kSmemSortCap): every
//      block groups the whole chunk in its own shared memory, all in the
//      same order. The blocks run side by side, so this costs one block's
//      latency and spares a launch and a grid-wide barrier. A hash table
//      of the keys first checks whether the chunk comes grouped (each
//      key's rows adjacent, as a join's probe chunk of time-ordered events
//      does): then the sorted order is the row order and no pass runs.
//      Otherwise the keys are numbered by first row and the rows placed
//      by LSD radix passes on that number, the first from registers: one
//      pass for up to 256 keys. A pass is stable by construction: a warp
//      ranks its digits by ballots and per-(digit, warp) counters, and a
//      block scan of the counters places them. No library sort. The block
//      then loads its tile's `matches` rows (one coalesced row each) and
//      writes them in sorted order with the permutation and segment-head
//      flags, the sums of the tile (A), of its first segment's rows (P)
//      and of its last segment's rows (S), and the tiles where its first
//      segment starts (f) and its last ends (l), found by a 32-ary search.
//      Larger N: one block sorts the raw keys through global buffers, with
//      the same passes, walks all tiles, and writes Q, the exclusive
//      prefix of A over tiles.
//   2. scan_tiles_kernel, one block per tile and 128 lanes: it reads the
//      tile's rows as kernel 1 wrote them (no gather), scans each lane in
//      segments (eight warps of four rows, carries between warps through
//      shared memory), and adds the carries from other tiles:
//        into the first segment  S[f] + sum of A over tiles f+1 .. k-1
//        out of the last         sum of A over tiles k+1 .. l-1 + P[l]
//      (Q[k] - Q[f+1] and Q[l] - Q[k+1] when Q was written, else read by
//      the block's warps in parallel, S[k-1] and P[k+1] ahead of time). It
//      writes r = inclusive - own row and t = segment total as whole output
//      rows, zeros where ident < 0.
//
// Bound on an H100 at the q7 shape (N = 4096, W = 128): read ident (16 KiB)
// and matches (512 KiB), write r and t (4 MiB): about 1.4 us at 3.35 TB/s,
// for any key pattern. Kernel 2 is that byte stream plus one dependent
// read. Kernel 1 moves few bytes; its time is a chain of block barriers
// and dependent shared-memory steps in one SM, and each launch adds about
// a microsecond, which together keep the pair several times above the
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                    // sorted rows per tile
constexpr int kSortThreads = 512;            // kernel 1 block
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxIpt = 8;                   // items per thread per round
constexpr int kRound = kSortThreads * kMaxIpt;
constexpr int kSmemSortCap = 4096;           // largest N sorted in shared
constexpr int kScanThreads = 256;            // kernel 2 block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRowsPerWarp = kTile / kScanWarps;
constexpr int kLaneChunk = 128;              // lanes per block: 32 x 4
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kNeg = 0x80000000u;       // item bit: ident < 0

// kernel 1 shared memory: per-(digit, warp) counters (also the tile sums'
// partials), per-digit bases (also per-warp scratch), warp sums, then the
// hash table and the sort buffers
constexpr int kCntWords = 256 * kSortWarps;
constexpr size_t kGbaseOff = kCntWords * 4;
constexpr size_t kWsumOff = kGbaseOff + 256 * 4;
constexpr size_t kHeader = (kWsumOff + kSortWarps * 4 + 255) / 256 * 256;
constexpr size_t kMaxSmem = kHeader + 16 * size_t(kSmemSortCap)
    + 8 * (size_t(kSmemSortCap) + kSmemSortCap / 32);

static_assert(6 * kSortWarps * 32 <= kCntWords, "tile sums' partials");
static_assert(kRowsPerWarp * kScanWarps == kTile, "tile rows");
static_assert(kSmemSortCap <= kRound, "one round sorts a shared chunk");

struct Ws {
  int2* meta;        // [nt]: tile of first segment's start, of last's end
  uint32_t* perm;    // [n]: row index | kNeg, in sorted order
  uint8_t* head;     // [n]: 1 where a segment starts
  uint8_t* rows;     // [n][w]: matches in sorted order, 0 for ident < 0
  int* agg;          // [3][nt][w]: A, P, S
  int* q;            // [nt][w]: exclusive prefix of A over tiles
  uint64_t* buf0;    // [n] and [n]: sort buffers when N > kSmemSortCap
  uint64_t* buf1;
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// Item p of a sort buffer: one pad word per 32 items, so that a warp's
// scattered writes a power of two apart spread over the banks.
__host__ __device__ __forceinline__ size_t padded(size_t p) {
  return p + (p >> 5);
}

// byte offsets of Ws in the workspace; the last one is its size
struct Layout {
  size_t meta, perm, head, rows, agg, q, buf0, buf1, total;
};

Layout layout(int n, int w) {
  const size_t nt = (size_t(n) + kTile - 1) / kTile;
  Layout l;
  l.meta = 0;
  l.perm = align256(l.meta + nt * 8);
  l.head = align256(l.perm + size_t(n) * 4);
  l.rows = align256(l.head + size_t(n));
  l.agg = align256(l.rows + size_t(n) * w);
  l.q = align256(l.agg + 3 * nt * w * 4);
  l.buf0 = align256(l.q + nt * w * 4);
  const size_t buf = n > kSmemSortCap ? padded(n) * 8 : 0;
  l.buf1 = align256(l.buf0 + buf);
  l.total = align256(l.buf1 + buf);
  return l;
}

// slot-table size for n rows: a power of two of at least 2n
__host__ __device__ inline int table_size(int n) {
  int ts = 2;
  while (ts < 2 * n) ts <<= 1;
  return ts;
}

__device__ __forceinline__ uint32_t key_of(uint64_t item) {
  return uint32_t(item >> 32);
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// lanes of the warp whose d-bit digit equals this lane's (ok lanes only)
__device__ __forceinline__ unsigned digit_peers(uint32_t dg, int d, bool ok) {
  unsigned m = __ballot_sync(kAll, ok);
  for (int b = 0; b < d; ++b) {
    const bool bit = (dg >> b) & 1u;
    const unsigned on = __ballot_sync(kAll, bit);
    m &= bit ? on : ~on;
  }
  return m;
}

// counter of (digit d, warp w); the rotation puts the counters one warp
// updates in one step on distinct banks
__device__ __forceinline__ int cslot(uint32_t d, int w) {
  return int(d) * kSortWarps + ((w + int(d)) % kSortWarps);
}

// in place exclusive scan of the c counters in (digit, warp) order
__device__ void block_exclusive_scan(uint32_t* cnt, int c, uint32_t* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (c + kSortThreads - 1) / kSortThreads;   // <= 8
  uint32_t v[8];
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = tid * per + k;
    v[k] = (k < per && x < c) ? cnt[cslot(x / kSortWarps, x % kSortWarps)] : 0;
    sum += v[k];
  }
  const uint32_t incl = warp_incl_scan(sum);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t x = lane < kSortWarps ? wsum[lane] : 0;
    const uint32_t before = warp_incl_scan(x) - x;
    if (lane < kSortWarps) wsum[lane] = before;
  }
  __syncthreads();
  uint32_t run = wsum[warp] + incl - sum;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = tid * per + k;
    if (k < per && x < c) {
      cnt[cslot(x / kSortWarps, x % kSortWarps)] = run;
      run += v[k];
    }
  }
  __syncthreads();
}

// Digits per pass when sorting on `bits` key bits: as few 8-bit passes as
// will do, split evenly.
__device__ __forceinline__ int sort_digits(int bits) {
  const int passes = (bits + 7) / 8;
  return (bits + passes - 1) / passes;
}

// One round of a stable LSD pass on the d key bits at `shift` of the item
// word: the round's items it[0, ipt) of each thread, item x = rb + warp *
// ipw + s * 32 + lane, go to dst at their rank among all the round's items
// (plus, with `multi`, gbase[digit], the digit's start over the whole pass,
// which is then advanced past the round). Warp w of a round owns a run of
// consecutive items, so (digit, warp, step, lane) order is item order.
__device__ void place_round(const uint64_t (&it)[kMaxIpt], int ipt, int n,
                            int rb, int shift, int d, uint64_t* dst,
                            uint32_t* cnt, uint32_t* gbase, uint32_t* wsum,
                            bool multi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t nb = 1u << d, mask = nb - 1;
  const int ipw = 32 * ipt;
  const unsigned lt = (1u << lane) - 1;
  // a warp's counters are its own until the scan; the lowest lane of each
  // digit in a step bumps the digit's counter, and the warp's bumps land
  // in step order, so ranks keep item order
  for (int x = lane; x < int(nb); x += 32) cnt[cslot(x, warp)] = 0;
  __syncwarp();
  uint32_t rk[kMaxIpt];
  unsigned pe[kMaxIpt];
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {
    if (s < ipt) {
      const bool ok = rb + warp * ipw + s * 32 + lane < n;
      const uint32_t dg = ok ? uint32_t(it[s] >> shift) & mask : 0;
      pe[s] = digit_peers(dg, d, ok);
      rk[s] = 0;
      if (ok && (pe[s] & lt) == 0)
        rk[s] = atomicAdd(cnt + cslot(dg, warp), __popc(pe[s]));
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {
    if (s < ipt)
      rk[s] = __shfl_sync(kAll, rk[s], __ffs(pe[s]) - 1) + __popc(pe[s] & lt);
  }
  __syncthreads();
  block_exclusive_scan(cnt, int(nb) * kSortWarps, wsum);
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {
    const int x = rb + warp * ipw + s * 32 + lane;
    if (s < ipt && x < n) {
      const uint32_t dg = uint32_t(it[s] >> shift) & mask;
      uint32_t pos = cnt[cslot(dg, warp)] + rk[s];
      if (multi) pos += gbase[dg] - cnt[cslot(dg, 0)];
      dst[padded(pos)] = it[s];
    }
  }
  __syncthreads();
  if (multi) {
    const uint32_t in_round = uint32_t(min(kSortThreads * ipt, n - rb));
    for (int x = tid; x < int(nb); x += kSortThreads) {
      const uint32_t end = x + 1 < int(nb) ? cnt[cslot(x + 1, 0)] : in_round;
      gbase[x] += end - cnt[cslot(x, 0)];
    }
    __syncthreads();
  }
}

// One stable LSD pass on the d key bits at `shift`, src to dst, in rounds
// of up to kRound items.
__device__ void radix_pass(const uint64_t* src, uint64_t* dst, int n,
                           int shift, int d, uint32_t* cnt, uint32_t* gbase,
                           uint32_t* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t nb = 1u << d, mask = nb - 1;
  const bool multi = n > kRound;
  const int ipt = multi ? kMaxIpt : (n + kSortThreads - 1) / kSortThreads;
  const int ipw = 32 * ipt;
  const unsigned lt = (1u << lane) - 1;

  if (multi) {  // each digit's first position over the whole pass
    for (int x = tid; x < int(nb); x += kSortThreads) gbase[x] = 0;
    __syncthreads();
    for (int b = warp * 32; b < n; b += kSortThreads) {
      const int x = b + lane;
      const uint32_t dg = x < n ? uint32_t(src[padded(x)] >> shift) & mask : 0;
      const unsigned peers = digit_peers(dg, d, x < n);
      if (x < n && (peers & lt) == 0) atomicAdd(&gbase[dg], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      uint32_t carry = 0;
      for (int b = 0; b < int(nb); b += 32) {
        const uint32_t x = b + lane < int(nb) ? gbase[b + lane] : 0;
        const uint32_t inc = warp_incl_scan(x);
        if (b + lane < int(nb)) gbase[b + lane] = carry + inc - x;
        carry += __shfl_sync(kAll, inc, 31);
      }
    }
    __syncthreads();
  }
  for (int rb = 0; rb < n; rb += kSortThreads * ipt) {
    uint64_t it[kMaxIpt];
#pragma unroll
    for (int s = 0; s < kMaxIpt; ++s) {
      const int x = rb + warp * ipw + s * 32 + lane;
      it[s] = s < ipt && x < n ? src[padded(x)] : 0;
    }
    place_round(it, ipt, n, rb, shift, d, dst, cnt, gbase, wsum, multi);
  }
}

// Items (d << 32 | kNeg if ident < 0 | i) in row order in a[0, n), the
// same in every block that sorts the chunk; a row with ident < 0 joins a
// group where it stands and counts as zero. A shared-memory hash table (in
// `table`) holds the keys.
//  * First try: a run is a maximal sequence of rows with one key, rows
//    with ident < 0 aside; the row starting each run inserts its key. If
//    no key was there already, the rows come grouped (every key's rows
//    adjacent), d is the row where the row's run starts (a row before the
//    first run is a group of its own: d is the row), which never falls in
//    row order: no pass, 0 is returned.
//  * Otherwise every run of equal keys within a warp step probes the
//    table, which keeps each key's first row; d is a dense group id, keys
//    numbered 0, 1, ... in the order of their first rows, a row with
//    ident < 0 taking the newest id so far. The ids' bit count is
//    returned; the first pass (all of it for at most 256 keys) is made
//    here, straight from the registers, on the low `*first` bits.
__device__ int group_items(const int32_t* __restrict__ ident, int n,
                           uint64_t* a, unsigned char* table, uint32_t* cnt,
                           uint32_t* wsum, uint32_t* wlast, int* first) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ipt = (n + kSortThreads - 1) / kSortThreads;
  const int ipw = 32 * ipt;                // rows of a warp: a run of ipw
  const int ts = table_size(n);
  const int tbits = __ffs(ts) - 1;
  const unsigned lt = (1u << lane) - 1;
  int key[kMaxIpt];
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {  // all loads in flight together
    const int i = warp * ipw + s * 32 + lane;
    key[s] = s < ipt && i < n ? ident[i] : -1;
  }
  volatile int* tkey = reinterpret_cast<volatile int*>(table);
  int* tval = reinterpret_cast<int*>(table) + ts;  // first row, then id
  for (int x = tid; x < ts; x += kSortThreads) {
    tkey[x] = -1;
    tval[x] = n;
  }
  int* idle = reinterpret_cast<int*>(wlast) + 64 + lane;
  if (warp == 0) *idle = 0;
  // the last keyed row of each warp, for the warps after it
  {
    int lastk = -1;
#pragma unroll
    for (int s = 0; s < kMaxIpt; ++s) {
      const unsigned km = __ballot_sync(kAll, key[s] >= 0);
      const int k = __shfl_sync(kAll, key[s], km ? 31 - __clz(km) : 0);
      if (km) lastk = k;
    }
    if (lane == 0) wlast[warp] = uint32_t(lastk);
  }
  __syncthreads();
  unsigned starts[kMaxIpt];  // lanes whose row starts a run
  {
    const int ek = lane < warp ? int(wlast[lane]) : -1;
    const unsigned em = __ballot_sync(kAll, ek >= 0);
    int pk = __shfl_sync(kAll, ek, em ? 31 - __clz(em) : 0);  // key before
    if (!em) pk = -1;
    bool again = false;        // a run's key seen before: not grouped
    int last_start = -1;
    bool todo[kMaxIpt];
    uint32_t h[kMaxIpt];
#pragma unroll
    for (int s = 0; s < kMaxIpt; ++s) {
      const unsigned km = __ballot_sync(kAll, key[s] >= 0);
      const unsigned below = km & lt;
      const int bk = __shfl_sync(kAll, key[s], below ? 31 - __clz(below) : 0);
      todo[s] = key[s] >= 0 && (below ? bk : pk) != key[s];
      starts[s] = __ballot_sync(kAll, todo[s]);
      h[s] = (uint32_t(key[s]) * 0x9E3779B1u) >> (32 - tbits);
      const int k = __shfl_sync(kAll, key[s], km ? 31 - __clz(km) : 0);
      if (km) pk = k;
      if (starts[s]) last_start = warp * ipw + s * 32 + 31 - __clz(starts[s]);
    }
    // every run start claims its key's slot; a thread's claims are in
    // flight together (a step without one swaps nothing in a word of its
    // own, which never holds -1)
    for (bool more = true; more;) {
      more = false;
      int cur[kMaxIpt];
#pragma unroll
      for (int s = 0; s < kMaxIpt; ++s)
        cur[s] = atomicCAS(todo[s] ? const_cast<int*>(tkey + h[s]) : idle,
                           -1, key[s]);
#pragma unroll
      for (int s = 0; s < kMaxIpt; ++s) {
        if (!todo[s]) continue;
        if (cur[s] == -1) {
          tval[h[s]] = warp * ipw + s * 32 + lane;
          todo[s] = false;
        } else if (cur[s] == key[s]) {
          again = true;
          todo[s] = false;
        } else {
          h[s] = (h[s] + 1) & uint32_t(ts - 1);
          more = true;
        }
      }
    }
    if (lane == 0) wsum[warp] = uint32_t(last_start);
    *first = 0;
    if (!__syncthreads_or(again)) {  // grouped: d = the run's first row
      int carry = lane < warp ? int(wsum[lane]) : -1;  // -1: no run yet
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        carry = max(carry, __shfl_xor_sync(kAll, carry, o));
#pragma unroll
      for (int s = 0; s < kMaxIpt; ++s) {
        const int i = warp * ipw + s * 32 + lane;
        const unsigned m = starts[s] & (lt | (1u << lane));
        const int d = m ? warp * ipw + s * 32 + 31 - __clz(m)
                        : carry >= 0 ? carry : i;
        if (s < ipt && i < n)
          a[padded(i)] = (uint64_t(d) << 32) | (key[s] >= 0 ? 0u : kNeg)
                         | uint32_t(i);
        if (starts[s]) carry = warp * ipw + s * 32 + 31 - __clz(starts[s]);
      }
      __syncthreads();
      return 0;
    }
  }
  // not grouped: the first row of each run of equal keys in a warp step
  // probes the table, which keeps the key's first row
  uint32_t slot[kMaxIpt];
  unsigned firsts[kMaxIpt];
  bool todo[kMaxIpt];
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {  // runs skip rows with ident < 0
    const unsigned below = __ballot_sync(kAll, key[s] >= 0) & lt;
    const int before = __shfl_sync(kAll, key[s], below ? 31 - __clz(below) : 0);
    const bool first = key[s] >= 0 && (!below || before != key[s]);
    firsts[s] = __ballot_sync(kAll, first);
    todo[s] = s < ipt && first;
    slot[s] = (uint32_t(key[s]) * 0x9E3779B1u) >> (32 - tbits);
  }
  for (bool more = true; more;) {  // claims in flight together, as above
    more = false;
    int cur[kMaxIpt];
#pragma unroll
    for (int s = 0; s < kMaxIpt; ++s)
      cur[s] = atomicCAS(todo[s] ? const_cast<int*>(tkey + slot[s]) : idle,
                         -1, key[s]);
#pragma unroll
    for (int s = 0; s < kMaxIpt; ++s) {
      const bool found = todo[s] && (cur[s] == -1 || cur[s] == key[s]);
      atomicMin(found ? tval + slot[s] : idle, warp * ipw + s * 32 + lane);
      if (found) {
        todo[s] = false;
      } else if (todo[s]) {
        slot[s] = (slot[s] + 1) & uint32_t(ts - 1);
        more = true;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s)
    slot[s] = __shfl_sync(kAll, slot[s],
                          31 - __clz(firsts[s] & (lt | (1u << lane))));
  __syncthreads();
  // number the keys in row order of their first rows
  unsigned heads[kMaxIpt];
  int c = 0;
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {
    if (s < ipt) {
      const int i = warp * ipw + s * 32 + lane;
      heads[s] = __ballot_sync(kAll, key[s] >= 0 && tval[slot[s]] == i);
      c += __popc(heads[s]);
    }
  }
  if (lane == 0) wsum[warp] = c;
  __syncthreads();
  const uint32_t x = lane < kSortWarps ? wsum[lane] : 0;
  const uint32_t inc = warp_incl_scan(x);
  const uint32_t groups = __shfl_sync(kAll, inc, 31);
  uint32_t seen = __shfl_sync(kAll, inc - x, warp);  // before this warp
  uint32_t newest[kMaxIpt];  // the id of the last key first seen so far
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {
    if (s < ipt) {
      if ((heads[s] >> lane) & 1u) tval[slot[s]] = seen + __popc(heads[s] & lt);
      const uint32_t upto = seen + __popc(heads[s] & (lt | (1u << lane)));
      newest[s] = upto ? upto - 1 : 0;
      seen += __popc(heads[s]);
    } else {
      newest[s] = 0;
    }
  }
  __syncthreads();
  uint64_t item[kMaxIpt];
#pragma unroll
  for (int s = 0; s < kMaxIpt; ++s) {
    const int i = warp * ipw + s * 32 + lane;
    const uint32_t d = key[s] >= 0 ? uint32_t(tval[slot[s]]) : newest[s];
    item[s] = (uint64_t(d) << 32) | (key[s] < 0 ? kNeg : 0u) | uint32_t(i);
  }
  // the first pass, straight from the registers
  const int bits = 32 - __clz(groups - 1);  // not grouped: two keys or more
  *first = sort_digits(bits);
  place_round(item, ipt, n, 0, 32, *first, a, cnt, nullptr, wsum, false);
  return bits;
}

// Items (key << 32 | kNeg if ident < 0 | i) in a[0, n), ident < 0 mapped
// to one key above every key. Returns the keys' bit count.
__device__ int raw_key_items(const int32_t* __restrict__ ident, int n,
                             uint64_t* a, uint32_t* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int mx = -1;
  for (int x = tid; x < n; x += kSortThreads) mx = max(mx, ident[x]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(kAll, mx, o));
  if (lane == 0) wsum[warp] = uint32_t(mx);
  __syncthreads();
  mx = -1;
  for (int x = 0; x < kSortWarps; ++x) mx = max(mx, int(wsum[x]));
  const uint32_t above = uint32_t(mx) + 1u;  // <= 2^31; 0 if no key
  for (int x = tid; x < n; x += kSortThreads) {
    const int k = ident[x];
    a[padded(x)] = (uint64_t(k >= 0 ? uint32_t(k) : above) << 32)
         | (k < 0 ? kNeg : 0u) | uint32_t(x);
  }
  __syncthreads();
  return above ? 32 - __clz(above) : 0;
}

__device__ int lower_bound(const uint64_t* s, int n, uint32_t g) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_of(s[padded(mid)]) < g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ int upper_bound(const uint64_t* s, int n, uint32_t g) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_of(s[padded(mid)]) <= g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first position in [0, n) whose key is >= g (upper: > g), found by
// one warp probing 32 positions a step (three steps at n = 4096).
__device__ int warp_bound(const uint64_t* s, int n, uint32_t g, bool upper) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const uint32_t key = p < hi ? key_of(s[padded(p)]) : 0;
    const bool past = p >= hi || (upper ? key > g : key >= g);
    const unsigned m = __ballot_sync(kAll, past);
    const int f = m ? __ffs(m) - 1 : 32;
    const int new_hi = f < 32 ? min(hi, lo + f * step) : hi;
    lo = f > 0 ? lo + (f - 1) * step + 1 : lo;
    hi = new_hi;
  }
  return lo;
}

// (f, l) of tile k of the sorted items s: the tiles holding the start of
// its first segment and the end of its last
__device__ int2 tile_span(const uint64_t* s, int n, int k) {
  const int p0 = k * kTile, e0 = min(n, p0 + kTile) - 1;
  const uint32_t g0 = key_of(s[padded(p0)]), g1 = key_of(s[padded(e0)]);
  const int f = p0 == 0 || key_of(s[padded(p0 - 1)]) != g0
      ? k : lower_bound(s, n, g0) / kTile;
  const int l = e0 == n - 1 || key_of(s[padded(e0 + 1)]) != g1
      ? k : (upper_bound(s, n, g1) - 1) / kTile;
  return make_int2(f, l);
}

// Four lanes from col on (zeros past w): one 4- or 16-byte access when
// kVec (w % 4 == 0 and aligned rows), else one access per lane. Loads are
// predicated, not branched, so a caller's unrolled loads stay in flight
// together.
template <bool kVec>
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ p,
                                          int col, int w) {
  if (kVec) {
    uint32_t x = 0;
    if (col < w) x = *reinterpret_cast<const uint32_t*>(p + col);
    return x;
  }
  uint32_t x = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < w) x |= uint32_t(p[col + e]) << (8 * e);
  return x;
}

template <bool kVec>
__device__ __forceinline__ void store_bytes4(uint8_t* __restrict__ p, int col,
                                             int w, uint32_t x) {
  if (kVec) {
    if (col < w) *reinterpret_cast<uint32_t*>(p + col) = x;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < w) p[col + e] = uint8_t(x >> (8 * e));
  }
}

__device__ __forceinline__ int byte_of(uint32_t x, int e) {
  return (x >> (8 * e)) & 0xff;
}

template <bool kVec>
__device__ __forceinline__ void ivec4(const int* __restrict__ p, int col,
                                      int w, int v[4]) {
  if (kVec) {
    int4 m = make_int4(0, 0, 0, 0);
    if (col < w) m = __ldcg(reinterpret_cast<const int4*>(p + col));
    v[0] = m.x; v[1] = m.y; v[2] = m.z; v[3] = m.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = col + e < w ? __ldcg(p + col + e) : 0;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* __restrict__ p, int col,
                                       int w, const int v[4]) {
  if (kVec) {
    if (col < w)
      *reinterpret_cast<int4*>(p + col) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < w) p[col + e] = v[e];
  }
}

// Tile k's rows, lane j holding sorted position p0 + j: which count
// (ident >= 0), where the tile's first segment ends (hf) and its last
// starts (hl); with `write`, the permutation and head flags are stored.
struct TileRows {
  int p0, rows, hf, hl;      // P: rows < hf; S: rows >= hl
  unsigned counted;
  uint32_t row;              // lane j: the chunk row at sorted p0 + j
};

__device__ TileRows tile_rows(const uint64_t* s, int n, int k, bool write,
                              const Ws& ws) {
  const int lane = threadIdx.x & 31;
  TileRows t;
  t.p0 = k * kTile;
  t.rows = min(kTile, n - t.p0);
  const bool ok = lane < t.rows;
  const uint64_t item = ok ? s[padded(t.p0 + lane)] : 0;
  const uint32_t key = key_of(item);
  uint32_t prev = __shfl_up_sync(kAll, key, 1);
  if (lane == 0) prev = t.p0 > 0 ? key_of(s[padded(t.p0 - 1)]) : ~key;
  const bool head = ok && prev != key;
  if (ok && write) {
    ws.perm[t.p0 + lane] = uint32_t(item);
    ws.head[t.p0 + lane] = head;
  }
  const unsigned heads = __ballot_sync(kAll, head);
  const unsigned later = heads & ~1u;
  t.hf = later ? __ffs(later) - 1 : t.rows;
  t.hl = heads ? 31 - __clz(heads) : 0;
  t.counted = __ballot_sync(kAll, ok && !(uint32_t(item) & kNeg));
  t.row = uint32_t(item) & ~kNeg;  // row 0 past rows
  return t;
}

__device__ __forceinline__ void add_row(const TileRows& t, int j, uint32_t x,
                                        int a[4], int p[4], int sm[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = byte_of(x, e);
    a[e] += m;
    if (j < t.hf) p[e] += m;
    if (j >= t.hl) sm[e] += m;
  }
}

// lane sums held as 16-bit fields: [0] bytes 0 and 2, [1] bytes 1 and 3
__device__ __forceinline__ void unpack_fields(const uint32_t f[2], int v[4]) {
  v[0] = f[0] & 0xffff;
  v[1] = f[1] & 0xffff;
  v[2] = f[0] >> 16;
  v[3] = f[1] >> 16;
}

template <bool kVec>
__device__ __forceinline__ void store_aggregates(const Ws& ws, int nt, int k,
                                                 int w, int col, const int a[4],
                                                 const int p[4],
                                                 const int sm[4]) {
  int* aggA = ws.agg + size_t(k) * w;
  store4<kVec>(aggA, col, w, a);
  store4<kVec>(aggA + size_t(nt) * w, col, w, p);
  store4<kVec>(aggA + 2 * size_t(nt) * w, col, w, sm);
}

// Tile k by one warp: its matches rows in sorted order (zeros where
// ident < 0) and A, P and S; the row loads of each half tile are in flight
// together (a whole tile's 32 loads and their addresses push the kernel
// past 128 registers, and ptxas then spills all through it).
template <bool kVec>
__device__ void tile_by_warp(const uint64_t* s, int n, int k,
                             const uint8_t* __restrict__ matches, int w,
                             const Ws& ws) {
  const int lane = threadIdx.x & 31;
  const int nt = (n + kTile - 1) / kTile;
  const TileRows t = tile_rows(s, n, k, true, ws);
  constexpr int kHalf = kTile / 2;
  for (int c0 = 0; c0 < w; c0 += kLaneChunk) {
    const int col = c0 + 4 * lane;
    int a[4] = {0, 0, 0, 0}, p[4] = {0, 0, 0, 0}, sm[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int h = 0; h < kTile; h += kHalf) {
      uint32_t x[kHalf];
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        x[j] = load4<kVec>(
            matches + size_t(__shfl_sync(kAll, t.row, h + j)) * w, col, w);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        if (!((t.counted >> (h + j)) & 1u)) x[j] = 0;
        if (h + j < t.rows)
          store_bytes4<kVec>(ws.rows + size_t(t.p0 + h + j) * w, col, w,
                             x[j]);
        add_row(t, h + j, x[j], a, p, sm);
      }
    }
    store_aggregates<kVec>(ws, nt, k, w, col, a, p, sm);
  }
}

// Tile k by the whole block, warp q taking rows q, q + kSortWarps, ...
// (one load each). Row sums are packed, the even and the odd bytes of a
// thread's four lanes in two words of 16-bit fields; each warp adds its
// rows into `part` and 96 threads add the warps' sums.
template <bool kVec>
__device__ void tile_by_block(const uint64_t* s, int n, int k,
                              const uint8_t* __restrict__ matches, int w,
                              const Ws& ws, uint32_t* part) {
  constexpr int kRows = kTile / kSortWarps;
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int nt = (n + kTile - 1) / kTile;
  const TileRows t = tile_rows(s, n, k, q == 0, ws);
  for (int c0 = 0; c0 < w; c0 += kLaneChunk) {
    const int col = c0 + 4 * lane;
    uint32_t x[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = q + u * kSortWarps;
      const uint32_t rj = __shfl_sync(kAll, t.row, j);
      x[u] = 0;
      if ((t.counted >> j) & 1u)
        x[u] = load4<kVec>(matches + size_t(rj) * w, col, w);
    }
    if (c0 == 0 && q >= kSortWarps - 2) {  // f and l, while the loads fly
      const bool upper = q == kSortWarps - 1;
      const int e = upper ? min(n, t.p0 + kTile) - 1 : t.p0;
      const uint32_t g = key_of(s[padded(e)]);
      const int next = upper ? e + 1 : e - 1;
      const bool inside =
          next >= 0 && next < n && key_of(s[padded(next)]) == g;
      const int bound = inside ? warp_bound(s, n, g, upper) : 0;
      const int tile = !inside ? k
                     : upper ? (bound - 1) / kTile : bound / kTile;
      if (lane == 0) reinterpret_cast<int*>(ws.meta + k)[upper] = tile;
    }
    // part[((acc * 2 + half) * kSortWarps + q) * 32 + lane], acc: A, P, S
    uint32_t f[3][2] = {{0, 0}, {0, 0}, {0, 0}};
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = q + u * kSortWarps;
      if (j < t.rows)
        store_bytes4<kVec>(ws.rows + size_t(t.p0 + j) * w, col, w, x[u]);
      const uint32_t h[2] = {x[u] & 0x00ff00ffu, (x[u] >> 8) & 0x00ff00ffu};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        f[0][e] += h[e];
        if (j < t.hf) f[1][e] += h[e];
        if (j >= t.hl) f[2][e] += h[e];
      }
    }
#pragma unroll
    for (int acc = 0; acc < 3; ++acc)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part[((acc * 2 + e) * kSortWarps + q) * 32 + lane] = f[acc][e];
    __syncthreads();
    if (threadIdx.x < 3 * 32) {  // thread: (acc, lane)
      const int acc = threadIdx.x >> 5;
      uint32_t sum[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x2 = 0; x2 < kSortWarps; ++x2)
          sum[e] += part[((acc * 2 + e) * kSortWarps + x2) * 32 + lane];
      int v[4];
      unpack_fields(sum, v);
      store4<kVec>(ws.agg + (size_t(acc) * nt + k) * w, col, w, v);
    }
    if (c0 + kLaneChunk < w) __syncthreads();  // part is reused
  }
}

// Q[k] = sum of A over the tiles before k, by a single block
__device__ void tile_prefix(const Ws& ws, int nt, int w, int* part_sum) {
  const int tid = threadIdx.x;
  const int col = tid & (kLaneChunk - 1), part = tid / kLaneChunk;
  constexpr int kParts = kSortThreads / kLaneChunk;
  constexpr int kBatch = 8;
  const int per = (nt + kParts - 1) / kParts;
  const int m0 = min(nt, part * per), m1 = min(nt, m0 + per);
  for (int c0 = 0; c0 < w; c0 += kLaneChunk) {
    const int c = c0 + col;
    int sum = 0;
    for (int m = m0; m < m1; m += kBatch) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = c < w && m + u < m1 ? ws.agg[size_t(m + u) * w + c] : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) sum += v[u];
    }
    part_sum[part * kLaneChunk + col] = sum;
    __syncthreads();
    int run = 0;
    for (int x = 0; x < part; ++x) run += part_sum[x * kLaneChunk + col];
    for (int m = m0; m < m1; m += kBatch) {
      int v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = c < w && m + u < m1 ? ws.agg[size_t(m + u) * w + c] : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c < w && m + u < m1) ws.q[size_t(m + u) * w + c] = run;
        run += v[u];
      }
    }
    __syncthreads();
  }
}

struct ScanShared {
  int pre[kScanWarps][kLaneChunk];
  int suf[kScanWarps][kLaneChunk];
  int in[kScanWarps][kLaneChunk];
  int out[kScanWarps][kLaneChunk];
  int head[kScanWarps];
};

// The carries from other tiles into tile k's first segment (which starts
// in tile f = fl.x) and out of its last (which ends in tile l = fl.y), this
// warp's share: warp 0 takes S[f] and P[l] (loaded ahead for f = k - 1 and
// l = k + 1, the usual case), and the warps split the tiles in between, or
// with Q (one-block launch) warp 0 takes all of it.
template <bool kVec>
__device__ void carries(const Ws& ws, int nt, int k, int w, int col, int q,
                        bool have_q, int cin[4], int cout[4]) {
  const size_t ntw = size_t(nt) * w;
  const int* aggA = ws.agg;
  const int* aggP = ws.agg + ntw;
  const int* aggS = ws.agg + 2 * ntw;
  for (int e = 0; e < 4; ++e) cin[e] = cout[e] = 0;
  if (q == 0 && !have_q) {
    if (k > 0) ivec4<kVec>(aggS + size_t(k - 1) * w, col, w, cin);
    if (k + 1 < nt) ivec4<kVec>(aggP + size_t(k + 1) * w, col, w, cout);
  }
  const int2 fl = ws.meta[k];
  if (have_q) {
    if (q == 0 && fl.x < k) {
      int sf[4], qk[4], qf[4];
      ivec4<kVec>(aggS + size_t(fl.x) * w, col, w, sf);
      ivec4<kVec>(ws.q + size_t(k) * w, col, w, qk);
      ivec4<kVec>(ws.q + size_t(fl.x + 1) * w, col, w, qf);
      for (int e = 0; e < 4; ++e) cin[e] = sf[e] + qk[e] - qf[e];
    }
    if (q == 0 && fl.y > k) {
      int pl[4], ql[4], qk1[4];
      ivec4<kVec>(aggP + size_t(fl.y) * w, col, w, pl);
      ivec4<kVec>(ws.q + size_t(fl.y) * w, col, w, ql);
      ivec4<kVec>(ws.q + size_t(k + 1) * w, col, w, qk1);
      for (int e = 0; e < 4; ++e) cout[e] = ql[e] - qk1[e] + pl[e];
    }
    return;
  }
  int x[4];
  if (q == 0 && fl.x < k - 1)
    ivec4<kVec>(aggS + size_t(fl.x) * w, col, w, cin);
  if (q == 0 && fl.x == k) cin[0] = cin[1] = cin[2] = cin[3] = 0;
#pragma unroll 8
  for (int m = fl.x + 1 + q; m < k; m += kScanWarps) {
    ivec4<kVec>(aggA + size_t(m) * w, col, w, x);
    for (int e = 0; e < 4; ++e) cin[e] += x[e];
  }
  if (q == 0 && fl.y > k + 1)
    ivec4<kVec>(aggP + size_t(fl.y) * w, col, w, cout);
  if (q == 0 && fl.y == k) cout[0] = cout[1] = cout[2] = cout[3] = 0;
#pragma unroll 8
  for (int m = k + 1 + q; m < fl.y; m += kScanWarps) {
    ivec4<kVec>(aggA + size_t(m) * w, col, w, x);
    for (int e = 0; e < 4; ++e) cout[e] += x[e];
  }
}

// Tile k, lanes [128 chunk, 128 chunk + 128): eight warps of four rows.
template <bool kVec>
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int n, int w, bool have_q, Ws ws,
                  int32_t* __restrict__ r_out, int32_t* __restrict__ t_out) {
  __shared__ ScanShared sh;
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int k = blockIdx.x, nt = gridDim.x, chunk = blockIdx.y;
  const int col = chunk * kLaneChunk + 4 * lane;
  const int pw = k * kTile + q * kRowsPerWarp;
  int v[kRowsPerWarp][4], incl[kRowsPerWarp][4];
  uint32_t idx[kRowsPerWarp];
  bool head[kRowsPerWarp];
  {
    // this warp's rows, which kernel 1 wrote in sorted order (no gather,
    // no wait on the permutation); rows past n are empty heads
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int p = pw + j;
      idx[j] = p < n ? ws.perm[p] : kNeg;
      head[j] = p < n ? ws.head[p] != 0 : true;
      const uint32_t x = p < n ? load4<kVec>(ws.rows + size_t(p) * w, col, w)
                               : 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = byte_of(x, e);
    }
    int cin[4], cout[4];
    carries<kVec>(ws, nt, k, w, col, q, have_q, cin, cout);
    // segmented inclusive scan of the warp's rows
    int run[4] = {0, 0, 0, 0}, pre[4] = {0, 0, 0, 0};
    bool seen = false;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      if (head[j]) {
        seen = true;
#pragma unroll
        for (int e = 0; e < 4; ++e) run[e] = 0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run[e] += v[j][e];
        incl[j][e] = run[e];
        if (!seen) pre[e] += v[j][e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sh.pre[q][4 * lane + e] = pre[e];
      sh.suf[q][4 * lane + e] = run[e];
      sh.in[q][4 * lane + e] = cin[e];
      sh.out[q][4 * lane + e] = cout[e];
    }
    if (lane == 0) sh.head[q] = seen;
  }
  __syncthreads();

  // into the first segment: earlier warps back to a head, else the tile's
  // carry in; out of the last: later warps up to a head, else carry out
  int ci[4] = {0, 0, 0, 0}, co[4] = {0, 0, 0, 0};
  bool stop = false;
  for (int x = q - 1; x >= 0 && !stop; --x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ci[e] += sh.suf[x][4 * lane + e];
    stop = sh.head[x] != 0;
  }
  if (!stop) {
    for (int x = 0; x < kScanWarps; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ci[e] += sh.in[x][4 * lane + e];
    }
  }
  stop = false;
  for (int x = q + 1; x < kScanWarps && !stop; ++x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) co[e] += sh.pre[x][4 * lane + e];
    stop = sh.head[x] != 0;
  }
  if (!stop) {
    for (int x = 0; x < kScanWarps; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) co[e] += sh.out[x][4 * lane + e];
    }
  }

  bool after = false;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    after = after || head[j];
    if (!after) {
#pragma unroll
      for (int e = 0; e < 4; ++e) incl[j][e] += ci[e];
    }
  }
  int tot[4];
#pragma unroll
  for (int j = kRowsPerWarp - 1; j >= 0; --j) {
    if (j == kRowsPerWarp - 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[e] = incl[j][e] + co[e];
    } else if (head[j + 1]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[e] = incl[j][e];
    }
    if (pw + j < n) {
      const bool neg = (idx[j] & kNeg) != 0;
      int rv[4], tv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rv[e] = neg ? 0 : incl[j][e] - v[j][e];
        tv[e] = neg ? 0 : tot[e];
      }
      const size_t o = size_t(idx[j] & ~kNeg) * w;
      store4<kVec>(r_out + o, col, w, rv);
      store4<kVec>(t_out + o, col, w, tv);
    }
  }
}


template <bool kVec>
__global__ void __launch_bounds__(kSortThreads, 1)
sort_tiles_kernel(const int32_t* __restrict__ ident,
                  const uint8_t* __restrict__ matches, int n, int w, Ws ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  uint32_t* gbase = reinterpret_cast<uint32_t*>(smem + kGbaseOff);
  uint32_t* wsum = reinterpret_cast<uint32_t*>(smem + kWsumOff);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nt = (n + kTile - 1) / kTile;

  uint64_t *a, *b;
  int bits, done = 0;  // key bits to sort on; bits already sorted on
  if (n <= kSmemSortCap) {  // [table | a]; b reuses the table's memory
    const size_t table = size_t(table_size(n)) * 8;
    a = reinterpret_cast<uint64_t*>(smem + kHeader + table);
    b = reinterpret_cast<uint64_t*>(smem + kHeader);
    bits = group_items(ident, n, a, smem + kHeader, cnt, wsum, gbase, &done);
  } else {
    a = ws.buf0;
    b = ws.buf1;
    bits = raw_key_items(ident, n, a, wsum);
  }
  const int per = bits > 0 ? sort_digits(bits) : 0;
  for (int shift = done; shift < bits; shift += per) {
    radix_pass(a, b, n, 32 + shift, min(per, bits - shift), cnt, gbase, wsum);
    uint64_t* t = a;
    a = b;
    b = t;
  }

  // this block's tiles: k = blockIdx.x + x * gridDim.x
  static_assert(kTile % kSortWarps == 0, "whole rows per warp");
  if (nt <= int(gridDim.x)) {  // one tile per block, for every warp
    if (int(blockIdx.x) < nt)
      tile_by_block<kVec>(a, n, blockIdx.x, matches, w, ws, cnt);
  } else {
    for (int k = blockIdx.x + tid * gridDim.x; k < nt;
         k += kSortThreads * gridDim.x)
      ws.meta[k] = tile_span(a, n, k);
    for (int k = blockIdx.x + warp * gridDim.x; k < nt;
         k += kSortWarps * gridDim.x)
      tile_by_warp<kVec>(a, n, k, matches, w, ws);
  }
  if (gridDim.x == 1) {
    __syncthreads();
    tile_prefix(ws, nt, w, reinterpret_cast<int*>(cnt));
  }
}


int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(sort_tiles_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(kMaxSmem));
    cudaFuncSetAttribute(sort_tiles_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(kMaxSmem));
  }
  return count[dev] > 0 ? count[dev] : 1;
}

template <bool kVec>
void launch(const int32_t* ident, const uint8_t* matches, int32_t* r,
            int32_t* t, int n, int w, const Ws& ws, cudaStream_t s,
            size_t smem, int blocks) {
  sort_tiles_kernel<kVec><<<blocks, kSortThreads, smem, s>>>(
      ident, matches, n, w, ws);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  const int nt = (n + kTile - 1) / kTile;
  const dim3 grid(nt, (w + kLaneChunk - 1) / kLaneChunk);
  scan_tiles_kernel<kVec><<<grid, kScanThreads, 0, s>>>(
      n, w, blocks == 1, ws, r, t);
}

}  // namespace

// Bytes of workspace that rank_totals_launch needs for (n, w).
extern "C" size_t rank_totals_workspace_bytes(int n, int w) {
  return n > 0 && w > 0 ? layout(n, w).total : 0;
}

// ident: int32[n]; matches: uint8/bool[n, w] row-major; r, t: int32[n, w];
// workspace: rank_totals_workspace_bytes(n, w) bytes, not shared with a
// launch that may run at the same time. Launches two kernels on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int rank_totals_launch(const void* ident, const void* matches,
                                  void* r, void* t, int n, int w,
                                  void* workspace, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const Layout l = layout(n, w);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  Ws ws;
  ws.meta = reinterpret_cast<int2*>(base + l.meta);
  ws.perm = reinterpret_cast<uint32_t*>(base + l.perm);
  ws.head = base + l.head;
  ws.rows = base + l.rows;
  ws.agg = reinterpret_cast<int*>(base + l.agg);
  ws.q = reinterpret_cast<int*>(base + l.q);
  ws.buf0 = reinterpret_cast<uint64_t*>(base + l.buf0);
  ws.buf1 = reinterpret_cast<uint64_t*>(base + l.buf1);
  const bool vec = (w & 3) == 0
      && (reinterpret_cast<uintptr_t>(matches) & 3) == 0;
  const int nt = (n + kTile - 1) / kTile;
  const int sms = sm_count();  // also sets the shared-memory attribute
  size_t smem = kHeader;
  int blocks = 1;
  if (n <= kSmemSortCap) {
    smem += size_t(table_size(n)) * 8 + padded(n) * 8;
    blocks = nt < sms ? nt : sms;
  }
  (vec ? launch<true> : launch<false>)(
      static_cast<const int32_t*>(ident), static_cast<const uint8_t*>(matches),
      static_cast<int32_t*>(r), static_cast<int32_t*>(t), n, w, ws,
      static_cast<cudaStream_t>(stream), smem, blocks);
  return static_cast<int>(cudaGetLastError());
}

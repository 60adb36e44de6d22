// Native row serde: batch key/value encoding for the checkpoint path.
//
// C++ counterpart of the hot host-side encoding loops in
// common/row.py (the upstream system implements the same tier in
// Rust: src/common/src/util/value_encoding/ and util/memcmp_encoding.rs).
// The checkpoint write path walks dirty device rows on the host; doing the
// per-row, per-column byte packing in Python dominates barrier cost at
// real state sizes, so this library encodes whole dirty batches from
// columnar numpy buffers in one call.
//
// Byte formats are EXACTLY those of common/row.py (tests cross-check):
//   value row:  per column: 0x00 (null) | 0x01 + payload
//               bool: 1 byte; int*: little-endian int64; float: LE f64;
//               string: u32 LE length + utf8 bytes
//   key:        per column: 0x00 (null) | 0x01 + memcomparable payload
//               bool: 1 byte; int16/32/64: sign-flipped big-endian;
//               float: order-preserving f64 bit transform;
//               string: 0x00 -> 0x00 0xff escape, 0x00 0x00 terminator
//
// Type codes: 0=bool(u8), 1=int16, 2=int32, 3=int64, 4=float32,
//             5=float64, 6=string (data = int64 uniq index per row;
//             blob/offsets give the uniq string table).

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t f64_key_bits(double v) {
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    if (bits & (1ULL << 63)) {
        bits = ~bits;                 // negative: flip all
    } else {
        bits |= (1ULL << 63);         // positive: flip sign
    }
    return bits;
}

inline void put_be(unsigned char* out, uint64_t v, int nbytes) {
    for (int i = 0; i < nbytes; ++i) {
        out[i] = (unsigned char)(v >> (8 * (nbytes - 1 - i)));
    }
}

struct ColView {
    int code;
    const void* data;
    const unsigned char* mask;
    const unsigned char* blob;        // string uniq blob (code 6)
    const long long* offsets;         // uniq offsets, len = n_uniq + 1
};

inline double load_f(const ColView& c, long long row) {
    if (c.code == 4) return (double)((const float*)c.data)[row];
    return ((const double*)c.data)[row];
}

inline int64_t load_i(const ColView& c, long long row) {
    switch (c.code) {
        case 0: return ((const unsigned char*)c.data)[row];
        case 1: return ((const int16_t*)c.data)[row];
        case 2: return ((const int32_t*)c.data)[row];
        default: return ((const int64_t*)c.data)[row];
    }
}

// returns bytes written, or -1 on overflow of [out, out+cap)
inline long long enc_value_col(const ColView& c, long long row,
                               unsigned char* out, long long cap) {
    if (!c.mask[row]) {
        if (cap < 1) return -1;
        out[0] = 0x00;
        return 1;
    }
    long long w = 0;
    if (cap < 2) return -1;
    out[w++] = 0x01;
    switch (c.code) {
        case 0:
            out[w++] = ((const unsigned char*)c.data)[row] ? 1 : 0;
            break;
        case 4: case 5: {
            if (cap < 1 + 8) return -1;
            double d = load_f(c, row);
            std::memcpy(out + w, &d, 8);    // little-endian host assumed
            w += 8;
            break;
        }
        case 6: {
            long long u = ((const int64_t*)c.data)[row];
            long long lo = c.offsets[u], hi = c.offsets[u + 1];
            long long n = hi - lo;
            if (cap < 1 + 4 + n) return -1;
            uint32_t len32 = (uint32_t)n;
            std::memcpy(out + w, &len32, 4);
            w += 4;
            std::memcpy(out + w, c.blob + lo, n);
            w += n;
            break;
        }
        default: {
            if (cap < 1 + 8) return -1;
            int64_t v = load_i(c, row);
            std::memcpy(out + w, &v, 8);
            w += 8;
            break;
        }
    }
    return w;
}

inline long long enc_key_col(const ColView& c, long long row,
                             unsigned char* out, long long cap) {
    if (!c.mask[row]) {
        if (cap < 1) return -1;
        out[0] = 0x00;
        return 1;
    }
    if (cap < 2) return -1;
    long long w = 0;
    out[w++] = 0x01;
    switch (c.code) {
        case 0:
            out[w++] = ((const unsigned char*)c.data)[row] ? 1 : 0;
            break;
        case 1: {
            if (cap < 1 + 2) return -1;
            uint64_t u = (uint64_t)(load_i(c, row) + (1LL << 15));
            put_be(out + w, u, 2);
            w += 2;
            break;
        }
        case 2: {
            if (cap < 1 + 4) return -1;
            uint64_t u = (uint64_t)(load_i(c, row) + (1LL << 31));
            put_be(out + w, u, 4);
            w += 4;
            break;
        }
        case 4: case 5: {
            if (cap < 1 + 8) return -1;
            put_be(out + w, f64_key_bits(load_f(c, row)), 8);
            w += 8;
            break;
        }
        case 6: {
            long long u = ((const int64_t*)c.data)[row];
            long long lo = c.offsets[u], hi = c.offsets[u + 1];
            for (long long i = lo; i < hi; ++i) {
                unsigned char ch = c.blob[i];
                if (ch == 0x00) {
                    if (w + 2 > cap) return -1;
                    out[w++] = 0x00;
                    out[w++] = 0xff;
                } else {
                    if (w + 1 > cap) return -1;
                    out[w++] = ch;
                }
            }
            if (w + 2 > cap) return -1;
            out[w++] = 0x00;
            out[w++] = 0x00;
            break;
        }
        default: {
            if (cap < 1 + 8) return -1;
            uint64_t u = (uint64_t)load_i(c, row) ^ (1ULL << 63);
            put_be(out + w, u, 8);
            w += 8;
            break;
        }
    }
    return w;
}

inline long long encode_rows(bool key_mode, int ncols, const ColView* cols,
                             const long long* idx, long long n_sel,
                             unsigned char* out, long long out_cap,
                             long long* out_offsets) {
    long long pos = 0;
    out_offsets[0] = 0;
    for (long long r = 0; r < n_sel; ++r) {
        long long row = idx[r];
        for (int ci = 0; ci < ncols; ++ci) {
            long long w = key_mode
                ? enc_key_col(cols[ci], row, out + pos, out_cap - pos)
                : enc_value_col(cols[ci], row, out + pos, out_cap - pos);
            if (w < 0) return -1;
            pos += w;
        }
        out_offsets[r + 1] = pos;
    }
    return pos;
}

}  // namespace

extern "C" {

// Shared signature for both encoders. Per column i:
//   typecodes[i], data[i], masks[i]; for code-6 columns blob[i]/offsets[i]
//   hold the uniq string table and data[i] is int64 uniq-index per row.
// idx selects rows; returns total bytes or -1 if out_cap is too small.
long long rw_encode(int key_mode, int ncols, const int* typecodes,
                    const void** data, const unsigned char** masks,
                    const unsigned char** blobs, const long long** offsets,
                    const long long* idx, long long n_sel,
                    unsigned char* out, long long out_cap,
                    long long* out_offsets) {
    ColView cols[256];
    if (ncols > 256) return -2;
    for (int i = 0; i < ncols; ++i) {
        cols[i].code = typecodes[i];
        cols[i].data = data[i];
        cols[i].mask = masks[i];
        cols[i].blob = blobs ? blobs[i] : nullptr;
        cols[i].offsets = offsets ? offsets[i] : nullptr;
    }
    return encode_rows(key_mode != 0, ncols, cols, idx, n_sel, out, out_cap,
                       out_offsets);
}

int rw_abi_version() { return 1; }

}  // extern "C"

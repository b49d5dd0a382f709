// Host decode of Parquet column chunks for the port's reader
// (spark_rapids_tpu_torch/io/parquet.py), in place of pyarrow's C++ reader,
// which the reference uses (spark_rapids_tpu/io/parquet.py).
//
// A plain C interface, loaded with ctypes, which releases the interpreter
// lock for every call: the reader's threads decode files in parallel.
//   * pq_snappy_length / pq_snappy_decompress: SNAPPY raw blocks (Spark's
//     default codec);
//   * pq_rle_decode: the RLE/bit-packed hybrid of definition levels and
//     dictionary indices (a bit-packed run's last group padded to 8
//     values);
//   * pq_byte_array_split / pq_fill_fixed: PLAIN BYTE_ARRAY values (a
//     4-byte length before each) split, then copied into fixed-width rows
//     (numpy's ``S`` layout, zero past each value);
//   * pq_gather: the dictionary gather of fixed-width values;
//   * pq_scatter: the null scatter of dense values into their rows.
// Every function checks its bounds and returns a negative number on
// malformed input; none allocates.
#include <cstdint>
#include <cstring>

extern "C" {

// The uncompressed length in a SNAPPY block's preamble, or -1.
int64_t pq_snappy_length(const uint8_t* src, int64_t n) {
    uint64_t out = 0;
    for (int shift = 0, i = 0; i < n && shift < 35; ++i, shift += 7) {
        out |= (uint64_t)(src[i] & 0x7F) << shift;
        if (!(src[i] & 0x80)) return (int64_t)out;
    }
    return -1;
}

// Decompress one SNAPPY block into dst (cap bytes); the bytes written,
// or -1 when the block is malformed or does not fit.
int64_t pq_snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap) {
    int64_t i = 0;
    uint64_t want = 0;
    for (int shift = 0;; shift += 7) {
        if (i >= n || shift >= 35) return -1;
        uint8_t b = src[i++];
        want |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
    }
    if ((int64_t)want > cap) return -1;
    int64_t o = 0;
    while (i < n) {
        uint8_t tag = src[i++];
        int64_t len, off;
        switch (tag & 3) {
        case 0: {                                   // literal
            len = (tag >> 2) + 1;
            if (len > 60) {
                int nb = (int)len - 60;              // 1..4 length bytes
                if (i + nb > n) return -1;
                len = 0;
                for (int k = 0; k < nb; ++k) len |= (int64_t)src[i + k] << (8 * k);
                len += 1;
                i += nb;
            }
            if (i + len > n || o + len > (int64_t)want) return -1;
            std::memcpy(dst + o, src + i, (size_t)len);
            i += len;
            o += len;
            continue;
        }
        case 1:                                     // copy, 1-byte offset
            if (i + 1 > n) return -1;
            len = 4 + ((tag >> 2) & 7);
            off = ((int64_t)(tag >> 5) << 8) | src[i];
            i += 1;
            break;
        case 2:                                     // copy, 2-byte offset
            if (i + 2 > n) return -1;
            len = 1 + (tag >> 2);
            off = (int64_t)src[i] | ((int64_t)src[i + 1] << 8);
            i += 2;
            break;
        default:                                    // copy, 4-byte offset
            if (i + 4 > n) return -1;
            len = 1 + (tag >> 2);
            off = (int64_t)src[i] | ((int64_t)src[i + 1] << 8) |
                  ((int64_t)src[i + 2] << 16) | ((int64_t)src[i + 3] << 24);
            i += 4;
        }
        if (off <= 0 || off > o || o + len > (int64_t)want) return -1;
        if (off >= len) {
            std::memcpy(dst + o, dst + o - off, (size_t)len);
        } else {                                    // overlapping: a run
            for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[o - off + k];
        }
        o += len;
    }
    return o == (int64_t)want ? o : -1;
}

// Decode `count` values of the RLE/bit-packed hybrid of bit width bw
// (0..32) from src (n bytes) into out; the bytes consumed, or -1.
int64_t pq_rle_decode(const uint8_t* src, int64_t n, int32_t bw,
                      int64_t count, int32_t* out) {
    if (bw < 0 || bw > 32) return -1;
    const int vbytes = (bw + 7) / 8;
    const uint64_t mask = bw == 32 ? 0xFFFFFFFFull : ((1ull << bw) - 1);
    int64_t i = 0, got = 0;
    while (got < count) {
        uint64_t h = 0;
        for (int shift = 0;; shift += 7) {
            if (i >= n || shift >= 35) return -1;
            uint8_t b = src[i++];
            h |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
        }
        if (h & 1) {                                // bit-packed groups
            int64_t groups = (int64_t)(h >> 1);
            int64_t bytes = groups * bw;
            if (i + bytes > n) return -1;
            int64_t vals = groups * 8;
            int64_t take = vals < count - got ? vals : count - got;
            const uint8_t* p = src + i;
            for (int64_t k = 0; k < take; ++k) {
                int64_t bit = k * bw;
                int64_t byte = bit >> 3;
                int sh = (int)(bit & 7);
                uint64_t w = 0;
                int need = (sh + bw + 7) / 8;
                for (int q = 0; q < need && byte + q < bytes; ++q)
                    w |= (uint64_t)p[byte + q] << (8 * q);
                out[got + k] = (int32_t)((w >> sh) & mask);
            }
            got += take;
            i += bytes;
        } else {                                    // a repeated value
            int64_t run = (int64_t)(h >> 1);
            if (i + vbytes > n) return -1;
            uint32_t v = 0;
            for (int q = 0; q < vbytes; ++q) v |= (uint32_t)src[i + q] << (8 * q);
            i += vbytes;
            int64_t take = run < count - got ? run : count - got;
            for (int64_t k = 0; k < take; ++k) out[got + k] = (int32_t)v;
            got += take;
        }
    }
    return i;
}

// Split `count` PLAIN BYTE_ARRAY values: each value's start in src and
// its length; the bytes consumed, or -1. *max_len gets the longest.
int64_t pq_byte_array_split(const uint8_t* src, int64_t n, int64_t count,
                            int64_t* starts, int32_t* lens,
                            int32_t* max_len) {
    int64_t i = 0;
    int32_t longest = 0;
    for (int64_t k = 0; k < count; ++k) {
        if (i + 4 > n) return -1;
        uint32_t len;
        std::memcpy(&len, src + i, 4);
        i += 4;
        if (len > (uint32_t)(n - i)) return -1;
        starts[k] = i;
        lens[k] = (int32_t)len;
        if ((int32_t)len > longest) longest = (int32_t)len;
        i += len;
    }
    *max_len = longest;
    return i;
}

// Copy split values into rows of `width` bytes, zero past each value.
void pq_fill_fixed(const uint8_t* src, const int64_t* starts,
                   const int32_t* lens, int64_t count, int64_t width,
                   uint8_t* out) {
    for (int64_t k = 0; k < count; ++k) {
        uint8_t* row = out + k * width;
        int64_t len = lens[k] < width ? lens[k] : width;
        std::memcpy(row, src + starts[k], (size_t)len);
        std::memset(row + len, 0, (size_t)(width - len));
    }
}

// out[k] = dict[idx[k]] for elements of `elem` bytes; 0, or -1 when an
// index is outside the dictionary.
int64_t pq_gather(const uint8_t* dict, int64_t dict_len, int64_t elem,
                  const int32_t* idx, int64_t count, uint8_t* out) {
    for (int64_t k = 0; k < count; ++k) {
        int32_t j = idx[k];
        if (j < 0 || j >= dict_len) return -1;
        std::memcpy(out + k * elem, dict + (int64_t)j * elem, (size_t)elem);
    }
    return 0;
}

// Scatter dense values (one per valid row, in order) into n rows of
// `elem` bytes, zero where valid[k] is 0; the dense values used.
int64_t pq_scatter(const uint8_t* dense, int64_t elem, const uint8_t* valid,
                   int64_t n, uint8_t* out) {
    int64_t j = 0;
    for (int64_t k = 0; k < n; ++k) {
        if (valid[k]) {
            std::memcpy(out + k * elem, dense + j * elem, (size_t)elem);
            ++j;
        } else {
            std::memset(out + k * elem, 0, (size_t)elem);
        }
    }
    return j;
}

}  // extern "C"

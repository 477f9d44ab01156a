// Native Avro block encoder for the scale-dataset generator.
//
// The Python codec (mlease_tpu_torch/io/avro.py) encodes ~18K rows/s/core through
// per-row dict traversal — the throughput ceiling of staging the
// BASELINE-scale (100M-row) synthetic corpus. This encoder takes the
// generator's already-vectorized numpy chunks (column ids, values, labels)
// and emits the Avro BINARY BLOCK payload for the reference-schema row
//   {response: int, features: [{name, term, value}], weight: float,
//    offset: float}
// (RegressionPrepareOutput input contract, RegressionPrepare.java:73-192);
// Python keeps ownership of the container framing (header, block headers,
// sync markers), so files remain bit-compatible with the in-repo codec and
// round-trip through both the Python and native decoders.
//
// C ABI (ctypes): mlease_encode_ctr_block fills a caller-provided buffer.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// zig-zag varint (Avro long/int encoding)
inline size_t put_long(uint8_t* p, int64_t v) {
    uint64_t u = (static_cast<uint64_t>(v) << 1) ^ (v >> 63);
    size_t n = 0;
    while (u >= 0x80) {
        p[n++] = static_cast<uint8_t>(u) | 0x80;
        u >>= 7;
    }
    p[n++] = static_cast<uint8_t>(u);
    return n;
}

inline size_t put_float(uint8_t* p, float f) {
    std::memcpy(p, &f, 4);
    return 4;
}

// "f%d" feature-name rendering without snprintf overhead
inline size_t put_fname(uint8_t* p, int32_t id) {
    char tmp[16];
    int len = 1;
    tmp[0] = 'f';
    if (id == 0) {
        tmp[len++] = '0';
    } else {
        char digits[12];
        int nd = 0;
        uint32_t u = static_cast<uint32_t>(id);
        while (u) {
            digits[nd++] = static_cast<char>('0' + u % 10);
            u /= 10;
        }
        while (nd) tmp[len++] = digits[--nd];
    }
    size_t n = put_long(p, len);           // string = length + utf8 bytes
    std::memcpy(p + n, tmp, len);
    return n + len;
}

}  // namespace

extern "C" {

// Encode m rows into out (caller-allocated, cap bytes). Returns the number
// of payload bytes written, or -1 if the buffer would overflow (caller
// grows and retries). Layout per row (writer schema field order):
//   response:int  features:array<{name:string,term:string,value:float}>
//   weight:float  offset:float
// cols: (m, k) int32 feature ids; vals: (m, k) float32; y: (m,) int32;
// weight/offset: (m,) float32 (pass nullptr for all-1.0 / all-0.0).
int64_t mlease_encode_ctr_block(const int32_t* cols, const float* vals,
                                const int32_t* y, const float* weight,
                                const float* offset, int64_t m, int64_t k,
                                uint8_t* out, int64_t cap) {
    uint8_t* p = out;
    uint8_t* end = out + cap;
    // worst case per row: 5 (response) + 5 (array count) + k*(2+8+2+5)
    // + 1 (array end) + 4 + 4; feature names ≤ 9 bytes total each
    const int64_t worst_row = 5 + 5 + k * (10 + 9 + 5) + 1 + 8;
    for (int64_t i = 0; i < m; ++i) {
        if (end - p < worst_row) return -1;
        p += put_long(p, y[i]);                     // response
        p += put_long(p, k);                        // features: one block
        const int32_t* ci = cols + i * k;
        const float* vi = vals + i * k;
        for (int64_t j = 0; j < k; ++j) {
            p += put_fname(p, ci[j]);               // name
            *p++ = 0;                               // term: empty string
            p += put_float(p, vi[j]);               // value
        }
        *p++ = 0;                                   // features: end of array
        p += put_float(p, weight ? weight[i] : 1.0f);
        p += put_float(p, offset ? offset[i] : 0.0f);
    }
    return p - out;
}

}  // extern "C"

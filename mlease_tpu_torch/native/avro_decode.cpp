// Fast Avro training-row decoder + feature-vocabulary interner.
//
// Native counterpart of the reference's ingest hot loop: the reference spends
// its mapper/reducer time decoding Avro records and hashing feature strings
// into per-block indices (reference: LibLinearDataset.addInstanceAvro,
// src/main/java/com/linkedin/mlease/regression/liblinearfunc/LibLinearDataset.java:413-484,
// and the Avro container streaming in
// src/main/java/com/linkedin/mapred/AvroUtils.java:238-249). The pure-Python
// codec in mlease_tpu_torch/io/avro.py is the reference implementation; this
// library is the production path: it walks Avro container blocks (null +
// deflate codecs), decodes records against a compact schema descriptor
// compiled by Python, interns feature strings "name\x01term" into a global
// vocabulary with an open-addressing hash table, and emits flat columnar
// buffers (response/weight/offset + CSR-style feature id/value streams) ready
// to be packed into the device ELL layout.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Descriptor grammar (compiled from the parsed Avro schema in
// mlease_tpu_torch/io/fast_decode.py):
//   type  := 'n'|'b'|'i'|'l'|'f'|'d'|'s'|'y'
//          | 'x' <len> ';'            fixed
//          | 'e' ';'                  enum (int index)
//          | 'U' <k> ';' type*        union of k branches
//          | 'R' <k> ';' field*       record of k fields
//          | 'A' type                 array
//          | 'M' type                 map
//   field := role ':' type
//   role  := '_' skip | 'r' response | 'w' weight | 'o' offset
//          | 'F' features array | 'N' name | 'T' term | 'V' value
//          | 'K' partition/item key (captured as string)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct Input {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    bool need(size_t n) {
        if (static_cast<size_t>(end - p) < n) { ok = false; return false; }
        return true;
    }
    int64_t read_long() {
        uint64_t n = 0;
        int shift = 0;
        while (p < end) {
            uint8_t b = *p++;
            n |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (!(b & 0x80)) return static_cast<int64_t>((n >> 1) ^ -(n & 1));
            shift += 7;
            if (shift > 63) break;
        }
        ok = false;
        return 0;
    }
    float read_float() {
        if (!need(4)) return 0.f;
        float v; memcpy(&v, p, 4); p += 4; return v;
    }
    double read_double() {
        if (!need(8)) return 0.0;
        double v; memcpy(&v, p, 8); p += 8; return v;
    }
    bool read_bool() {
        if (!need(1)) return false;
        return *p++ != 0;
    }
    // returns pointer+len without copying
    const char* read_bytes(int64_t* len) {
        int64_t n = read_long();
        if (n < 0 || !need(static_cast<size_t>(n))) { ok = false; *len = 0; return nullptr; }
        const char* s = reinterpret_cast<const char*>(p);
        p += n;
        *len = n;
        return s;
    }
};

// ---------------------------------------------------------------------------
// descriptor
// ---------------------------------------------------------------------------

enum Role : uint8_t {
    ROLE_SKIP = 0, ROLE_RESPONSE, ROLE_WEIGHT, ROLE_OFFSET,
    ROLE_FEATURES, ROLE_NAME, ROLE_TERM, ROLE_VALUE, ROLE_KEY,
};

struct TypeNode {
    char kind;                   // n b i l f d s y x e U R A M
    int64_t fixed_len = 0;
    std::vector<TypeNode> children;      // union branches / array item / map value
    std::vector<uint8_t> roles;          // record field roles
};

struct DescParser {
    const char* p;
    bool ok = true;

    int64_t number() {
        int64_t v = 0;
        while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
        if (*p == ';') p++;
        else ok = false;
        return v;
    }
    TypeNode parse() {
        TypeNode t{};
        char c = *p++;
        t.kind = c;
        switch (c) {
            case 'n': case 'b': case 'i': case 'l': case 'f': case 'd':
            case 's': case 'y': case 'e':
                if (c == 'e') number();
                break;
            case 'x': t.fixed_len = number(); break;
            case 'U': {
                int64_t k = number();
                for (int64_t i = 0; i < k && ok; i++) t.children.push_back(parse());
                break;
            }
            case 'R': {
                int64_t k = number();
                for (int64_t i = 0; i < k && ok; i++) {
                    char role = *p++;
                    uint8_t r = ROLE_SKIP;
                    switch (role) {
                        case 'r': r = ROLE_RESPONSE; break;
                        case 'w': r = ROLE_WEIGHT; break;
                        case 'o': r = ROLE_OFFSET; break;
                        case 'F': r = ROLE_FEATURES; break;
                        case 'N': r = ROLE_NAME; break;
                        case 'T': r = ROLE_TERM; break;
                        case 'V': r = ROLE_VALUE; break;
                        case 'K': r = ROLE_KEY; break;
                        case '_': r = ROLE_SKIP; break;
                        default: ok = false;
                    }
                    if (*p++ != ':') { ok = false; break; }
                    t.roles.push_back(r);
                    t.children.push_back(parse());
                }
                break;
            }
            case 'A': case 'M':
                t.children.push_back(parse());
                break;
            default:
                ok = false;
        }
        return t;
    }
};

// ---------------------------------------------------------------------------
// vocabulary: open-addressing hash of interned "name\x01term" strings
// ---------------------------------------------------------------------------

struct Vocab {
    std::vector<char> arena;            // all key bytes back to back
    std::vector<uint64_t> key_off;      // offset into arena per id
    std::vector<uint32_t> key_len;
    std::vector<int32_t> table;         // open addressing, -1 empty
    uint64_t mask = 0;

    Vocab() {
        table.assign(1 << 16, -1);
        mask = table.size() - 1;
        arena.reserve(1 << 20);
    }
    static uint64_t hash(const char* s, size_t n) {
        uint64_t h = 1469598103934665603ull;          // FNV-1a
        for (size_t i = 0; i < n; i++) { h ^= (uint8_t)s[i]; h *= 1099511628211ull; }
        return h;
    }
    void grow() {
        std::vector<int32_t> nt(table.size() * 2, -1);
        uint64_t nm = nt.size() - 1;
        for (int32_t id = 0; id < (int32_t)key_off.size(); id++) {
            uint64_t h = hash(arena.data() + key_off[id], key_len[id]) & nm;
            while (nt[h] != -1) h = (h + 1) & nm;
            nt[h] = id;
        }
        table.swap(nt);
        mask = nm;
    }
    int32_t intern(const char* s, size_t n) {
        if (key_off.size() * 4 >= table.size() * 3) grow();
        uint64_t h = hash(s, n) & mask;
        while (true) {
            int32_t id = table[h];
            if (id == -1) {
                int32_t nid = (int32_t)key_off.size();
                key_off.push_back(arena.size());
                key_len.push_back((uint32_t)n);
                arena.insert(arena.end(), s, s + n);
                table[h] = nid;
                return nid;
            }
            if (key_len[id] == n &&
                memcmp(arena.data() + key_off[id], s, n) == 0)
                return id;
            h = (h + 1) & mask;
        }
    }
};

// ---------------------------------------------------------------------------
// decode context
// ---------------------------------------------------------------------------

struct Context {
    TypeNode schema;
    bool ignore_value = false;
    bool build_vocab = true;

    Vocab vocab;
    // per-row outputs
    std::vector<int32_t> response;
    std::vector<float> weight;
    std::vector<float> offset;
    std::vector<int64_t> row_start;     // CSR offsets into feat arrays (n+1)
    std::vector<int32_t> feat_id;
    std::vector<float> feat_val;
    std::vector<int64_t> key_start;     // per-row partition-key offsets (n+1)
    std::vector<char> key_arena;
    std::string error;

    // scratch per record
    const char* cur_name = nullptr; int64_t cur_name_len = 0;
    const char* cur_term = nullptr; int64_t cur_term_len = 0;
    float cur_value = 1.0f;
    bool in_feature = false;
    std::string keybuf;
};

void decode_node(Context& ctx, Input& in, const TypeNode& t, uint8_t role);

void decode_record(Context& ctx, Input& in, const TypeNode& t) {
    for (size_t i = 0; i < t.children.size() && in.ok; i++)
        decode_node(ctx, in, t.children[i], t.roles[i]);
}

void capture_number(Context& ctx, uint8_t role, double v) {
    switch (role) {
        case ROLE_RESPONSE: ctx.response.back() = (int32_t)v; break;
        case ROLE_WEIGHT: ctx.weight.back() = (float)v; break;
        case ROLE_OFFSET: ctx.offset.back() = (float)v; break;
        case ROLE_VALUE: ctx.cur_value = (float)v; break;
        default: break;
    }
}

void finish_feature(Context& ctx) {
    ctx.keybuf.clear();
    ctx.keybuf.append(ctx.cur_name, (size_t)ctx.cur_name_len);
    if (ctx.cur_term_len > 0) {
        ctx.keybuf.push_back('\x01');
        ctx.keybuf.append(ctx.cur_term, (size_t)ctx.cur_term_len);
    }
    int32_t id = ctx.vocab.intern(ctx.keybuf.data(), ctx.keybuf.size());
    ctx.feat_id.push_back(id);
    ctx.feat_val.push_back(ctx.ignore_value ? 1.0f : ctx.cur_value);
}

void decode_node(Context& ctx, Input& in, const TypeNode& t, uint8_t role) {
    switch (t.kind) {
        case 'n': return;
        case 'b': {
            bool v = in.read_bool();
            capture_number(ctx, role, v ? 1.0 : 0.0);
            return;
        }
        case 'i': case 'l': case 'e': {
            int64_t v = in.read_long();
            capture_number(ctx, role, (double)v);
            return;
        }
        case 'f': {
            float v = in.read_float();
            capture_number(ctx, role, v);
            return;
        }
        case 'd': {
            double v = in.read_double();
            capture_number(ctx, role, v);
            return;
        }
        case 's': case 'y': {
            int64_t len = 0;
            const char* s = in.read_bytes(&len);
            if (role == ROLE_NAME) { ctx.cur_name = s; ctx.cur_name_len = len; }
            else if (role == ROLE_TERM) { ctx.cur_term = s; ctx.cur_term_len = len; }
            else if (role == ROLE_KEY) {
                ctx.key_arena.insert(ctx.key_arena.end(), s, s + len);
            }
            return;
        }
        case 'x': {
            if (in.need((size_t)t.fixed_len)) in.p += t.fixed_len;
            return;
        }
        case 'U': {
            int64_t idx = in.read_long();
            if (idx < 0 || (size_t)idx >= t.children.size()) { in.ok = false; return; }
            decode_node(ctx, in, t.children[(size_t)idx], role);
            return;
        }
        case 'R': {
            bool feature_rec = (role == ROLE_SKIP && ctx.in_feature);
            if (feature_rec) {
                ctx.cur_name = nullptr; ctx.cur_name_len = 0;
                ctx.cur_term = nullptr; ctx.cur_term_len = 0;
                ctx.cur_value = 1.0f;
            }
            decode_record(ctx, in, t);
            if (feature_rec && ctx.cur_name != nullptr) finish_feature(ctx);
            return;
        }
        case 'A': {
            bool features = (role == ROLE_FEATURES);
            bool prev = ctx.in_feature;
            if (features) ctx.in_feature = true;
            while (in.ok) {
                int64_t cnt = in.read_long();
                if (cnt == 0) break;
                if (cnt < 0) { in.read_long(); cnt = -cnt; }
                for (int64_t i = 0; i < cnt && in.ok; i++)
                    decode_node(ctx, in, t.children[0], ROLE_SKIP);
            }
            ctx.in_feature = prev;
            return;
        }
        case 'M': {
            while (in.ok) {
                int64_t cnt = in.read_long();
                if (cnt == 0) break;
                if (cnt < 0) { in.read_long(); cnt = -cnt; }
                for (int64_t i = 0; i < cnt && in.ok; i++) {
                    int64_t len; in.read_bytes(&len);
                    decode_node(ctx, in, t.children[0], ROLE_SKIP);
                }
            }
            return;
        }
        default:
            in.ok = false;
    }
}

bool decode_rows(Context& ctx, const uint8_t* data, size_t size, int64_t count) {
    Input in{data, data + size};
    for (int64_t i = 0; i < count; i++) {
        ctx.response.push_back(0);
        ctx.weight.push_back(1.0f);
        ctx.offset.push_back(0.0f);
        decode_node(ctx, in, ctx.schema, ROLE_SKIP);
        ctx.row_start.push_back((int64_t)ctx.feat_id.size());
        ctx.key_start.push_back((int64_t)ctx.key_arena.size());
        if (!in.ok) {
            ctx.error = "malformed Avro record payload";
            return false;
        }
    }
    return true;
}

bool inflate_payload(const uint8_t* data, size_t size,
                     std::vector<uint8_t>& out, size_t* written,
                     std::string& error) {
    out.resize(size * 4 + 4096);
    z_stream zs{};
    if (inflateInit2(&zs, -15) != Z_OK) { error = "inflateInit2 failed"; return false; }
    zs.next_in = const_cast<uint8_t*>(data);
    zs.avail_in = (uInt)size;
    size_t w = 0;
    while (true) {
        if (w == out.size()) out.resize(out.size() * 2);
        zs.next_out = out.data() + w;
        zs.avail_out = (uInt)(out.size() - w);
        int ret = inflate(&zs, Z_NO_FLUSH);
        w = out.size() - zs.avail_out;
        if (ret == Z_STREAM_END) break;
        if (ret != Z_OK) { inflateEnd(&zs); error = "inflate error"; return false; }
    }
    inflateEnd(&zs);
    *written = w;
    return true;
}

bool decode_one_block(Context& ctx, const uint8_t* data, size_t size,
                      int64_t count, bool deflated) {
    if (!deflated) return decode_rows(ctx, data, size, count);
    std::vector<uint8_t> out;
    size_t written = 0;
    if (!inflate_payload(data, size, out, &written, ctx.error)) return false;
    return decode_rows(ctx, out.data(), written, count);
}

// Merge `src` (decoded from a later contiguous range of blocks) into `dst`.
// Interning src's local vocab into dst in local-id order preserves the exact
// global first-occurrence id assignment of a sequential decode: every key
// first seen in dst's block range already has its (earlier) id, and keys new
// to src's range arrive in their in-range first-occurrence order.
void merge_context(Context& dst, const Context& src) {
    std::vector<int32_t> id_map(src.vocab.key_off.size());
    for (size_t i = 0; i < src.vocab.key_off.size(); i++)
        id_map[i] = dst.vocab.intern(src.vocab.arena.data() + src.vocab.key_off[i],
                                     src.vocab.key_len[i]);
    dst.response.insert(dst.response.end(), src.response.begin(), src.response.end());
    dst.weight.insert(dst.weight.end(), src.weight.begin(), src.weight.end());
    dst.offset.insert(dst.offset.end(), src.offset.begin(), src.offset.end());
    int64_t feat_base = (int64_t)dst.feat_id.size();
    dst.feat_id.reserve(dst.feat_id.size() + src.feat_id.size());
    for (int32_t id : src.feat_id) dst.feat_id.push_back(id_map[id]);
    dst.feat_val.insert(dst.feat_val.end(), src.feat_val.begin(), src.feat_val.end());
    for (size_t i = 1; i < src.row_start.size(); i++)
        dst.row_start.push_back(src.row_start[i] + feat_base);
    int64_t key_base = (int64_t)dst.key_arena.size();
    dst.key_arena.insert(dst.key_arena.end(), src.key_arena.begin(),
                         src.key_arena.end());
    for (size_t i = 1; i < src.key_start.size(); i++)
        dst.key_start.push_back(src.key_start[i] + key_base);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* mlease_ctx_new(const char* descriptor, int ignore_value) {
    DescParser dp{descriptor};
    TypeNode t = dp.parse();
    if (!dp.ok) return nullptr;
    Context* ctx = new Context();
    ctx->schema = std::move(t);
    ctx->ignore_value = ignore_value != 0;
    ctx->row_start.push_back(0);
    ctx->key_start.push_back(0);
    return ctx;
}

void mlease_ctx_free(void* p) {
    delete static_cast<Context*>(p);
}

// Feed one container-file block payload (already decompressed by the caller
// OR compressed with raw deflate when `deflated` is nonzero).
int mlease_decode_block(void* p, const uint8_t* data, int64_t size,
                        int64_t count, int deflated) {
    Context* ctx = static_cast<Context*>(p);
    return decode_one_block(*ctx, data, (size_t)size, count, deflated != 0)
        ? 0 : -1;
}

// Decode many container blocks of ONE file with `nthreads` worker threads.
// Each worker decodes a contiguous byte-balanced range of blocks into a
// private context (own vocabulary); the serial merge preserves byte-exact
// sequential semantics (row order and vocabulary first-occurrence id order).
// `datas[i]`/`sizes[i]`/`counts[i]` describe block i's payload.
int mlease_decode_blocks_mt(void* p, const uint8_t* const* datas,
                            const int64_t* sizes, const int64_t* counts,
                            int64_t nblocks, int deflated, int nthreads) {
    Context* ctx = static_cast<Context*>(p);
    if (nthreads > nblocks) nthreads = (int)nblocks;
    if (nthreads <= 1) {
        for (int64_t i = 0; i < nblocks; i++)
            if (!decode_one_block(*ctx, datas[i], (size_t)sizes[i], counts[i],
                                  deflated != 0))
                return -1;
        return 0;
    }
    // contiguous ranges balanced by payload bytes
    int64_t total = 0;
    for (int64_t i = 0; i < nblocks; i++) total += sizes[i];
    std::vector<int64_t> starts;
    starts.push_back(0);
    int64_t acc = 0;
    for (int64_t i = 0; i < nblocks && (int)starts.size() < nthreads; i++) {
        acc += sizes[i];
        if (acc >= total * (int64_t)starts.size() / nthreads)
            starts.push_back(i + 1);
    }
    starts.push_back(nblocks);
    int nshards = (int)starts.size() - 1;

    std::vector<Context> shards(nshards);
    std::vector<uint8_t> failed(nshards, 0);
    std::vector<std::thread> threads;
    for (int s = 0; s < nshards; s++) {
        shards[s].schema = ctx->schema;
        shards[s].ignore_value = ctx->ignore_value;
        shards[s].row_start.push_back(0);
        shards[s].key_start.push_back(0);
        threads.emplace_back([&, s]() {
            for (int64_t i = starts[s]; i < starts[s + 1]; i++)
                if (!decode_one_block(shards[s], datas[i], (size_t)sizes[i],
                                      counts[i], deflated != 0)) {
                    failed[s] = 1;
                    return;
                }
        });
    }
    for (auto& t : threads) t.join();
    for (int s = 0; s < nshards; s++) {
        if (failed[s]) { ctx->error = shards[s].error; return -1; }
        merge_context(*ctx, shards[s]);
    }
    return 0;
}

int64_t mlease_num_rows(void* p) {
    return (int64_t)static_cast<Context*>(p)->response.size();
}
int64_t mlease_num_feats(void* p) {
    return (int64_t)static_cast<Context*>(p)->feat_id.size();
}
int64_t mlease_vocab_size(void* p) {
    return (int64_t)static_cast<Context*>(p)->vocab.key_off.size();
}
int64_t mlease_vocab_arena_size(void* p) {
    return (int64_t)static_cast<Context*>(p)->vocab.arena.size();
}
int64_t mlease_key_arena_size(void* p) {
    return (int64_t)static_cast<Context*>(p)->key_arena.size();
}
const char* mlease_error(void* p) {
    return static_cast<Context*>(p)->error.c_str();
}

// Bulk copy-outs (caller allocates numpy buffers of the right size).
void mlease_copy_rows(void* p, int32_t* response, float* weight, float* offset,
                      int64_t* row_start) {
    Context* ctx = static_cast<Context*>(p);
    memcpy(response, ctx->response.data(), ctx->response.size() * 4);
    memcpy(weight, ctx->weight.data(), ctx->weight.size() * 4);
    memcpy(offset, ctx->offset.data(), ctx->offset.size() * 4);
    memcpy(row_start, ctx->row_start.data(), ctx->row_start.size() * 8);
}
void mlease_copy_feats(void* p, int32_t* ids, float* vals) {
    Context* ctx = static_cast<Context*>(p);
    memcpy(ids, ctx->feat_id.data(), ctx->feat_id.size() * 4);
    memcpy(vals, ctx->feat_val.data(), ctx->feat_val.size() * 4);
}
void mlease_copy_vocab(void* p, char* arena, int64_t* offsets, int32_t* lens) {
    Context* ctx = static_cast<Context*>(p);
    memcpy(arena, ctx->vocab.arena.data(), ctx->vocab.arena.size());
    memcpy(offsets, ctx->vocab.key_off.data(), ctx->vocab.key_off.size() * 8);
    memcpy(lens, ctx->vocab.key_len.data(), ctx->vocab.key_len.size() * 4);
}
void mlease_copy_keys(void* p, char* arena, int64_t* starts) {
    Context* ctx = static_cast<Context*>(p);
    memcpy(arena, ctx->key_arena.data(), ctx->key_arena.size());
    memcpy(starts, ctx->key_start.data(), ctx->key_start.size() * 8);
}

}  // extern "C"

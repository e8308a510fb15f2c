// Native parquet column-chunk scanner: the host side of the parquet scan.
//
// The port's own copy of spark_rapids_tpu/native/parquet_host.cpp. The card
// unpacks the bulk bit-packed indices (csrc/chunkdecode.cu); this translation
// unit owns the byte-level host work around it: thrift compact-protocol page
// headers, definition-level RLE decode, RLE/bit-packed hybrid run
// segmentation, the hybrid decode of pages that hold RLE runs, and the index
// words of a packed chunk. Each entry point is one C call per column chunk, so
// no Python runs per page header, per run or per value, and ctypes releases
// the GIL for the call.
//
// Entry points (io/parquet_native.py calls them through native/__init__.py):
//   sr_scan_chunk    one UNCOMPRESSED chunk of v1 data pages (the reference's)
//   sr_page_headers  the page headers of any chunk (the compressed route)
//   sr_scan_pages    v1 and v2 data pages whose bodies the host decompressed
//   sr_decode_hybrid the int32 values of one hybrid stream
//   sr_pack_table    the page table of a packed chunk (PAGE_FIELDS rows)
//   sr_pack_words    the index words of a packed chunk, into the caller's
//                    buffer
//
// Layout contract with native/__init__.py (ctypes): every struct field is
// int64_t, arrays are caller-allocated.

#include <cstdint>
#include <cstring>

namespace {

struct Reader {
    const uint8_t* buf;
    int64_t len;
    int64_t pos;
    bool fail = false;

    uint8_t byte() {
        if (pos >= len) { fail = true; return 0; }
        return buf[pos++];
    }
    uint64_t varint() {
        uint64_t out = 0;
        int shift = 0;
        while (true) {
            uint8_t b = byte();
            if (fail || shift > 63) { fail = true; return 0; }
            out |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (!(b & 0x80)) return out;
            shift += 7;
        }
    }
    int64_t zigzag() {
        uint64_t v = varint();
        return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
    }
    void skip(int64_t n) {
        if (n < 0 || pos + n > len) { fail = true; return; }
        pos += n;
    }
    void skip_binary() { skip(static_cast<int64_t>(varint())); }
};

// Minimal thrift compact struct walk keeping only the page-header fields we
// need (same field ids as io/parquet_native.py parse_page_header).
struct PageHeaderFields {
    int64_t page_type = -1;         // field 1
    int64_t uncompressed_size = 0;  // field 2
    int64_t compressed_size = 0;    // field 3
    int64_t num_values = 0;         // nested field 1
    int64_t encoding = 0;           // nested field 2 (v1/dict) or 4 (v2)
    // DataPageHeaderV2 only: level-section byte lengths (levels are never
    // compressed) and whether the values section is compressed
    int64_t def_len = 0;            // nested field 5
    int64_t rep_len = 0;            // nested field 6
    int64_t v2_compressed = 1;      // nested field 7
};

void walk_struct(Reader& r, int depth, int64_t parent_field,
                 PageHeaderFields& out) {
    int64_t fid = 0;
    while (!r.fail) {
        uint8_t head = r.byte();
        if (r.fail || head == 0) return;
        int64_t delta = head >> 4;
        int ftype = head & 0x0F;
        fid = delta ? fid + delta : r.zigzag();
        int64_t val = 0;
        switch (ftype) {
            case 1: val = 1; break;            // BOOLEAN_TRUE
            case 2: val = 0; break;            // BOOLEAN_FALSE
            case 3: val = r.byte(); break;     // byte
            case 4: case 5: case 6:            // i16/i32/i64
                val = r.zigzag(); break;
            case 7: r.skip(8); break;          // double
            case 8: r.skip_binary(); break;    // binary/string
            case 12:                            // struct
                walk_struct(r, depth + 1, fid, out);
                break;
            case 9: case 10: {                  // list/set
                uint8_t sz = r.byte();
                int64_t n = sz >> 4;
                int et = sz & 0x0F;
                if (n == 15) n = static_cast<int64_t>(r.varint());
                for (int64_t i = 0; i < n && !r.fail; i++) {
                    if (et == 4 || et == 5 || et == 6) r.zigzag();
                    else if (et == 8) r.skip_binary();
                    else if (et == 12) walk_struct(r, depth + 1, -1, out);
                    else if (et == 3) r.byte();
                    else if (et == 7) r.skip(8);
                    else { r.fail = true; }
                }
                break;
            }
            default:
                r.fail = true;
                return;
        }
        if (depth == 0) {
            if (fid == 1) out.page_type = val;
            else if (fid == 2) out.uncompressed_size = val;
            else if (fid == 3) out.compressed_size = val;
        } else if (depth == 1 &&
                   (parent_field == 5 || parent_field == 7 ||
                    parent_field == 8)) {
            // DataPageHeader(5) / DictionaryPageHeader(7) / DataPageHeaderV2(8)
            if (fid == 1) out.num_values = val;
            if ((parent_field == 8 && fid == 4) ||
                (parent_field != 8 && fid == 2))
                out.encoding = val;
            if (parent_field == 8) {
                if (fid == 5) out.def_len = val;
                else if (fid == 6) out.rep_len = val;
                else if (fid == 7) out.v2_compressed = val;
            }
        }
    }
}

}  // namespace

extern "C" {

struct SrSeg {
    int64_t kind;       // 0 = rle, 1 = packed
    int64_t count;
    int64_t value;
    int64_t byte_off;   // page-body-relative
    int64_t byte_len;
};

struct SrPage {
    int64_t num_values;
    int64_t def_off;     // start of this page's levels in def_levels out
    int64_t n_present;
    int64_t bit_width;
    int64_t body_off;    // page body offset in buf
    int64_t body_len;
    int64_t values_off;  // page-relative offset of the bit-width byte
    int64_t seg_off;
    int64_t seg_count;
};

// error codes (mirror the Python parser's NotImplementedError scope)
enum {
    SR_ERR_MALFORMED = -1,
    SR_ERR_PAGE_TYPE = -2,
    SR_ERR_ENCODING = -3,
    SR_ERR_CAPACITY = -4,      // pages/segs arrays too small: caller may grow
    SR_ERR_NO_DICT = -5,
    SR_ERR_DEF_CAPACITY = -6,  // def levels exceed footer num_values: corrupt
    SR_ERR_NESTED = -7,        // a v2 page with repetition levels
};

// Decode an RLE/bit-packed hybrid region. When `levels_out` is non-null the
// values are materialized (definition levels); otherwise only the run
// STRUCTURE is recorded into segs (bit-packed payload goes to the device).
static int64_t scan_hybrid(const uint8_t* page, int64_t page_len, int64_t pos,
                           int64_t end, int64_t bit_width, int64_t total,
                           SrSeg* segs, int64_t segs_cap, int64_t* n_segs,
                           int32_t* levels_out) {
    Reader r{page, end < page_len ? end : page_len, pos};
    int64_t got = 0;
    int64_t vbytes = (bit_width + 7) / 8;
    while (got < total && r.pos < r.len && !r.fail) {
        uint64_t h = r.varint();
        if (r.fail) return SR_ERR_MALFORMED;
        SrSeg s{};
        if (h & 1) {
            int64_t groups = static_cast<int64_t>(h >> 1);
            int64_t n = groups * 8;
            s.kind = 1;
            s.count = n < total - got ? n : total - got;
            s.byte_off = r.pos;
            s.byte_len = groups * bit_width;
            if (levels_out) {
                // unpack little-endian bit order
                for (int64_t i = 0; i < s.count; i++) {
                    int64_t bit0 = i * bit_width;
                    int64_t v = 0;
                    for (int64_t b = 0; b < bit_width; b++) {
                        int64_t bit = bit0 + b;
                        int64_t byi = r.pos + (bit >> 3);
                        if (byi >= r.len) return SR_ERR_MALFORMED;
                        v |= ((page[byi] >> (bit & 7)) & 1) << b;
                    }
                    levels_out[got + i] = static_cast<int32_t>(v);
                }
            }
            r.skip(s.byte_len);
            if (r.fail) return SR_ERR_MALFORMED;
        } else {
            int64_t run = static_cast<int64_t>(h >> 1);
            int64_t v = 0;
            for (int64_t i = 0; i < vbytes; i++)
                v |= static_cast<int64_t>(r.byte()) << (8 * i);
            if (r.fail) return SR_ERR_MALFORMED;
            s.kind = 0;
            s.count = run < total - got ? run : total - got;
            s.value = v;
            if (levels_out)
                for (int64_t i = 0; i < s.count; i++)
                    levels_out[got + i] = static_cast<int32_t>(v);
        }
        if (segs) {
            if (*n_segs >= segs_cap) return SR_ERR_CAPACITY;
            segs[(*n_segs)++] = s;
        }
        got += s.count;
    }
    return got;
}

// The def levels, bit width and run segmentation of one dictionary-encoded
// data page whose values section (the bit-width byte, then the hybrid runs)
// lies in page[p0, page_len). `levels` is the def-level hybrid stream:
// for a v1 page the caller passes levels == nullptr and the stream rides at
// page[0] behind its 4-byte length; for a v2 page it is its own uncompressed
// section without a length prefix. Fills out.def_off.. onwards.
static int64_t scan_data_page(const uint8_t* page, int64_t page_len,
                              const uint8_t* levels, int64_t levels_len,
                              bool v2, int64_t num_values, int32_t max_def,
                              SrSeg* segs, int64_t segs_cap, int64_t* n_segs,
                              int32_t* def_levels, int64_t def_used,
                              int64_t def_cap, SrPage& out) {
    int64_t p = 0;
    out.num_values = num_values;
    out.def_off = def_used;
    // def_cap is exactly the footer's num_values: overflow means a corrupt
    // chunk, not an undersized caller array — growing the other buffers can
    // never fix it
    if (num_values < 0 || def_used + num_values > def_cap)
        return SR_ERR_DEF_CAPACITY;
    int32_t* dl = def_levels + def_used;
    if (max_def && !v2) {
        if (p + 4 > page_len) return SR_ERR_MALFORMED;
        int64_t dl_len = 0;
        std::memcpy(&dl_len, page + p, 4);
        p += 4;
        int64_t got = scan_hybrid(page, page_len, p, p + dl_len, 1,
                                  num_values, nullptr, 0, n_segs, dl);
        if (got < 0) return got;
        for (int64_t i = got; i < num_values; i++) dl[i] = 0;
        p += dl_len;
    } else if (max_def && levels_len) {
        int64_t got = scan_hybrid(levels, levels_len, 0, levels_len, 1,
                                  num_values, nullptr, 0, n_segs, dl);
        if (got < 0) return got;
        for (int64_t i = got; i < num_values; i++) dl[i] = 0;
    } else {
        for (int64_t i = 0; i < num_values; i++) dl[i] = 1;
    }
    int64_t n_present = 0;
    for (int64_t i = 0; i < num_values; i++) n_present += dl[i];
    if (p >= page_len) return SR_ERR_MALFORMED;
    out.bit_width = page[p];
    out.values_off = p;
    p += 1;
    out.n_present = n_present;
    out.seg_off = *n_segs;
    int64_t got = scan_hybrid(page, page_len, p, page_len, out.bit_width,
                              n_present, segs, segs_cap, n_segs, nullptr);
    if (got < 0) return got;
    out.seg_count = *n_segs - out.seg_off;
    return 0;
}

// Scan one UNCOMPRESSED dictionary-encoded column chunk buffer.
// Returns the page count (>= 0) or a negative SR_ERR_* code.
// dict_out = {body_off, body_len, num_values}.
int64_t sr_scan_chunk(const uint8_t* buf, int64_t buf_len,
                      int64_t col_num_values, int32_t max_def,
                      SrPage* pages, int64_t pages_cap,
                      SrSeg* segs, int64_t segs_cap,
                      int32_t* def_levels, int64_t def_cap,
                      int64_t* dict_out) {
    int64_t pos = 0, n_pages = 0, n_segs = 0;
    int64_t values_seen = 0, def_used = 0;
    dict_out[0] = dict_out[1] = dict_out[2] = -1;
    while (pos < buf_len && values_seen < col_num_values) {
        Reader r{buf, buf_len, pos};
        PageHeaderFields ph;
        walk_struct(r, 0, -1, ph);
        if (r.fail) return SR_ERR_MALFORMED;
        int64_t header_len = r.pos - pos;
        int64_t body = pos + header_len;
        if (ph.compressed_size < 0 || body + ph.compressed_size > buf_len)
            return SR_ERR_MALFORMED;
        if (ph.page_type == 2) {                      // dictionary page
            dict_out[0] = body;
            dict_out[1] = ph.compressed_size;
            dict_out[2] = ph.num_values;
        } else if (ph.page_type == 0) {               // data page v1
            if (ph.encoding != 8 && ph.encoding != 2)
                return SR_ERR_ENCODING;               // RLE_DICT / PLAIN_DICT
            if (n_pages >= pages_cap) return SR_ERR_CAPACITY;
            SrPage out{};
            out.body_off = body;
            out.body_len = ph.compressed_size;
            int64_t err = scan_data_page(
                buf + body, ph.compressed_size, nullptr, 0, false,
                ph.num_values, max_def, segs, segs_cap, &n_segs, def_levels,
                def_used, def_cap, out);
            if (err < 0) return err;
            def_used += ph.num_values;
            pages[n_pages++] = out;
            values_seen += ph.num_values;
        } else {
            return SR_ERR_PAGE_TYPE;                  // v2 etc: page route
        }
        pos = body + ph.compressed_size;
    }
    if (dict_out[0] < 0) return SR_ERR_NO_DICT;
    return n_pages;
}

// The page headers of one column chunk buffer of any codec, walked exactly
// as sr_scan_chunk walks them. Writes SR_HDR_FIELDS int64 a page into out:
// {page_type, body_off, compressed_size, uncompressed_size, num_values,
//  def_len, v2_compressed}. Returns the page count (dictionary page
// included) or a negative SR_ERR_* code: a data page that is not
// dictionary-encoded, a page type other than dictionary / v1 / v2, a v2 page
// with repetition levels, or no dictionary page at all.
enum { SR_HDR_FIELDS = 7 };

int64_t sr_page_headers(const uint8_t* buf, int64_t buf_len,
                        int64_t col_num_values, int64_t* out, int64_t cap) {
    int64_t pos = 0, n = 0, values_seen = 0;
    bool dict = false;
    while (pos < buf_len && values_seen < col_num_values) {
        Reader r{buf, buf_len, pos};
        PageHeaderFields ph;
        walk_struct(r, 0, -1, ph);
        if (r.fail) return SR_ERR_MALFORMED;
        int64_t body = r.pos;
        if (ph.compressed_size < 0 || ph.uncompressed_size < 0
                || body + ph.compressed_size > buf_len)
            return SR_ERR_MALFORMED;
        if (ph.page_type == 0 || ph.page_type == 3) {
            if (ph.encoding != 8 && ph.encoding != 2) return SR_ERR_ENCODING;
            if (ph.page_type == 3) {
                if (ph.rep_len) return SR_ERR_NESTED;
                if (ph.def_len < 0 || ph.def_len > ph.compressed_size
                        || ph.def_len > ph.uncompressed_size)
                    return SR_ERR_MALFORMED;
            }
            values_seen += ph.num_values;
        } else if (ph.page_type == 2) {
            dict = true;
        } else {
            return SR_ERR_PAGE_TYPE;
        }
        if (n >= cap) return SR_ERR_CAPACITY;
        int64_t* row = out + n * SR_HDR_FIELDS;
        row[0] = ph.page_type;
        row[1] = body;
        row[2] = ph.compressed_size;
        row[3] = ph.uncompressed_size;
        row[4] = ph.num_values;
        row[5] = ph.page_type == 3 ? ph.def_len : 0;
        row[6] = ph.page_type == 3 ? ph.v2_compressed : 1;
        n++;
        pos = body + ph.compressed_size;
    }
    if (!dict) return SR_ERR_NO_DICT;
    return n;
}

// Scan data pages whose bodies the host already holds uncompressed in one
// buffer. descs holds SR_DESC_FIELDS int64 a page: {version (1 or 2),
// num_values, data_off, data_len, levels_off, levels_len}. For a v1 page the
// data is the whole page (def levels behind their 4-byte length, then the
// values section); for a v2 page it is the values section, and the def
// levels are the uncompressed levels section at levels_off. Fills pages, segs
// and def_levels as sr_scan_chunk does, with body_off/body_len the data's.
// Returns the page count or a negative SR_ERR_* code.
enum { SR_DESC_FIELDS = 6 };

int64_t sr_scan_pages(const uint8_t* body, int64_t body_len,
                      const int64_t* descs, int64_t n_pages, int32_t max_def,
                      SrPage* pages, SrSeg* segs, int64_t segs_cap,
                      int32_t* def_levels, int64_t def_cap) {
    int64_t n_segs = 0, def_used = 0;
    for (int64_t i = 0; i < n_pages; i++) {
        const int64_t* d = descs + i * SR_DESC_FIELDS;
        int64_t version = d[0], nv = d[1], off = d[2], len = d[3];
        int64_t loff = d[4], llen = d[5];
        if (off < 0 || len < 0 || off + len > body_len || loff < 0
                || llen < 0 || loff + llen > body_len
                || (version != 1 && version != 2))
            return SR_ERR_MALFORMED;
        SrPage out{};
        out.body_off = off;
        out.body_len = len;
        int64_t err = scan_data_page(
            body + off, len, body + loff, llen, version == 2, nv, max_def,
            segs, segs_cap, &n_segs, def_levels, def_used, def_cap, out);
        if (err < 0) return err;
        def_used += nv;
        pages[i] = out;
    }
    return n_pages;
}

// The int32 values of the hybrid stream page[pos, page_len) at bit_width:
// `total` of them, zero past the stream's end. The reference's
// decode_rle_host. Returns the values decoded or a negative SR_ERR_* code.
int64_t sr_decode_hybrid(const uint8_t* page, int64_t page_len, int64_t pos,
                         int64_t bit_width, int64_t total, int32_t* out) {
    int64_t n_segs = 0;
    if (pos < 0 || bit_width < 0 || bit_width > 32) return SR_ERR_MALFORMED;
    int64_t got = scan_hybrid(page, page_len, pos, page_len, bit_width, total,
                              nullptr, 0, &n_segs, out);
    if (got < 0) return got;
    for (int64_t i = got; i < total; i++) out[i] = 0;
    return got;
}

// A page carries its bit-packed index bytes as they are when every run of
// it is bit-packed at a bit width above 0; otherwise its indices are decoded
// on the host and carried at bit width 32, which unpacks as the identity.
static bool carries_packed(const SrPage& p, const SrSeg* segs) {
    if (p.seg_count == 0 || p.bit_width == 0) return false;
    for (int64_t s = 0; s < p.seg_count; s++)
        if (segs[p.seg_off + s].kind != 1) return false;
    return true;
}

// The page table of a packed chunk: 8 int32 a page, in the order of
// ops/cuda_kernels.PAGE_FIELDS (row_off, row_count, word_off, n_words,
// bit_width, n_present, present_before, has_nulls). Returns the index words
// of all pages, or SR_ERR_MALFORMED when a count leaves int32.
int64_t sr_pack_table(const SrPage* pages, int64_t n_pages,
                      const SrSeg* segs, int32_t* table) {
    int64_t row_off = 0, word_off = 0, present_before = 0;
    for (int64_t i = 0; i < n_pages; i++) {
        const SrPage& p = pages[i];
        int64_t n_words, bw;
        if (p.bit_width > 32) return SR_ERR_MALFORMED;
        if (carries_packed(p, segs)) {
            int64_t bytes = 0;
            for (int64_t s = 0; s < p.seg_count; s++)
                bytes += segs[p.seg_off + s].byte_len;
            n_words = (bytes + 3) / 4;
            bw = p.bit_width;
        } else {
            n_words = p.seg_count ? p.n_present : 0;
            bw = 32;
        }
        int64_t row[8] = {row_off, p.num_values, word_off, n_words, bw,
                          p.n_present, present_before,
                          p.n_present != p.num_values};
        for (int k = 0; k < 8; k++) {
            if (row[k] < 0 || row[k] > INT32_MAX) return SR_ERR_MALFORMED;
            table[i * 8 + k] = static_cast<int32_t>(row[k]);
        }
        row_off += p.num_values;
        word_off += n_words;
        present_before += p.n_present;
    }
    return word_off;
}

// The index words of a packed chunk, written at words[table's word_off]:
// a packed page's run bytes back to back (whole 8-value groups at byte
// boundaries, so their concatenation keeps the bit alignment), zero-padded
// to a word; any other page's decoded indices, one int32 each. `table` is
// sr_pack_table's. Returns 0 or a negative SR_ERR_* code.
int64_t sr_pack_words(const uint8_t* body, int64_t body_len,
                      const SrPage* pages, int64_t n_pages, const SrSeg* segs,
                      const int32_t* table, int32_t* words) {
    for (int64_t i = 0; i < n_pages; i++) {
        const SrPage& p = pages[i];
        if (p.body_off < 0 || p.body_off + p.body_len > body_len)
            return SR_ERR_MALFORMED;
        const uint8_t* page = body + p.body_off;
        int32_t* w = words + table[i * 8 + 2];
        int64_t n_words = table[i * 8 + 3];
        if (n_words == 0) continue;
        if (carries_packed(p, segs)) {
            uint8_t* dst = reinterpret_cast<uint8_t*>(w);
            int64_t at = 0;
            for (int64_t s = 0; s < p.seg_count; s++) {
                const SrSeg& g = segs[p.seg_off + s];
                if (g.byte_off < 0 || g.byte_off + g.byte_len > p.body_len)
                    return SR_ERR_MALFORMED;
                std::memcpy(dst + at, page + g.byte_off, g.byte_len);
                at += g.byte_len;
            }
            std::memset(dst + at, 0, 4 * n_words - at);
        } else if (p.bit_width == 0) {   // one-entry dictionary: all index 0
            std::memset(w, 0, 4 * n_words);
        } else {
            int64_t got = sr_decode_hybrid(page, p.body_len, p.values_off + 1,
                                           p.bit_width, n_words, w);
            if (got < 0) return got;
        }
    }
    return 0;
}

}  // extern "C"

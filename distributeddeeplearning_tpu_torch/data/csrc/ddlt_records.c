/* Native TFRecord reader + Example feature extraction.
 *
 * The reference's data plane leans on TensorFlow's C++ runtime for record
 * IO (tf.data TFRecordDataset under scripts/convert_imagenet_to_tf_records.py
 * and TensorFlow_imagenet/src/data/tfrecords.py).  This is the framework's
 * own native equivalent: a small C library exposing, over a plain C ABI
 * (ctypes-friendly, no pybind11 dependency):
 *
 *   - CRC32C (Castagnoli, software table) and TFRecord's masked variant;
 *   - a streaming TFRecord reader with optional CRC verification
 *     (frame format: u64le length, u32le masked-crc(length), payload,
 *      u32le masked-crc(payload));
 *   - minimal protobuf wire-format walking to extract the two features the
 *     ImageNet schema needs -- image/encoded (bytes) and image/class/label
 *     (int64) -- without a protobuf runtime.
 *
 * Python bindings: distributeddeeplearning_tpu/data/_native.py (ctypes,
 * with pure-Python fallbacks when no C compiler exists).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* CRC32C (Castagnoli 0x1EDC6F41, reflected 0x82F63B78), slicing-by-1. */

static uint32_t crc32c_table[256];
static int crc32c_ready = 0;

static void crc32c_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        crc32c_table[i] = c;
    }
    crc32c_ready = 1;
}

uint32_t ddlt_crc32c(const uint8_t *data, uint64_t len) {
    if (!crc32c_ready) crc32c_init();
    uint32_t c = 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; i++)
        c = crc32c_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

/* TFRecord's masked CRC: rotate right 15 then add a constant. */
uint32_t ddlt_masked_crc32c(const uint8_t *data, uint64_t len) {
    uint32_t crc = ddlt_crc32c(data, len);
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

/* ------------------------------------------------------------------ */
/* TFRecord streaming reader.                                          */

typedef struct {
    FILE *f;
    uint8_t *buf;
    uint64_t cap;
} ddlt_reader;

ddlt_reader *ddlt_reader_open(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) return NULL;
    ddlt_reader *r = (ddlt_reader *)calloc(1, sizeof(ddlt_reader));
    if (!r) { fclose(f); return NULL; }
    r->f = f;
    return r;
}

void ddlt_reader_close(ddlt_reader *r) {
    if (!r) return;
    if (r->f) fclose(r->f);
    free(r->buf);
    free(r);
}

static uint32_t load_u32le(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static uint64_t load_u64le(const uint8_t *p) {
    return (uint64_t)load_u32le(p) | ((uint64_t)load_u32le(p + 4) << 32);
}

/* Returns 1 = record produced, 0 = clean EOF, -1 = corrupt/IO error.
 * *data stays valid until the next call or close. */
int ddlt_reader_next(ddlt_reader *r, const uint8_t **data, uint64_t *len,
                     int verify_crc) {
    uint8_t header[12];
    size_t got = fread(header, 1, 12, r->f);
    if (got == 0 && feof(r->f)) return 0;
    if (got != 12) return -1;
    uint64_t n = load_u64le(header);
    if (verify_crc &&
        load_u32le(header + 8) != ddlt_masked_crc32c(header, 8))
        return -1;
    /* 1 GiB guard: a corrupt length must not drive a giant malloc. */
    if (n > (1ull << 30)) return -1;
    if (n + 4 > r->cap) {
        uint64_t cap = n + 4;
        uint8_t *nb = (uint8_t *)realloc(r->buf, cap);
        if (!nb) return -1;
        r->buf = nb;
        r->cap = cap;
    }
    if (fread(r->buf, 1, n + 4, r->f) != n + 4) return -1;
    if (verify_crc &&
        load_u32le(r->buf + n) != ddlt_masked_crc32c(r->buf, n))
        return -1;
    *data = r->buf;
    *len = n;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Minimal protobuf wire walking for tf.train.Example.
 *
 * Example        { Features features = 1; }
 * Features       { map<string, Feature> feature = 1; }   (map entry:
 *                  key = field 1 string, value = field 2 Feature)
 * Feature oneof  { BytesList bytes_list = 1; FloatList float_list = 2;
 *                  Int64List int64_list = 3; }
 * BytesList      { repeated bytes value = 1; }
 * Int64List      { repeated int64 value = 1 [packed or not]; }
 */

static int read_varint(const uint8_t *p, uint64_t len, uint64_t *pos,
                       uint64_t *out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < len && shift < 64) {
        uint8_t b = p[(*pos)++];
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = v; return 1; }
        shift += 7;
    }
    return 0;
}

/* Skip a field of the given wire type; returns 1 on success.
 * Length checks use the subtraction form (v > len - *pos): a huge varint
 * must not wrap the addition and slip past the bound. *pos <= len always
 * holds, so the subtraction cannot underflow. */
static int skip_field(const uint8_t *p, uint64_t len, uint64_t *pos,
                      uint32_t wire) {
    uint64_t v;
    switch (wire) {
    case 0: return read_varint(p, len, pos, &v);
    case 1: if (8 > len - *pos) return 0; *pos += 8; return 1;
    case 2:
        if (!read_varint(p, len, pos, &v) || v > len - *pos) return 0;
        *pos += v;
        return 1;
    case 5: if (4 > len - *pos) return 0; *pos += 4; return 1;
    default: return 0;
    }
}

/* Find a length-delimited subfield by number; returns ptr/len of payload. */
static int find_len_field(const uint8_t *p, uint64_t len, uint32_t want_field,
                          const uint8_t **out, uint64_t *out_len,
                          uint64_t *resume_pos) {
    uint64_t pos = resume_pos ? *resume_pos : 0;
    while (pos < len) {
        uint64_t tag;
        if (!read_varint(p, len, &pos, &tag)) return 0;
        uint32_t field = (uint32_t)(tag >> 3), wire = (uint32_t)(tag & 7);
        if (field == want_field && wire == 2) {
            uint64_t n;
            if (!read_varint(p, len, &pos, &n) || n > len - pos) return 0;
            *out = p + pos;
            *out_len = n;
            if (resume_pos) *resume_pos = pos + n;
            return 1;
        }
        if (!skip_field(p, len, &pos, wire)) return 0;
    }
    return 0;
}

/* Locate the Feature message for `key` inside a serialized Example. */
static int find_feature(const uint8_t *ex, uint64_t ex_len, const char *key,
                        const uint8_t **feat, uint64_t *feat_len) {
    const uint8_t *features;
    uint64_t features_len;
    if (!find_len_field(ex, ex_len, 1, &features, &features_len, NULL))
        return 0;
    uint64_t klen = strlen(key);
    uint64_t pos = 0;
    const uint8_t *entry;
    uint64_t entry_len;
    while (find_len_field(features, features_len, 1, &entry, &entry_len, &pos)) {
        const uint8_t *k;
        uint64_t kl;
        if (!find_len_field(entry, entry_len, 1, &k, &kl, NULL)) continue;
        if (kl == klen && memcmp(k, key, klen) == 0)
            return find_len_field(entry, entry_len, 2, feat, feat_len, NULL);
    }
    return 0;
}

/* First bytes value of a BytesList feature. Returns 1/0. */
int ddlt_example_bytes(const uint8_t *ex, uint64_t ex_len, const char *key,
                       const uint8_t **out, uint64_t *out_len) {
    const uint8_t *feat, *blist;
    uint64_t feat_len, blist_len;
    if (!find_feature(ex, ex_len, key, &feat, &feat_len)) return 0;
    if (!find_len_field(feat, feat_len, 1, &blist, &blist_len, NULL)) return 0;
    return find_len_field(blist, blist_len, 1, out, out_len, NULL);
}

/* First int64 of an Int64List feature (packed or unpacked). Returns 1/0. */
int ddlt_example_int64(const uint8_t *ex, uint64_t ex_len, const char *key,
                       int64_t *out) {
    const uint8_t *feat, *ilist;
    uint64_t feat_len, ilist_len;
    if (!find_feature(ex, ex_len, key, &feat, &feat_len)) return 0;
    if (!find_len_field(feat, feat_len, 3, &ilist, &ilist_len, NULL)) return 0;
    uint64_t pos = 0;
    while (pos < ilist_len) {
        uint64_t tag;
        if (!read_varint(ilist, ilist_len, &pos, &tag)) return 0;
        uint32_t field = (uint32_t)(tag >> 3), wire = (uint32_t)(tag & 7);
        if (field == 1 && wire == 0) {          /* unpacked varint */
            uint64_t v;
            if (!read_varint(ilist, ilist_len, &pos, &v)) return 0;
            *out = (int64_t)v;
            return 1;
        }
        if (field == 1 && wire == 2) {          /* packed */
            uint64_t n, v;
            if (!read_varint(ilist, ilist_len, &pos, &n)) return 0;
            if (n > ilist_len - pos) return 0;  /* overflow-safe bound */
            uint64_t end = pos + n;
            if (!read_varint(ilist, end, &pos, &v)) return 0;
            *out = (int64_t)v;
            return 1;
        }
        if (!skip_field(ilist, ilist_len, &pos, wire)) return 0;
    }
    return 0;
}

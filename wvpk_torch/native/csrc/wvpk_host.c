/* Native host runtime: WavPack container scanning and bitstream staging.
 *
 * The device compute path is JAX/XLA; this C tier accelerates the host
 * side of the pipeline (the reference has no native tier to mirror — it is
 * 100% C# — so this covers the host hot spots of OUR runtime: the
 * full-file header scan that builds the block index, and the memcpy fan-in
 * that stages per-lane bitstreams).
 *
 * Header semantics match wvpk/container/header.py (reference
 * WavPackUtils.cs:600-671): magic + sanity check, <=1 MiB resync,
 * WavPack5 40-bit total_samples/block_index high bytes at offsets 11/10.
 */

#include <stdint.h>
#include <string.h>

#define FIELDS_PER_HEADER 8
#define MAX_RESYNC 1048576L

/* out layout per header (int64 each):
 * ck_size, version, total_samples, block_index, block_samples, flags,
 * crc (sign-extended int32), stream_position */
long wvpk_scan_headers(const uint8_t *data, long n, int64_t *out,
                       long max_headers)
{
    long pos = 0, count = 0;
    while (pos + 32 <= n && count < max_headers) {
        long skipped = 0;
        int found = 0;
        while (pos + 32 <= n) {
            const uint8_t *b = data + pos;
            if (b[0] == 'w' && b[1] == 'v' && b[2] == 'p' && b[3] == 'k' &&
                !(b[4] & 1) && b[6] < 16 && b[7] == 0 && b[9] == 4 &&
                b[8] >= 0x02 && b[8] <= 0x10) {
                found = 1;
                break;
            }
            pos++;
            if (++skipped > MAX_RESYNC)
                return count;
        }
        if (!found)
            break;
        const uint8_t *b = data + pos;
        int64_t *h = out + count * FIELDS_PER_HEADER;
        uint32_t ck = (uint32_t)b[4] | ((uint32_t)b[5] << 8) |
                      ((uint32_t)b[6] << 16) | ((uint32_t)b[7] << 24);
        h[0] = (int64_t)ck;
        h[1] = (int64_t)((uint32_t)b[8] | ((uint32_t)b[9] << 8));
        h[2] = ((int64_t)b[11] << 32) |
               ((uint32_t)b[12] | ((uint32_t)b[13] << 8) |
                ((uint32_t)b[14] << 16) | ((uint32_t)b[15] << 24));
        h[3] = ((int64_t)b[10] << 32) |
               ((uint32_t)b[16] | ((uint32_t)b[17] << 8) |
                ((uint32_t)b[18] << 16) | ((uint32_t)b[19] << 24));
        h[4] = (int64_t)((uint32_t)b[20] | ((uint32_t)b[21] << 8) |
                         ((uint32_t)b[22] << 16) | ((uint32_t)b[23] << 24));
        h[5] = (int64_t)((uint32_t)b[24] | ((uint32_t)b[25] << 8) |
                         ((uint32_t)b[26] << 16) | ((uint32_t)b[27] << 24));
        h[6] = (int64_t)(int32_t)((uint32_t)b[28] | ((uint32_t)b[29] << 8) |
                                  ((uint32_t)b[30] << 16) |
                                  ((uint32_t)b[31] << 24));
        h[7] = pos;
        count++;
        pos += (long)ck + 8;
    }
    return count;
}

/* ------------------------------------------------------------------ *
 * Block metadata parse (the reference's unpack_init walk,
 * MetadataUtils.cs:111-193 + UnpackUtils.cs:156-382 + WordsUtils.cs:75-187)
 * for PCM blocks. DSD blocks and context-update metadata (channel info,
 * config, sample rate, RIFF header/trailer, extension) return the
 * python-fallback status so the Python layer keeps exact behavior there.
 * ------------------------------------------------------------------ */

static const uint8_t exp2_table[256] = {
    0x00, 0x01, 0x01, 0x02, 0x03, 0x03, 0x04, 0x05, 0x06, 0x06, 0x07, 0x08, 0x08, 0x09, 0x0a, 0x0b,
    0x0b, 0x0c, 0x0d, 0x0e, 0x0e, 0x0f, 0x10, 0x10, 0x11, 0x12, 0x13, 0x13, 0x14, 0x15, 0x16, 0x16,
    0x17, 0x18, 0x19, 0x19, 0x1a, 0x1b, 0x1c, 0x1d, 0x1d, 0x1e, 0x1f, 0x20, 0x20, 0x21, 0x22, 0x23,
    0x24, 0x24, 0x25, 0x26, 0x27, 0x28, 0x28, 0x29, 0x2a, 0x2b, 0x2c, 0x2c, 0x2d, 0x2e, 0x2f, 0x30,
    0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x3a, 0x3b, 0x3c, 0x3d,
    0x3e, 0x3f, 0x40, 0x41, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x48, 0x49, 0x4a, 0x4b,
    0x4c, 0x4d, 0x4e, 0x4f, 0x50, 0x51, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a,
    0x5b, 0x5c, 0x5d, 0x5e, 0x5e, 0x5f, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x6b, 0x6c, 0x6d, 0x6e, 0x6f, 0x70, 0x71, 0x72, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x7b, 0x7c, 0x7d, 0x7e, 0x7f, 0x80, 0x81, 0x82, 0x83, 0x84, 0x85, 0x87, 0x88, 0x89, 0x8a,
    0x8b, 0x8c, 0x8d, 0x8e, 0x8f, 0x90, 0x91, 0x92, 0x93, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0x9b,
    0x9c, 0x9d, 0x9f, 0xa0, 0xa1, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa8, 0xa9, 0xaa, 0xab, 0xac, 0xad,
    0xaf, 0xb0, 0xb1, 0xb2, 0xb3, 0xb4, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xbc, 0xbd, 0xbe, 0xbf, 0xc0,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc8, 0xc9, 0xca, 0xcb, 0xcd, 0xce, 0xcf, 0xd0, 0xd2, 0xd3, 0xd4,
    0xd6, 0xd7, 0xd8, 0xd9, 0xdb, 0xdc, 0xdd, 0xde, 0xe0, 0xe1, 0xe2, 0xe4, 0xe5, 0xe6, 0xe8, 0xe9,
    0xea, 0xec, 0xed, 0xee, 0xf0, 0xf1, 0xf2, 0xf4, 0xf5, 0xf6, 0xf8, 0xf9, 0xfa, 0xfc, 0xfd, 0xff,
};

/* exp2s (WordsUtils.cs:633-646); high-shift behavior matches the Python
 * golden model (value << k wrapped to 32 bits, i.e. 0 for k >= 32) */
static int32_t wv_exp2s(int32_t log)
{
    int32_t value, neg = 0;
    if (log < 0) { log = -log; neg = 1; }
    value = (int32_t)exp2_table[log & 0xff] | 0x100;
    log >>= 8;
    if (log <= 9)
        value >>= (9 - log);
    else if (log - 9 >= 32)
        value = 0;
    else
        value = (int32_t)((uint32_t)value << (log - 9));
    return neg ? -value : value;
}

/* restore_weight (WordsUtils.cs:653-661); w is the raw metadata byte */
static int32_t wv_restore_weight(uint8_t w)
{
    int32_t v = (int8_t)w;
    int32_t r = (int16_t)(v << 3);
    if (r > 0)
        r += (r + 64) >> 7;
    return (int16_t)r;
}

/* header flag bits used here (Defines.cs) */
#define F_MONO_DATA   (0x4u | 0x40000000u)   /* MONO_FLAG | FALSE_STEREO */
#define F_HYBRID      0x8
#define F_HYBRID_BITRATE 0x200
#define F_FLOAT_DATA  0x80
#define F_DSD         0x80000000u

#define MAX_NTERMS 16
#define MAX_TERM 8

/* st (int64) layout — keep in sync with wvpk/native/__init__.py */
enum {
    S_NUM_TERMS = 0,
    S_TERMS = 1,            /* 16 */
    S_DELTAS = 17,          /* 16 */
    S_WA = 33,              /* 16 */
    S_WB = 49,              /* 16 */
    S_SAMPA = 65,           /* 16*8 */
    S_SAMPB = 193,          /* 16*8 */
    S_MED = 321,            /* 2*3 */
    S_SLOW = 327,           /* 2 */
    S_ACC = 329,            /* 2 */
    S_BDELTA = 331,         /* 2 */
    S_FLOAT = 333,          /* flags, shift, max_exp, norm_exp, min_sz, max_so */
    S_INT32 = 339,          /* sent, zeros, ones, dups, max_width */
    S_CRC_MVX = 344,
    S_WVX_START_BIT = 345,
    S_WV_OFF = 346, S_WV_LEN = 347,
    S_WVC_OFF = 348, S_WVC_LEN = 349,
    S_WVX_OFF = 350, S_WVX_LEN = 351,
    S_UPD_FIVE = 352,       /* saw ID_BLOCK_CHECKSUM (WavPack5 marker) */
    S_NFIELDS = 353
};

/* returns 0 = ok, 1 = python fallback wanted, -1 = metadata error */
long wvpk_parse_block(const uint8_t *data, long n, long hpos, int64_t *st)
{
    long pos, end, i;
    uint32_t flags, version;
    int mono, hybrid;
    long num_terms = 0;
    int have_wv = 0;

    if (hpos + 32 > n)
        return -1;
    {
        const uint8_t *b = data + hpos;
        uint32_t ck = (uint32_t)b[4] | ((uint32_t)b[5] << 8) |
                      ((uint32_t)b[6] << 16) | ((uint32_t)b[7] << 24);
        version = (uint32_t)b[8] | ((uint32_t)b[9] << 8);
        flags = (uint32_t)b[24] | ((uint32_t)b[25] << 8) |
                ((uint32_t)b[26] << 16) | ((uint32_t)b[27] << 24);
        pos = hpos + 32;
        end = hpos + (long)ck + 8;
        if (end > n)
            return -1;
    }
    if (flags & F_DSD)
        return 1;
    mono = (flags & F_MONO_DATA) != 0;
    hybrid = (flags & F_HYBRID) != 0;

    for (i = 0; i < S_NFIELDS; i++)
        st[i] = 0;

    while (pos < end) {
        uint32_t mid, raw_id;
        long blen, stored;
        const uint8_t *p;

        if (pos + 2 > n)
            return -1;
        raw_id = data[pos];
        blen = (long)data[pos + 1] << 1;
        pos += 2;
        if (raw_id & 0x80) {            /* ID_LARGE */
            if (pos + 2 > n)
                return -1;
            blen += ((long)data[pos] << 9) + ((long)data[pos + 1] << 17);
            pos += 2;
        }
        stored = blen;
        if (raw_id & 0x40)              /* ID_ODD_SIZE */
            blen -= 1;
        mid = raw_id & 0x3f;            /* LARGE + ODD bits stripped */
        if (pos + stored > n || blen < 0)
            return -1;
        p = data + pos;

        switch (mid) {
        case 0x0: case 0x1: case 0x7:   /* dummy, encoder info, shaping */
            break;
        case 0x2: {                     /* decorr terms */
            long t;
            if (blen > MAX_NTERMS)
                return -1;
            num_terms = blen;
            st[S_NUM_TERMS] = num_terms;
            for (t = 0; t < blen; t++) {
                long dc = blen - 1 - t;
                int term = (int)(p[t] & 0x1f) - 5;
                int delta = (p[t] >> 5) & 0x7;
                if (term < -3 || (term > MAX_TERM && term < 17) || term > 18)
                    return -1;
                st[S_TERMS + dc] = term;
                st[S_DELTAS + dc] = delta;
            }
            break;
        }
        case 0x3: {                     /* decorr weights */
            long cnt = mono ? blen : blen / 2, c = 0, idx = num_terms - 1, t;
            if (cnt > num_terms)
                return -1;
            for (t = 0; t < cnt; t++, idx--) {
                st[S_WA + idx] = wv_restore_weight(p[c++]);
                if (!mono)
                    st[S_WB + idx] = wv_restore_weight(p[c++]);
            }
            break;
        }
        case 0x4: {                     /* decorr samples */
            long c = 0, idx = num_terms - 1;
            if (version == 0x402 && hybrid)
                c += mono ? 2 : 4;
            while (c < blen) {
                int64_t term;
                if (idx < 0)
                    return -1;
                term = st[S_TERMS + idx];
#define RD16S(dst) do { \
    int32_t v; \
    if (c + 2 > blen) return -1; \
    v = (int32_t)p[c] | ((int32_t)p[c + 1] << 8); \
    if (v >= 0x8000) v -= 0x10000; \
    (dst) = wv_exp2s(v); \
    c += 2; } while (0)
                if (term > MAX_TERM) {
                    RD16S(st[S_SAMPA + idx * 8 + 0]);
                    RD16S(st[S_SAMPA + idx * 8 + 1]);
                    if (!mono) {
                        RD16S(st[S_SAMPB + idx * 8 + 0]);
                        RD16S(st[S_SAMPB + idx * 8 + 1]);
                    }
                } else if (term < 0) {
                    RD16S(st[S_SAMPA + idx * 8 + 0]);
                    RD16S(st[S_SAMPB + idx * 8 + 0]);
                } else {
                    long m;
                    for (m = 0; m < term; m++) {
                        RD16S(st[S_SAMPA + idx * 8 + m]);
                        if (!mono)
                            RD16S(st[S_SAMPB + idx * 8 + m]);
                    }
                }
                idx--;
            }
            break;
        }
        case 0x5: {                     /* entropy vars */
            long c;
            if (!mono && blen != 12)
                return -1;
            if (blen < (mono ? 6 : 12))
                return -1;
            for (c = 0; c < 3; c++)
                st[S_MED + c] = wv_exp2s((int32_t)p[c * 2] |
                                         ((int32_t)p[c * 2 + 1] << 8));
            if (!mono)
                for (c = 0; c < 3; c++)
                    st[S_MED + 3 + c] = wv_exp2s((int32_t)p[6 + c * 2] |
                                                 ((int32_t)p[7 + c * 2] << 8));
            break;
        }
        case 0x6: {                     /* hybrid profile */
            long c = 0;
#define RD16U(v) do { \
    if (c + 2 > blen) return -1; \
    (v) = (int32_t)p[c] | ((int32_t)p[c + 1] << 8); \
    c += 2; } while (0)
            int32_t v;
            if (flags & F_HYBRID_BITRATE) {
                RD16U(v); st[S_SLOW + 0] = wv_exp2s(v);
                if (!mono) { RD16U(v); st[S_SLOW + 1] = wv_exp2s(v); }
            }
            RD16U(v); st[S_ACC + 0] = (int64_t)v << 16;
            if (!mono) { RD16U(v); st[S_ACC + 1] = (int64_t)v << 16; }
            if (c < blen) {
                RD16U(v);
                st[S_BDELTA + 0] = wv_exp2s(v >= 0x8000 ? v - 0x10000 : v);
                if (!mono) {
                    RD16U(v);
                    st[S_BDELTA + 1] = wv_exp2s(v >= 0x8000 ? v - 0x10000 : v);
                }
                if (c < blen)
                    return -1;
            }
            break;
        }
        case 0x8:                       /* float info */
            if (blen != 4)
                return -1;
            st[S_FLOAT + 0] = p[0];
            st[S_FLOAT + 1] = p[1];
            st[S_FLOAT + 2] = p[2];
            st[S_FLOAT + 3] = p[3];
            break;
        case 0x9:                       /* int32 info */
            if (blen != 4)
                return -1;
            st[S_INT32 + 0] = p[0];
            st[S_INT32 + 1] = p[1];
            st[S_INT32 + 2] = p[2];
            st[S_INT32 + 3] = p[3];
            break;
        case 0xA:                       /* wv bitstream */
            st[S_WV_OFF] = pos;
            st[S_WV_LEN] = blen;
            have_wv = 1;
            break;
        case 0xB:                       /* wvc bitstream */
            if (blen & 1)
                return -1;
            st[S_WVC_OFF] = pos;
            st[S_WVC_LEN] = blen;
            break;
        case 0xC: case 0x2C: {          /* wvx bitstream (old / new) */
            int is_new = mid == 0x2C;
            if (blen <= 4 || (blen & 1))
                return -1;
            st[S_CRC_MVX] = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                                      ((uint32_t)p[2] << 16) |
                                      ((uint32_t)p[3] << 24));
            st[S_WVX_OFF] = pos + 4;
            st[S_WVX_LEN] = blen - 4;
            if (is_new) {
                uint8_t first = (blen > 4) ? p[4] : 0;
                if (flags & F_FLOAT_DATA) {
                    uint8_t second = (blen > 5)
                        ? (uint8_t)(((p[4] >> 5) | (p[5] << 3)) & 0x1f) : 0;
                    st[S_FLOAT + 4] = first & 0x1f;
                    st[S_FLOAT + 5] = second;
                    st[S_WVX_START_BIT] = 10;
                } else {
                    st[S_INT32 + 4] = first & 0x1f;
                    st[S_WVX_START_BIT] = 5;
                }
            }
            break;
        }
        case 0xD: case 0xE:             /* channel info, DSD: fallback */
            return 1;
        case 0x2F:                      /* block checksum (WavPack5) */
            st[S_UPD_FIVE] = 1;
            break;
        case 0x21: case 0x22: case 0x23: case 0x24:   /* riff hdr/trailer */
        case 0x25: case 0x27: case 0x28: case 0x2A:   /* config/srate/... */
        case 0x26:                      /* MD5 sum: surfaced via updates */
            return 1;                   /* context updates: fallback */
        default:
            if (mid & 0x20)             /* other optional ids: ignored */
                break;
            return -1;                  /* invalid metadata id */
        }
        pos += stored;
    }
    if (pos != end)
        return -1;
    /* audio block must carry a wv bitstream (UnpackUtils.cs:51-55) */
    {
        const uint8_t *b = data + hpos;
        uint32_t bs = (uint32_t)b[20] | ((uint32_t)b[21] << 8) |
                      ((uint32_t)b[22] << 16) | ((uint32_t)b[23] << 24);
        if (bs != 0 && !have_wv)
            return -1;
    }
    return 0;
}

/* Stage L payload slices of `blob` into a (L, stride) byte matrix whose
 * rows are pre-filled with the 0xff EOF fill. */
void wvpk_pack_streams(const uint8_t *blob, const int64_t *offs,
                       const int64_t *lens, long L, uint8_t *out,
                       long stride)
{
    long i;
    for (i = 0; i < L; i++) {
        long len = (long)lens[i];
        if (len > stride)
            len = stride;
        memcpy(out + i * stride, blob + offs[i], (size_t)len);
    }
}

/* Native lossless encode hot path.
 *
 * Bit-identical port of the pure-Python block encoder's per-sample
 * machinery (wvpk/testgen/encoder.py: invert_*, reconstruct_*,
 * EntropyEncoder.encode_word, BitWriter) for non-hybrid blocks, which
 * covers the public encode() surface's lossless path. The entropy
 * state machine mirrors the reference decoder's get_words
 * (WordsUtils.cs:272-511) run in reverse; the decorrelation inversion /
 * reconstruction mirror decorr_stereo_pass(_cont) / decorr_mono_pass
 * (UnpackUtils.cs:688-1240) with exact C# int32 wrap semantics.
 *
 * Degenerate regimes (wrapped/negative medians, non-positive interval
 * widths) return an error so the caller falls back to the Python
 * encoder, whose bignum arithmetic matches the scalar oracle.
 */

#include <stdint.h>
#include <string.h>

#define MAX_TERM   8
#define LIMIT_ONES 16
#define DIV0 128
#define DIV1 64
#define DIV2 32
#define SLS 8
#define SLO (1 << (SLS - 1))

/* header flags (Defines.cs) */
#define F_HYBRID        0x8
#define F_HYBRID_BITRATE 0x200
#define F_HYBRID_BALANCE 0x400

typedef struct {
    int32_t term, delta, wa, wb, m;
    int32_t sa[8], sb[8];
} encpass;

#define PSTATE_INTS 21  /* term,delta,wa,wb,m,sa[8],sb[8] */
#define MAX_PASSES 16

/* ---------------- decorrelation ---------------- */

static inline int64_t pred64(int32_t w, int32_t sam)
{
    return ((int64_t)w * sam + 512) >> 10;
}

static inline int32_t upd(int32_t w, int32_t delta, int32_t sam, int32_t v)
{
    if (sam != 0 && v != 0)
        w += ((sam ^ v) >= 0) ? delta : -delta;
    return w;
}

static inline int32_t upd_clamp(int32_t w, int32_t delta, int32_t sam,
                                int32_t v)
{
    if ((sam ^ v) < 0) {
        if (sam != 0 && v != 0) {
            w -= delta;
            if (w < -1024)
                w = (w < 0) ? -1024 : 1024;
        }
    } else {
        if (sam != 0 && v != 0) {
            w += delta;
            if (w > 1024)
                w = (w < 0) ? -1024 : 1024;
        }
    }
    return w;
}

static inline void sams(const encpass *p, int32_t va, int32_t vb,
                        int32_t *a, int32_t *b)
{
    int32_t t = p->term;
    if (t == 17) {
        *a = (int32_t)(2 * (int64_t)p->sa[0] - p->sa[1]);
        *b = (int32_t)(2 * (int64_t)p->sb[0] - p->sb[1]);
    } else if (t == 18) {
        *a = (int32_t)((3 * (int64_t)p->sa[0] - p->sa[1]) >> 1);
        *b = (int32_t)((3 * (int64_t)p->sb[0] - p->sb[1]) >> 1);
    } else if (t == -1) {
        *a = p->sa[0]; *b = va;
    } else if (t == -2) {
        *a = vb; *b = p->sb[0];
    } else if (t == -3) {
        *a = p->sa[0]; *b = p->sb[0];
    } else {
        int m = p->m & (MAX_TERM - 1);
        *a = p->sa[m]; *b = p->sb[m];
    }
}

static void invert_stereo(const encpass *ps, int np, int32_t xa, int32_t xb,
                          int32_t *ra, int32_t *rb)
{
    int32_t va = xa, vb = xb;
    for (int i = np - 1; i >= 0; i--) {
        int32_t sa_, sb_;
        sams(&ps[i], va, vb, &sa_, &sb_);
        va = (int32_t)((int64_t)va - pred64(ps[i].wa, sa_));
        vb = (int32_t)((int64_t)vb - pred64(ps[i].wb, sb_));
    }
    *ra = va; *rb = vb;
}

static void reconstruct_stereo(encpass *ps, int np, int32_t ra, int32_t rb,
                               int32_t *out_a, int32_t *out_b)
{
    int32_t va = ra, vb = rb, oa = ra, ob = rb;
    for (int i = 0; i < np; i++) {
        encpass *p = &ps[i];
        int32_t t = p->term;
        if (t == 17 || t == 18) {
            int32_t sa_, sb_;
            sams(p, 0, 0, &sa_, &sb_);
            oa = (int32_t)(pred64(p->wa, sa_) + va);
            p->wa = upd(p->wa, p->delta, sa_, va);
            ob = (int32_t)(pred64(p->wb, sb_) + vb);
            p->wb = upd(p->wb, p->delta, sb_, vb);
            p->sa[1] = p->sa[0]; p->sa[0] = oa;
            p->sb[1] = p->sb[0]; p->sb[0] = ob;
        } else if (t == -1) {
            oa = (int32_t)(pred64(p->wa, p->sa[0]) + va);
            p->wa = upd_clamp(p->wa, p->delta, p->sa[0], va);
            ob = (int32_t)(pred64(p->wb, oa) + vb);
            p->wb = upd_clamp(p->wb, p->delta, oa, vb);
            p->sa[0] = ob;
        } else if (t == -2) {
            ob = (int32_t)(pred64(p->wb, p->sb[0]) + vb);
            p->wb = upd_clamp(p->wb, p->delta, p->sb[0], vb);
            oa = (int32_t)(pred64(p->wa, ob) + va);
            p->wa = upd_clamp(p->wa, p->delta, ob, va);
            p->sb[0] = oa;
        } else if (t == -3) {
            oa = (int32_t)(pred64(p->wa, p->sa[0]) + va);
            p->wa = upd_clamp(p->wa, p->delta, p->sa[0], va);
            ob = (int32_t)(pred64(p->wb, p->sb[0]) + vb);
            p->wb = upd_clamp(p->wb, p->delta, p->sb[0], vb);
            p->sb[0] = oa;
            p->sa[0] = ob;
        } else {
            int m = p->m & (MAX_TERM - 1);
            int k = (p->m + t) & (MAX_TERM - 1);
            int32_t sa_ = p->sa[m], sb_ = p->sb[m];
            oa = (int32_t)(pred64(p->wa, sa_) + va);
            p->wa = upd(p->wa, p->delta, sa_, va);
            p->sa[k] = oa;
            ob = (int32_t)(pred64(p->wb, sb_) + vb);
            p->wb = upd(p->wb, p->delta, sb_, vb);
            p->sb[k] = ob;
        }
        va = oa; vb = ob;
    }
    for (int i = 0; i < np; i++)
        if (ps[i].term >= 1 && ps[i].term <= MAX_TERM)
            ps[i].m++;
    *out_a = va; *out_b = vb;
}

static int32_t invert_mono(const encpass *ps, int np, int32_t xa)
{
    int32_t va = xa;
    for (int i = np - 1; i >= 0; i--) {
        int32_t sa_, sb_;
        sams(&ps[i], va, 0, &sa_, &sb_);
        va = (int32_t)((int64_t)va - pred64(ps[i].wa, sa_));
    }
    return va;
}

static int32_t reconstruct_mono(encpass *ps, int np, int32_t ra)
{
    int32_t va = ra, oa = ra;
    for (int i = 0; i < np; i++) {
        encpass *p = &ps[i];
        int32_t t = p->term;
        if (t == 17 || t == 18) {
            int32_t sa_, sb_;
            sams(p, 0, 0, &sa_, &sb_);
            oa = (int32_t)(pred64(p->wa, sa_) + va);
            p->wa = upd(p->wa, p->delta, sa_, va);
            p->sa[1] = p->sa[0]; p->sa[0] = oa;
        } else {
            int m = p->m & (MAX_TERM - 1);
            int k = (p->m + t) & (MAX_TERM - 1);
            int32_t sa_ = p->sa[m];
            oa = (int32_t)(pred64(p->wa, sa_) + va);
            p->wa = upd(p->wa, p->delta, sa_, va);
            p->sa[k] = oa;
        }
        va = oa;
    }
    for (int i = 0; i < np; i++)
        if (ps[i].term >= 1 && ps[i].term <= MAX_TERM)
            ps[i].m++;
    return va;
}

/* ---------------- bit writer (LSB-first) ---------------- */

typedef struct {
    uint8_t *buf;
    int64_t cap_bits;
    int64_t pos;
    int err;
} bw_t;

static inline void putbit(bw_t *b, int v)
{
    if (b->pos >= b->cap_bits) { b->err = 1; return; }
    if (v)
        b->buf[b->pos >> 3] |= (uint8_t)(1u << (b->pos & 7));
    b->pos++;
}

static void putbits(bw_t *b, uint64_t v, int n)
{
    for (int k = 0; k < n; k++)
        putbit(b, (int)((v >> k) & 1));
}

static void put_unary_ones(bw_t *b, int64_t n)
{
    while (n-- > 0)
        putbit(b, 1);
    putbit(b, 0);
}

static inline int bitlen64(uint64_t v)
{
    return v ? 64 - __builtin_clzll(v) : 0;
}

static void put_gamma(bw_t *b, uint64_t v)
{
    if (v < 2) {
        put_unary_ones(b, (int64_t)v);
    } else {
        int c = bitlen64(v);
        put_unary_ones(b, c);
        putbits(b, v, c - 1);   /* top bit implicit */
    }
}

/* ---------------- fixed-point log2 / exp2 (WordsUtils.cs:588-646) ---- */

static inline int nbits8(int64_t v)     /* bit_length for 0..255 */
{
    return v ? 32 - __builtin_clz((uint32_t)v) : 0;
}

static int64_t mylog2_c(int64_t av, const int32_t *log2tab)
{
    av += av >> 9;
    int dbits;
    if (av < 256) {
        dbits = nbits8(av);
        return ((int64_t)dbits << 8) + log2tab[(av << (9 - dbits)) & 0xFF];
    }
    if (av < ((int64_t)1 << 16))
        dbits = nbits8(av >> 8) + 8;
    else if (av < ((int64_t)1 << 24))
        dbits = nbits8(av >> 16) + 16;
    else
        dbits = nbits8((av >> 24) & 0xFF) + 24;
    return ((int64_t)dbits << 8) + log2tab[(av >> (dbits - 9)) & 0xFF];
}

static int32_t exp2s_c(int64_t log, const int32_t *exp2tab)
{
    if (log < 0)
        return (int32_t)(-(int64_t)exp2s_c(-log, exp2tab));
    int64_t value = exp2tab[log & 0xFF] | 0x100;
    log >>= 8;
    if (log <= 9)
        return (int32_t)(value >> (9 - log));
    return (int32_t)(value << (log - 9));   /* i32 wrap, like Python */
}

/* ---------------- entropy encoder state ---------------- */

typedef struct {
    int32_t med[2][3];
    int64_t zeros_acc;
    int clear;
    int64_t csamples;
    int mono;
    int flags;
    /* hybrid state (WordsUtils.cs:195-261); int64 mirrors Python's
     * unbounded ints (values stay small except bitrate_acc, a C# long) */
    int64_t slow[2];
    int64_t bitrate_acc[2];
    int64_t bitrate_delta[2];
    int64_t error_limit[2];
    const int32_t *log2tab, *exp2tab;
    /* deferred word: unary count + up to ~34 payload bits */
    int pend_valid;
    int64_t pend_oc_eff;
    uint64_t pend_bits;
    int pend_nbits;
    int err;                    /* degenerate regime -> fallback */
} ent_t;

static void update_error_limit(ent_t *e)
{
    e->bitrate_acc[0] += e->bitrate_delta[0];   /* i64 wrap natural */
    int64_t bitrate_0 = (int32_t)(e->bitrate_acc[0] >> 16);
    if (e->mono) {
        if (e->flags & F_HYBRID_BITRATE) {
            int64_t slow_log_0 = (e->slow[0] + SLO) >> SLS;
            if (slow_log_0 - bitrate_0 > -0x100)
                e->error_limit[0] =
                    exp2s_c(slow_log_0 - bitrate_0 + 0x100, e->exp2tab);
            else
                e->error_limit[0] = 0;
        } else {
            e->error_limit[0] = exp2s_c(bitrate_0, e->exp2tab);
        }
    } else {
        e->bitrate_acc[1] += e->bitrate_delta[1];
        int64_t bitrate_1 = (int32_t)(e->bitrate_acc[1] >> 16);
        if (e->flags & F_HYBRID_BITRATE) {
            int64_t slow_log_0 = (e->slow[0] + SLO) >> SLS;
            int64_t slow_log_1 = (e->slow[1] + SLO) >> SLS;
            if (e->flags & F_HYBRID_BALANCE) {
                int64_t balance =
                    (slow_log_1 - slow_log_0 + bitrate_1 + 1) >> 1;
                if (balance > bitrate_0) {
                    bitrate_1 = bitrate_0 * 2;
                    bitrate_0 = 0;
                } else if (-balance > bitrate_0) {
                    bitrate_0 = bitrate_0 * 2;
                    bitrate_1 = 0;
                } else {
                    bitrate_1 = bitrate_0 + balance;
                    bitrate_0 = bitrate_0 - balance;
                }
            }
            if (slow_log_0 - bitrate_0 > -0x100)
                e->error_limit[0] =
                    exp2s_c(slow_log_0 - bitrate_0 + 0x100, e->exp2tab);
            else
                e->error_limit[0] = 0;
            if (slow_log_1 - bitrate_1 > -0x100)
                e->error_limit[1] =
                    exp2s_c(slow_log_1 - bitrate_1 + 0x100, e->exp2tab);
            else
                e->error_limit[1] = 0;
        } else {
            e->error_limit[0] = exp2s_c(bitrate_0, e->exp2tab);
            e->error_limit[1] = exp2s_c(bitrate_1, e->exp2tab);
        }
    }
}

static void flush_pend(ent_t *e, bw_t *b, int bnext)
{
    if (!e->pend_valid)
        return;
    int64_t raw = 2 * e->pend_oc_eff + bnext;
    if (raw < LIMIT_ONES) {
        put_unary_ones(b, raw);
    } else {
        put_unary_ones(b, LIMIT_ONES);
        put_gamma(b, (uint64_t)(raw - LIMIT_ONES));
    }
    putbits(b, e->pend_bits, e->pend_nbits);
    e->pend_valid = 0;
    e->pend_bits = 0;
    e->pend_nbits = 0;
}

static inline int medians_tiny(const ent_t *e)
{
    return ((e->med[0][0] & ~1) == 0) && ((e->med[1][0] & ~1) == 0);
}

/* [low, high] interval for ones_count + 5/7-2/7 median adaptation
 * (WordsUtils.cs:433-475). Returns 0 ok, -1 degenerate. */
static int median_interval(ent_t *e, int ch, int64_t oc,
                           int64_t *low_out, int64_t *high_out)
{
    int32_t m0 = e->med[ch][0], m1 = e->med[ch][1], m2 = e->med[ch][2];
    if (m0 < 0 || m1 < 0 || m2 < 0)
        return -1;              /* wrapped medians: Python handles */
    int64_t g0 = (m0 >> 4) + 1, g1 = (m1 >> 4) + 1, g2 = (m2 >> 4) + 1;
    int64_t low, high;
    if (oc == 0) {
        low = 0;
        high = g0 - 1;
        e->med[ch][0] = (int32_t)(m0 - (((int64_t)m0 + (DIV0 - 2)) >> 7) * 2);
    } else {
        low = g0;
        e->med[ch][0] = (int32_t)(m0 + (((int64_t)m0 + DIV0) >> 7) * 5);
        if (oc == 1) {
            high = low + g1 - 1;
            e->med[ch][1] = (int32_t)(m1 - (((int64_t)m1 + (DIV1 - 2)) >> 6) * 2);
        } else {
            low += g1;
            e->med[ch][1] = (int32_t)(m1 + (((int64_t)m1 + DIV1) >> 6) * 5);
            if (oc == 2) {
                high = low + g2 - 1;
                e->med[ch][2] = (int32_t)(m2 - (((int64_t)m2 + (DIV2 - 2)) >> 5) * 2);
            } else {
                low += (oc - 2) * g2;
                high = low + g2 - 1;
                e->med[ch][2] = (int32_t)(m2 + (((int64_t)m2 + DIV2) >> 5) * 5);
            }
        }
    }
    *low_out = low;
    *high_out = high;
    return 0;
}

/* encode one residual; zrun = precomputed zero-run length (only
 * consulted when a run could start here, pass -1 if not computed: the
 * caller must supply it whenever clear && medians_tiny && zeros_acc==0).
 * Returns the reconstructed residual. */
/* cw: hybrid-lossless correction stream (the wvc block payload) —
 * one minimal-binary code per error_limit-quantized word over the
 * NARROWED interval; NULL = plain hybrid. Mirrors
 * EntropyEncoder._write_code / the decoder's read_code
 * (WordsUtils.cs:546-570). */
static int32_t encode_word(ent_t *e, bw_t *b, bw_t *cw, int32_t r,
                           int64_t zrun)
{
    int ch = e->mono ? 0 : (int)(e->csamples & 1);

    if (e->clear && medians_tiny(e)) {
        if (e->zeros_acc > 0) {
            e->zeros_acc--;
            if (e->zeros_acc > 0) {
                e->slow[ch] -= (e->slow[ch] + SLO) >> SLS;
                e->csamples++;
                return 0;
            }
            /* fell through: code this word normally */
        } else {
            if (e->pend_valid) { e->err = 1; return 0; }
            if (zrun < 0) { e->err = 1; return 0; }
            put_gamma(b, (uint64_t)zrun);
            if (zrun > 0) {
                e->zeros_acc = zrun;
                e->slow[ch] -= (e->slow[ch] + SLO) >> SLS;
                for (int c2 = 0; c2 < 2; c2++)
                    e->med[c2][0] = e->med[c2][1] = e->med[c2][2] = 0;
                e->csamples++;
                return 0;
            }
        }
    }

    int sign = r < 0;
    int64_t av = sign ? ~(int64_t)r : (int64_t)r;

    int32_t m0 = e->med[ch][0], m1 = e->med[ch][1], m2 = e->med[ch][2];
    if (m0 < 0 || m1 < 0 || m2 < 0) { e->err = 1; return 0; }
    int64_t g0 = (m0 >> 4) + 1, g1 = (m1 >> 4) + 1, g2 = (m2 >> 4) + 1;
    int64_t oc;
    if (av < g0)
        oc = 0;
    else if (av < g0 + g1)
        oc = 1;
    else
        oc = 2 + (av - g0 - g1) / g2;

    int h1_old, emit_unary;
    if (e->clear) {
        h1_old = 0;
        emit_unary = 1;
        e->clear = 0;
    } else if (oc == 0) {
        flush_pend(e, b, 0);
        h1_old = 0;
        emit_unary = 0;
        e->clear = 1;
    } else {
        flush_pend(e, b, 1);
        h1_old = 1;
        emit_unary = 1;
    }

    if ((e->flags & F_HYBRID)
            && (e->mono || (e->csamples & 1) == 0))
        update_error_limit(e);

    int64_t low, high;
    if (median_interval(e, ch, oc, &low, &high) != 0) {
        e->err = 1;
        return 0;
    }

    uint64_t bits = 0;
    int nbits = 0;
    int64_t mid;
    if (e->error_limit[ch] == 0) {
        /* lossless tail: read_code inverse (WordsUtils.cs:546-570) */
        int64_t code = av - low;
        int64_t maxcode = high - low;
        if (maxcode < 0 || code < 0) { e->err = 1; return 0; }
        int bitcount = bitlen64((uint64_t)maxcode);
        if (bitcount) {
            int64_t extras = ((int64_t)1 << bitcount) - maxcode - 1;
            if (code < extras) {
                bits = (uint64_t)code;
                nbits = bitcount - 1;
            } else {
                int64_t cc = code + extras;
                bits = (uint64_t)(cc >> 1);
                nbits = bitcount - 1;
                bits |= (uint64_t)(cc & 1) << nbits;
                nbits += 1;
            }
        }
        mid = av;
    } else {
        /* hybrid tail: binary search to error_limit
         * (WordsUtils.cs:486-492) */
        int64_t err_lim = e->error_limit[ch];
        if (err_lim < 0 || high < low) { e->err = 1; return 0; }
        mid = (high + low + 1) >> 1;
        while (high - low > err_lim) {
            if (nbits > 62) { e->err = 1; return 0; }
            if (av >= mid) {
                bits |= (uint64_t)1 << nbits;
                low = mid;
            } else {
                high = mid - 1;
            }
            nbits++;
            mid = (high + low + 1) >> 1;
        }
        if (cw) {
            /* correction code over the NARROWED interval */
            int64_t code = av - low, maxcode = high - low;
            if (code < 0 || maxcode < 0) { e->err = 1; return 0; }
            int bc = bitlen64((uint64_t)maxcode);
            if (bc) {
                int64_t extras = ((int64_t)1 << bc) - maxcode - 1;
                if (code < extras) {
                    putbits(cw, (uint64_t)code, bc - 1);
                } else {
                    int64_t cc2 = code + extras;
                    putbits(cw, (uint64_t)(cc2 >> 1), bc - 1);
                    putbit(cw, (int)(cc2 & 1));
                }
            }
        }
    }
    bits |= (uint64_t)(sign ? 1 : 0) << nbits;
    nbits += 1;
    if (nbits > 63) { e->err = 1; return 0; }

    if (emit_unary) {
        e->pend_valid = 1;
        e->pend_oc_eff = oc - (h1_old ? 1 : 0);
        e->pend_bits = bits;
        e->pend_nbits = nbits;
    } else {
        putbits(b, bits, nbits);
    }

    if (e->flags & F_HYBRID_BITRATE)
        e->slow[ch] = e->slow[ch] - ((e->slow[ch] + SLO) >> SLS)
            + mylog2_c(mid, e->log2tab);

    e->csamples++;
    return (int32_t)(sign ? ~mid : mid);
}

/* ---------------- zero-run lookahead ---------------- */

static int64_t count_zero_run_mono(const encpass *ps, int np,
                                   const int32_t *targ, int64_t n, int64_t t0)
{
    encpass sim[MAX_PASSES];
    memcpy(sim, ps, sizeof(encpass) * np);
    int64_t z = 0;
    for (int64_t t = t0; t < n; t++) {
        if (invert_mono(sim, np, targ[t]) != 0)
            break;
        reconstruct_mono(sim, np, 0);
        z++;
    }
    return z;
}

static int64_t count_zero_run_stereo(const encpass *ps, int np,
                                     const int32_t *targ, int64_t n,
                                     int64_t t0, int ch0)
{
    encpass sim[MAX_PASSES];
    memcpy(sim, ps, sizeof(encpass) * np);
    int64_t z = 0, t = t0;
    int first = 1;
    while (t < n) {
        int32_t ra, rb, oa, ob;
        invert_stereo(sim, np, targ[2 * t], targ[2 * t + 1], &ra, &rb);
        if (first && ch0 == 1) {
            if (rb != 0)
                break;
            z++;
            reconstruct_stereo(sim, np, 0, 0, &oa, &ob);
            t++;
            first = 0;
            continue;
        }
        if (ra != 0)
            break;
        z++;
        if (rb != 0)
            break;
        z++;
        reconstruct_stereo(sim, np, 0, 0, &oa, &ob);
        t++;
        first = 0;
    }
    return z;
}

/* ---------------- block entry point ---------------- */

/* targ: (n, ch) int32 joint-domain targets, row-major.
 * flags: header flags (hybrid bits matter; mono passed separately).
 * pstate: (npasses, 21) int32 in/out.
 * medians: 6 int32 in/out (ch0 m0..m2, ch1 m0..m2).
 * wstate: 6 int64 in/out: slow[2], bitrate_acc[2], bitrate_delta[2]
 *         (hybrid; zeros for lossless).
 * log2tab/exp2tab: the format's 256-entry tables (from wvpk/tables.py).
 * decoded: (n, ch) int32 out.
 * bits_buf: zero-initialized output buffer, cap_bytes long.
 * Returns 0 ok, or -1 (overflow / degenerate: caller falls back to the
 * Python encoder). */
long wvpk_encode_block(const int32_t *targ, long n, int mono, int flags,
                       int npasses, int32_t *pstate, int32_t *medians,
                       int64_t *wstate, const int32_t *log2tab,
                       const int32_t *exp2tab, int32_t *decoded,
                       uint8_t *bits_buf, long cap_bytes,
                       int64_t *bitlen_out,
                       uint8_t *wvc_buf, long wvc_cap_bytes,
                       int64_t *wvc_bitlen_out)
{
    if (npasses > MAX_PASSES)
        return -1;
    encpass ps[MAX_PASSES];
    for (int i = 0; i < npasses; i++) {
        const int32_t *s = pstate + i * PSTATE_INTS;
        ps[i].term = s[0]; ps[i].delta = s[1];
        ps[i].wa = s[2]; ps[i].wb = s[3]; ps[i].m = s[4];
        memcpy(ps[i].sa, s + 5, 8 * sizeof(int32_t));
        memcpy(ps[i].sb, s + 13, 8 * sizeof(int32_t));
    }

    ent_t e;
    memset(&e, 0, sizeof(e));
    memcpy(e.med[0], medians, 3 * sizeof(int32_t));
    memcpy(e.med[1], medians + 3, 3 * sizeof(int32_t));
    e.clear = 1;                /* block start: holding + zeros cleared */
    e.mono = mono;
    e.flags = flags;
    e.slow[0] = wstate[0]; e.slow[1] = wstate[1];
    e.bitrate_acc[0] = wstate[2]; e.bitrate_acc[1] = wstate[3];
    e.bitrate_delta[0] = wstate[4]; e.bitrate_delta[1] = wstate[5];
    e.log2tab = log2tab;
    e.exp2tab = exp2tab;

    bw_t b;
    b.buf = bits_buf;
    b.cap_bits = (int64_t)cap_bytes * 8;
    b.pos = 0;
    b.err = 0;

    bw_t cw_store, *cw = NULL;
    if (wvc_buf) {
        cw_store.buf = wvc_buf;
        cw_store.cap_bits = (int64_t)wvc_cap_bytes * 8;
        cw_store.pos = 0;
        cw_store.err = 0;
        cw = &cw_store;
    }

    if (mono) {
        for (int64_t t = 0; t < n; t++) {
            int32_t r = invert_mono(ps, npasses, targ[t]);
            int64_t zrun = -1;
            if (e.clear && medians_tiny(&e) && e.zeros_acc == 0)
                zrun = count_zero_run_mono(ps, npasses, targ, n, t);
            int32_t rhat = encode_word(&e, &b, cw, r, zrun);
            if (e.err || b.err || (cw && cw->err))
                return -1;
            decoded[t] = reconstruct_mono(ps, npasses, rhat);
        }
    } else {
        for (int64_t t = 0; t < n; t++) {
            int32_t ra, rb, oa, ob;
            invert_stereo(ps, npasses, targ[2 * t], targ[2 * t + 1],
                          &ra, &rb);
            int64_t zrun = -1;
            if (e.clear && medians_tiny(&e) && e.zeros_acc == 0)
                zrun = count_zero_run_stereo(ps, npasses, targ, n, t, 0);
            int32_t ra_hat = encode_word(&e, &b, cw, ra, zrun);
            if (e.err || b.err || (cw && cw->err))
                return -1;
            zrun = -1;
            if (e.clear && medians_tiny(&e) && e.zeros_acc == 0)
                zrun = count_zero_run_stereo(ps, npasses, targ, n, t, 1);
            int32_t rb_hat = encode_word(&e, &b, cw, rb, zrun);
            if (e.err || b.err || (cw && cw->err))
                return -1;
            reconstruct_stereo(ps, npasses, ra_hat, rb_hat, &oa, &ob);
            decoded[2 * t] = oa;
            decoded[2 * t + 1] = ob;
        }
    }
    flush_pend(&e, &b, 0);      /* EntropyEncoder.finish() */
    if (b.err)
        return -1;
    if (wvc_bitlen_out)
        *wvc_bitlen_out = cw ? cw->pos : 0;

    for (int i = 0; i < npasses; i++) {
        int32_t *s = pstate + i * PSTATE_INTS;
        s[2] = ps[i].wa; s[3] = ps[i].wb; s[4] = ps[i].m;
        memcpy(s + 5, ps[i].sa, 8 * sizeof(int32_t));
        memcpy(s + 13, ps[i].sb, 8 * sizeof(int32_t));
    }
    memcpy(medians, e.med[0], 3 * sizeof(int32_t));
    memcpy(medians + 3, e.med[1], 3 * sizeof(int32_t));
    wstate[0] = e.slow[0]; wstate[1] = e.slow[1];
    wstate[2] = e.bitrate_acc[0]; wstate[3] = e.bitrate_acc[1];
    *bitlen_out = b.pos;
    return 0;
}

/* ---------------- segment packing (device-encoder post-pass) --------- */

/* append nb bits word-at-a-time (vs the encoder's per-bit putbit) */
static void append_bits(bw_t *b, uint64_t v, int nb)
{
    if (nb <= 0)
        return;
    if (b->pos + nb > b->cap_bits) { b->err = 1; return; }
    long wi = b->pos >> 6;
    int sh = (int)(b->pos & 63);
    uint64_t *w = (uint64_t *)b->buf;
    w[wi] |= v << sh;
    if (sh + nb > 64)
        w[wi + 1] |= v >> (64 - sh);
    b->pos += nb;
}

/* Concatenate one lane's variable-length bit segments (contiguous (W,)
 * rows of the transposed segment arrays) plus the final pending flush
 * into an LSB-first byte payload. out must be zeroed, 8-byte padded. */
long wvpk_pack_lane(const uint64_t *sa_lo, const uint64_t *sa_hi,
                    const int32_t *sa_len, const uint64_t *sb_bits,
                    const int32_t *sb_len, long W,
                    const uint8_t *tail, long tail_bits,
                    uint8_t *out, long cap_bytes, int64_t *bitlen_out)
{
    bw_t b;
    b.buf = out;
    b.cap_bits = ((int64_t)cap_bytes - 8) * 8;  /* word-write headroom */
    b.pos = 0;
    b.err = 0;
    for (long i = 0; i < W; i++) {
        int la = sa_len[i];
        if (la > 0) {
            append_bits(&b, sa_lo[i], la < 64 ? la : 64);
            if (la > 64)
                append_bits(&b, sa_hi[i], la - 64);
        }
        int lb = sb_len[i];
        if (lb > 0)
            append_bits(&b, sb_bits[i], lb);
    }
    for (long t = 0; t < tail_bits; t++)
        putbit(&b, (tail[t >> 3] >> (t & 7)) & 1);
    if (b.err)
        return -1;
    *bitlen_out = b.pos;
    return 0;
}

/* All lanes in one call, straight from the device's row-major (W, L)
 * segment arrays: lanes are processed in tiles of PACK_TILE so each
 * step row's tile slice (contiguous in memory) is touched once — no
 * host-side transposed copy of the ~35 MB of segment data, and one
 * ctypes crossing instead of L. Per-lane output regions (out + offs,
 * 8-byte aligned, zeroed, caps include word-write headroom) and tail
 * bits are caller-provided; bitlens[lane] gets the payload bit count.
 */
#define PACK_TILE 32

long wvpk_pack_lanes_all(const uint64_t *sa_lo, const uint64_t *sa_hi,
                         const int32_t *sa_len, const uint64_t *sb_bits,
                         const int32_t *sb_len, long W, long L,
                         const uint8_t *tails, const int64_t *tail_offs,
                         const int32_t *tail_bits,
                         uint8_t *out, const int64_t *out_offs,
                         const int64_t *out_caps, int64_t *bitlens)
{
    bw_t bw[PACK_TILE];
    for (long lane0 = 0; lane0 < L; lane0 += PACK_TILE) {
        int tl = (int)(L - lane0 < PACK_TILE ? L - lane0 : PACK_TILE);
        for (int k = 0; k < tl; k++) {
            bw[k].buf = out + out_offs[lane0 + k];
            bw[k].cap_bits = (out_caps[lane0 + k] - 8) * 8;
            bw[k].pos = 0;
            bw[k].err = 0;
        }
        for (long i = 0; i < W; i++) {
            const long row = i * L + lane0;
            for (int k = 0; k < tl; k++) {
                int la = sa_len[row + k];
                if (la > 0) {
                    append_bits(&bw[k], sa_lo[row + k],
                                la < 64 ? la : 64);
                    if (la > 64)
                        append_bits(&bw[k], sa_hi[row + k], la - 64);
                }
                int lb = sb_len[row + k];
                if (lb > 0)
                    append_bits(&bw[k], sb_bits[row + k], lb);
            }
        }
        for (int k = 0; k < tl; k++) {
            const uint8_t *tail = tails + tail_offs[lane0 + k];
            long tb = tail_bits[lane0 + k];
            for (long t = 0; t < tb; t++)
                putbit(&bw[k], (tail[t >> 3] >> (t & 7)) & 1);
            if (bw[k].err)
                return -(lane0 + k + 1);
            bitlens[lane0 + k] = bw[k].pos;
        }
    }
    return 0;
}

/* ---------------- DSD encode (modes 1 "fast" and 3 "high") ----------- */

/* C ports of the repo's own Python DSD stream encoders
 * (wvpk/testgen/dsd_encoder.py::_encode_fast_stream/_encode_high_stream),
 * which are the exact inverses of the reference decoders
 * (DsdUtils.cs:244-304 fast range decoder, :391-493 high arithmetic
 * decoder). The Python coders remain the differential oracle. */

static inline int32_t I32(int64_t v)
{
    return (int32_t)(uint32_t)(uint64_t)v;
}

/* Range-encode `codes` (interleaved byte-samples) over per-history-bin
 * probability tables. probs/summed are (bins, 256) int32 row-major;
 * summed is the inclusive prefix sum of probs. Returns 0 and *outlen
 * bytes in out; -1 on a degenerate table, -2 when cap is too small. */
long wvpk_dsd_encode_fast(const int32_t *codes, long n,
                          const int32_t *probs, const int32_t *summed,
                          int bins, int mono,
                          uint8_t *out, long cap, int64_t *outlen)
{
    uint32_t low = 0, high = 0xFFFFFFFFu;
    long w = 0;
    int p0 = 0, p1 = 0;
    for (long i = 0; i < n; i++) {
        int code = codes[i];
        int32_t total = summed[p0 * 256 + 255];
        if (total <= 0 || code < 0 || code > 255)
            return -1;
        uint32_t mult = (uint32_t)(high - low) / (uint32_t)total;
        if (mult == 0) {
            /* interval exhausted: the decoder reads 4 fresh bytes
             * (DsdUtils.cs:263-274); emit the position and reset */
            if (w + 4 > cap)
                return -2;
            high = low;
            for (int k = 0; k < 4; k++) {
                out[w++] = (uint8_t)(high >> 24);
                high <<= 8;
            }
            low = 0;
            high = 0xFFFFFFFFu;
            mult = high / (uint32_t)total;
        }
        if (code > 0)
            low += (uint32_t)summed[p0 * 256 + code - 1] * mult;
        high = low + (uint32_t)probs[p0 * 256 + code] * mult - 1;
        if (mono) {
            p0 = code & (bins - 1);
        } else {
            p0 = p1;
            p1 = code & (bins - 1);
        }
        while (((high ^ low) & 0xFF000000u) == 0) {
            if (w >= cap)
                return -2;
            out[w++] = (uint8_t)(high >> 24);
            high = (high << 8) | 0xFFu;
            low <<= 8;
        }
    }
    if (w + 4 > cap)
        return -2;
    high = low;                 /* flush: terminate with value == low */
    for (int k = 0; k < 4; k++) {
        out[w++] = (uint8_t)(high >> 24);
        high <<= 8;
    }
    *outlen = w;
    return 0;
}

#define DSD_PRECISION     20
#define DSD_PRECISION_USE 12
#define DSD_VALUE_ONE     (1 << DSD_PRECISION)
#define DSD_PTABLE_MASK   255
#define DSD_UP            0x010000FE
#define DSD_DOWN          0x00010000
#define DSD_DECAY         8

typedef struct {
    int32_t value, f0, f1, f2, f3, f4, f5, f6, factor;
} dsdf_t;

/* Arithmetic-encode `data` ((nframes, nch) interleaved byte-samples, 8
 * bits each MSB-first) with the adaptive ptable + 6-stage filter-bank
 * predictor (the inverse of DsdUtils.cs:391-493). filters_init is
 * (nch, 8) int32 with f1..f5 at slots 0..4 and factor at slot 6;
 * ptable_init is 256 int32. */
long wvpk_dsd_encode_high(const int32_t *data, long nframes, int nch,
                          const int32_t *filters_init,
                          const int32_t *ptable_init,
                          uint8_t *out, long cap, int64_t *outlen)
{
    uint32_t low = 0, high = 0xFFFFFFFFu;
    long w = 0;
    int32_t pt[256];
    dsdf_t f[2];
    if (nch < 1 || nch > 2)
        return -1;
    memcpy(pt, ptable_init, sizeof pt);
    for (int ch = 0; ch < nch; ch++) {
        f[ch].value = 0;
        f[ch].f0 = 0;
        f[ch].f1 = filters_init[ch * 8 + 0];
        f[ch].f2 = filters_init[ch * 8 + 1];
        f[ch].f3 = filters_init[ch * 8 + 2];
        f[ch].f4 = filters_init[ch * 8 + 3];
        f[ch].f5 = filters_init[ch * 8 + 4];
        f[ch].f6 = 0;
        f[ch].factor = filters_init[ch * 8 + 6];
    }
    for (long t = 0; t < nframes; t++) {
        for (int ch = 0; ch < nch; ch++)
            f[ch].value = I32((int64_t)f[ch].f1 - f[ch].f5
                + (I32((int64_t)f[ch].f6 * f[ch].factor) >> 2));
        for (int bi = 0; bi < 8; bi++) {
            for (int ch = 0; ch < nch; ch++) {
                dsdf_t *sp = &f[ch];
                int b = (data[t * nch + ch] >> (7 - bi)) & 1;
                int pp = (sp->value >> (DSD_PRECISION - DSD_PRECISION_USE))
                         & DSD_PTABLE_MASK;
                uint32_t split = low + ((uint32_t)(high - low) >> 8)
                                 * ((uint32_t)pt[pp] >> 16);
                if (b) {
                    high = split;
                    pt[pp] = I32((int64_t)pt[pp]
                        + (((int64_t)DSD_UP - pt[pp]) >> DSD_DECAY));
                    sp->f0 = -1;
                } else {
                    low = split + 1;
                    pt[pp] = I32((int64_t)pt[pp]
                        + (((int64_t)DSD_DOWN - pt[pp]) >> DSD_DECAY));
                    sp->f0 = 0;
                }
                while (((high ^ low) & 0xFF000000u) == 0) {
                    if (w >= cap)
                        return -2;
                    out[w++] = (uint8_t)(high >> 24);
                    high = (high << 8) | 0xFFu;
                    low <<= 8;
                }
                sp->value = I32((int64_t)sp->value
                                + I32((int64_t)sp->f6 * 8));
                {
                    int32_t v = sp->value;
                    int32_t vm = I32((int64_t)v - I32((int64_t)sp->f6 * 16));
                    sp->factor = I32((int64_t)sp->factor
                        + ((((int64_t)(v ^ sp->f0) >> 31) | 1)
                           & ((int64_t)(v ^ vm) >> 31)));
                }
                sp->f1 = I32((int64_t)sp->f1
                    + (((int64_t)(sp->f0 & DSD_VALUE_ONE) - sp->f1) >> 6));
                sp->f2 = I32((int64_t)sp->f2
                    + (((int64_t)(sp->f0 & DSD_VALUE_ONE) - sp->f2) >> 4));
                sp->f3 = I32((int64_t)sp->f3
                    + (((int64_t)sp->f2 - sp->f3) >> 4));
                sp->f4 = I32((int64_t)sp->f4
                    + (((int64_t)sp->f3 - sp->f4) >> 4));
                sp->value = (int32_t)(((int64_t)sp->f4 - sp->f5) >> 4);
                sp->f5 = I32((int64_t)sp->f5 + sp->value);
                sp->f6 = I32((int64_t)sp->f6
                    + (((int64_t)sp->value - sp->f6) >> 3));
                sp->value = I32((int64_t)sp->f1 - sp->f5
                    + (I32((int64_t)sp->f6 * sp->factor) >> 2));
            }
        }
        for (int ch = 0; ch < nch; ch++)
            f[ch].factor = I32((int64_t)f[ch].factor
                               - (((int64_t)f[ch].factor + 512) >> 10));
    }
    if (w + 4 > cap)
        return -2;
    high = low;
    for (int k = 0; k < 4; k++) {
        out[w++] = (uint8_t)(high >> 24);
        high <<= 8;
    }
    *outlen = w;
    return 0;
}

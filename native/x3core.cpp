// x3core — native host-side X3 codec core.
//
// The reference implementation's entire runtime is native (Rust, see
// /root/reference/src/encoder.rs, decoder.rs, bitpacker.rs, bitreader.rs,
// crc.rs).  This C++ core is the framework's host-side equivalent: a
// scalar encoder/decoder with the exact same on-the-wire format, used as
//   * the "native" engine for small/streaming workloads where a device
//     round-trip is not worth it,
//   * a fast differential-testing oracle for the JAX pipelines,
//   * the embedded-style fallback when no accelerator is present.
//
// Bit-exactness contract: identical output to the Python oracle
// (x3_tpu/models/oracle.py) and the Rust reference for every input.
//
// Build: make -C native   (produces libx3core.so; plain C ABI via ctypes)

#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__PCLMUL__) && defined(__SSSE3__)
#include <immintrin.h>
#define X3_HAVE_CLMUL 1
#endif

#if defined(__AVX512F__) && defined(__AVX512VBMI__) && defined(__AVX512BW__)
#define X3_SIMD_BFP 1
#include <immintrin.h>
// GCC 12 flags every unmasked AVX-512 intrinsic with a bogus
// -Wmaybe-uninitialized on the header's own `__m512i __Y = __Y;`
// undefined-passthrough idiom (GCC PR105593); silence that class here.
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"

// Per-(nb, bit-phase) vector constants for the 16-lane BFP extract: lane i
// reads the big-endian 32-bit window at byte (phase + i*nb)>>3 of a 64-byte
// block load (vpermb builds the window AND byte-swaps in one permute), then
// shifts the field to the bottom.  Within a block the phase is constant
// across iterations because 16*nb is a whole number of bytes.
struct BfpTab {
    alignas(64) uint8_t idx[64];
    alignas(64) uint32_t lsh[16];
};
static BfpTab BFP_TAB[10][8];  // [nb-6][start bit & 7]

// multishift control for the unary LUT's 12-nibble expand: byte lane i of
// qword q extracts the 8 bits of the (broadcast) nibble word starting at
// bit UNIB_CTRL[8q+i]; lanes 0..11 cover nibbles 0..11, the rest are junk
// masked out of the store.
alignas(64) static const uint8_t UNIB_CTRL[64] = {
    0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 0, 0, 0, 0,
};

// BFP ENCODE pack tables: the inverse of BfpTab.  A 16-field group at
// width w (= nb+1, 7..14) spans 16w bits; 16w = 0 mod 8 keeps the bit
// phase invariant across groups, so output byte j is a pure function of
// (w, phase): it draws from at most TWO fields a0(j), a0(j)+1 (w >= 7
// leaves <= 2 contributors per byte) as
//   byte j = ((v[a0] << w | v[a0+1]) >> sh(j)) & 0xff
// with sh(j) = 2w - 8 - 8j + phase + a0*w.  Lanes 0-15 / 16-31 live in
// two 16-lane int32 registers.  Bits of byte 0 below the phase and bits
// past field 15 read ZERO (masked second permute), so the caller ORs the
// pending accumulator bits into byte 0 and takes the trailing phase bits
// straight from field 15.
struct BfpPackTab {
    alignas(64) int32_t ia[32];   // a0 per byte lane
    alignas(64) int32_t ib[32];   // a0+1 (clamped; zeroed via mb)
    alignas(64) int32_t sh[32];   // right shift per byte lane
    uint32_t mb;                  // lane mask: a0+1 is a real field
};
static BfpPackTab BFPP_TAB[8][8];  // [w-7][phase]

static void bfpp_tab_init() {
    for (int w = 7; w <= 14; w++)
        for (int ph = 0; ph < 8; ph++) {
            BfpPackTab* t = &BFPP_TAB[w - 7][ph];
            t->mb = 0;
            for (int j = 0; j < 32; j++) {
                if (j >= 2 * w) { t->ia[j] = 0; t->ib[j] = 0; t->sh[j] = 31; continue; }
                int a0 = (8 * j - ph) / w;
                if (8 * j < ph) a0 = 0;
                if (a0 > 15) a0 = 15;
                t->ia[j] = a0;
                int a1 = a0 + 1;
                if (a1 <= 15) { t->ib[j] = a1; t->mb |= 1u << j; } else t->ib[j] = 0;
                t->sh[j] = 2 * w - 8 - 8 * j + ph + a0 * w;
            }
        }
}

static void bfp_tab_init() {
    for (int nb = 6; nb <= 15; nb++)
        for (int ph = 0; ph < 8; ph++) {
            BfpTab* t = &BFP_TAB[nb - 6][ph];
            for (int i = 0; i < 16; i++) {
                int bo = ph + i * nb;
                int byr = bo >> 3;
                for (int j = 0; j < 4; j++)  // lane byte 3-j (MSB first) = data byte byr+j
                    t->idx[4 * i + (3 - j)] = (uint8_t)(byr + j);
                t->lsh[i] = (uint32_t)(bo & 7);
            }
        }
}
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC-16/CCITT, poly 0x1021, init 0xffff, MSB-first (crc.rs:22-58)
// ---------------------------------------------------------------------------

static uint16_t CRC_TABLE[256];
// Slice-by-8 tables: CRC_SLICE[k][x] is table T[x] advanced by k zero bytes
// (CRC tables are GF(2)-linear, so 8 bytes fold with 8 independent lookups).
static uint16_t CRC_SLICE[8][256];
static uint16_t CRC_FOLD_K[4];  // x^128, x^192, x^512, x^576 mod P (clmul folds)
static bool crc_init_done = false;

static uint16_t crc16_xpow_mod(int n) {
    uint32_t v = 1;  // x^0
    for (int i = 0; i < n; i++) {
        v <<= 1;
        if (v & 0x10000) v ^= 0x11021;
    }
    return (uint16_t)v;
}

static void crc_init() {
    if (crc_init_done) return;
    CRC_FOLD_K[0] = crc16_xpow_mod(128);
    CRC_FOLD_K[1] = crc16_xpow_mod(192);
    CRC_FOLD_K[2] = crc16_xpow_mod(512);
    CRC_FOLD_K[3] = crc16_xpow_mod(576);
    for (int i = 0; i < 256; i++) {
        uint16_t crc = (uint16_t)(i << 8);
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x1021) : (uint16_t)(crc << 1);
        CRC_TABLE[i] = crc;
    }
    for (int i = 0; i < 256; i++) CRC_SLICE[0][i] = CRC_TABLE[i];
    for (int k = 1; k < 8; k++)
        for (int i = 0; i < 256; i++) {
            uint16_t c = CRC_SLICE[k - 1][i];
            CRC_SLICE[k][i] = (uint16_t)((c << 8) ^ CRC_TABLE[c >> 8]);
        }
#if X3_SIMD_BFP
    bfp_tab_init();
    bfpp_tab_init();
#endif
    crc_init_done = true;
}

static inline uint16_t crc16_table(uint16_t crc, const uint8_t* data, int64_t len) {
    int64_t i = 0;
    // Slice-by-8 main loop: the state only folds into the first two bytes.
    for (; i + 8 <= len; i += 8) {
        crc = (uint16_t)(CRC_SLICE[7][(uint8_t)(data[i] ^ (crc >> 8))] ^
                         CRC_SLICE[6][(uint8_t)(data[i + 1] ^ crc)] ^
                         CRC_SLICE[5][data[i + 2]] ^ CRC_SLICE[4][data[i + 3]] ^
                         CRC_SLICE[3][data[i + 4]] ^ CRC_SLICE[2][data[i + 5]] ^
                         CRC_SLICE[1][data[i + 6]] ^ CRC_SLICE[0][data[i + 7]]);
    }
    for (; i < len; i++)
        crc = (uint16_t)((crc << 8) ^ CRC_TABLE[(uint8_t)(data[i] ^ (crc >> 8))]);
    return crc;
}

#ifdef X3_HAVE_CLMUL
// Carry-less-multiply folding CRC (Intel PCLMULQDQ technique, adapted to a
// degree-16 polynomial).  The message is a GF(2) polynomial, MSB-first;
// 128-bit accumulators hold unreduced partial products (bit i = coeff of
// x^i, so registers are byte-REVERSED on load).  One fold step computes
//   acc*x^D + next  ==  clmul(acc_hi, x^(D+64) mod P)
//                     ^ clmul(acc_lo, x^D mod P) ^ next   (mod P)
// with D = 512 (four interleaved lanes, 64 bytes/iter, hides the ~7-cycle
// clmul latency) then D = 128 (lane merge + tail blocks).  The <=16-bit
// fold constants are computed at init (x^N mod P), not hardcoded.  The
// final 128-bit value A is finished exactly: the answer is x^16*A mod P,
// which IS the table-CRC (init 0) of A's 16 bytes, then the byte tail
// continues through the table path.  Bit-identical to crc16_table.
static inline __m128i crc16_ldrev(const uint8_t* p, __m128i rev) {
    return _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)p), rev);
}

static inline __m128i crc16_fold(__m128i acc, __m128i next, __m128i k) {
    __m128i h = _mm_clmulepi64_si128(acc, k, 0x11);  // acc_hi * x^(D+64) mod P
    __m128i l = _mm_clmulepi64_si128(acc, k, 0x00);  // acc_lo * x^D     mod P
    return _mm_xor_si128(_mm_xor_si128(h, l), next);
}

static uint16_t crc16_clmul(const uint8_t* data, int64_t len) {
    const __m128i REV = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    const __m128i K512 = _mm_set_epi64x((int64_t)CRC_FOLD_K[3], (int64_t)CRC_FOLD_K[2]);
    const __m128i K128 = _mm_set_epi64x((int64_t)CRC_FOLD_K[1], (int64_t)CRC_FOLD_K[0]);
    __m128i a0 = crc16_ldrev(data, REV);
    __m128i a1 = crc16_ldrev(data + 16, REV);
    __m128i a2 = crc16_ldrev(data + 32, REV);
    __m128i a3 = crc16_ldrev(data + 48, REV);
    // init 0xffff = complement of the first 16 message bits (reg bits 112..127)
    a0 = _mm_xor_si128(a0, _mm_set_epi64x((int64_t)0xffff000000000000ULL, 0));
    int64_t i = 64;
    for (; i + 64 <= len; i += 64) {
        a0 = crc16_fold(a0, crc16_ldrev(data + i, REV), K512);
        a1 = crc16_fold(a1, crc16_ldrev(data + i + 16, REV), K512);
        a2 = crc16_fold(a2, crc16_ldrev(data + i + 32, REV), K512);
        a3 = crc16_fold(a3, crc16_ldrev(data + i + 48, REV), K512);
    }
    // merge lanes: message == ((a0*x^128 ^ a1)*x^128 ^ a2)*x^128 ^ a3 (mod P)
    __m128i acc = crc16_fold(a0, a1, K128);
    acc = crc16_fold(acc, a2, K128);
    acc = crc16_fold(acc, a3, K128);
    for (; i + 16 <= len; i += 16) acc = crc16_fold(acc, crc16_ldrev(data + i, REV), K128);
    uint8_t tmp[16];
    _mm_storeu_si128((__m128i*)tmp, _mm_shuffle_epi8(acc, REV));
    uint16_t crc = crc16_table(0, tmp, 16);  // = x^16 * acc mod P, exactly
    return crc16_table(crc, data + i, len - i);
}
#endif  // X3_HAVE_CLMUL

uint16_t x3_crc16(const uint8_t* data, int64_t len) {
    crc_init();
#ifdef X3_HAVE_CLMUL
    if (len >= 64) return crc16_clmul(data, len);
#endif
    return crc16_table(0xffff, data, len);
}

// ---------------------------------------------------------------------------
// Parameters (x3.rs:81-134).  Rice codes are computed in closed form — the
// same identities the device kernel uses (see ops/encode_kernel.py).
// ---------------------------------------------------------------------------

struct X3Params {
    int32_t block_len;
    int32_t blocks_per_frame;
    int32_t codes[3];       // rice orders, default {0, 1, 3}
    int32_t thresholds[3];  // default {3, 8, 20}
};

static inline void rice_closed_form(int32_t d, int32_t order, uint32_t* code, int32_t* bits) {
    if (order == 0) {
        *code = 1;
        *bits = 2 * (d < 0 ? -d : d) + (d >= 0 ? 1 : 0);
        return;
    }
    int32_t k = order;
    int32_t e = d >= 0 ? d : -d - 1;
    *bits = (k + 1) + (e >> (k - 1));
    int32_t low = (d & ((1 << (k - 1)) - 1)) << 1;
    *code = d >= 0 ? (uint32_t)((1 << k) | low) : (uint32_t)(((1 << (k + 1)) - 1) - low);
}

// ---------------------------------------------------------------------------
// Bit writer (bitpacker.rs semantics: MSB-first, running CRC over bytes)
// ---------------------------------------------------------------------------

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t len;     // flushed bytes
    uint64_t acc;    // bit accumulator, MSB-aligned within acc_bits
    int32_t acc_bits;
    bool overflow;
};

static inline void bw_init(BitWriter* bw, uint8_t* out, int64_t cap) {
    bw->out = out; bw->cap = cap; bw->len = 0; bw->acc = 0; bw->acc_bits = 0;
    bw->overflow = false;
}

// The payload CRC is computed once over the finished bytes with the
// slice-by-8 x3_crc16 instead of per flushed byte — same result
// (bitpacker.rs's running CRC equals CRC of the flushed stream).
static inline void bw_flush_bytes(BitWriter* bw) {
    while (bw->acc_bits >= 32 && bw->len + 4 <= bw->cap) {  // word-at-a-time
        uint32_t w = __builtin_bswap32((uint32_t)(bw->acc >> (bw->acc_bits - 32)));
        memcpy(bw->out + bw->len, &w, 4);
        bw->len += 4;
        bw->acc_bits -= 32;
    }
    while (bw->acc_bits >= 8) {  // near-cap / tail path
        if (bw->len >= bw->cap) { bw->overflow = true; return; }
        bw->out[bw->len++] = (uint8_t)(bw->acc >> (bw->acc_bits - 8));
        bw->acc_bits -= 8;
    }
    bw->acc &= (bw->acc_bits ? ((1ULL << bw->acc_bits) - 1) : 0);
}

static inline void bw_bits(BitWriter* bw, uint32_t value, int32_t n) {
    if (bw->overflow) return;  // stop accumulating (acc_bits would overflow)
    value &= (n >= 32) ? 0xffffffffu : ((1u << n) - 1);
    bw->acc = (bw->acc << n) | value;
    bw->acc_bits += n;
    bw_flush_bytes(bw);
}

// Capacity-unchecked emit: callers prove up front that the whole frame's
// worst-case payload (+8 bytes of store slack) fits (see encode_frame), so
// the hot path carries no per-word bounds tests.  Contract: `value` has no
// bits above `n` (all call sites build exact-width codes), n <= 56, and the
// accumulator always holds <= 7 bits between calls — every call drains to
// byte granularity with ONE unconditional 8-byte store (bytes past the
// true length are scratch, overwritten by the next call or ignored), which
// is what lets FOUR codes (any code <= 16 bits) land in a single call.
// Bit-identical to a bw_bits sequence.
static inline void bw_bits_fast(BitWriter* bw, uint64_t value, int32_t n) {
    bw->acc = (bw->acc << n) | value;  // <= 7 + 56 bits: never overflows
    bw->acc_bits += n;
    uint64_t w = __builtin_bswap64(bw->acc << ((64 - bw->acc_bits) & 63));
    memcpy(bw->out + bw->len, &w, 8);
    bw->len += bw->acc_bits >> 3;
    bw->acc_bits &= 7;
    bw->acc &= (1ULL << bw->acc_bits) - 1;
}

static inline void bw_word_align(BitWriter* bw, int64_t base) {
    // Pad to the next BYTE boundary, drain, then pad to the 2-byte stream
    // position.  (Both emit paths now drain to < 8 buffered bits, but this
    // stays correct for any acc_bits.)
    int32_t r = bw->acc_bits & 7;
    if (r) bw_bits(bw, 0, 8 - r);
    bw_flush_bytes(bw);
    while (!bw->overflow && (base + bw->len) % 2 != 0) bw_bits(bw, 0, 8);
}

// ---------------------------------------------------------------------------
// Encoder (encoder.rs:175-315)
// ---------------------------------------------------------------------------

static void write_frame_header(uint8_t* h, int32_t num_samples, uint8_t id,
                               int32_t payload_len, uint16_t payload_crc) {
    memset(h, 0, 20);
    h[0] = 0x78; h[1] = 0x33;
    h[2] = id; h[3] = id;  // channels byte quirk (encoder.rs:130-138)
    h[4] = (uint8_t)(num_samples >> 8); h[5] = (uint8_t)num_samples;
    h[6] = (uint8_t)(payload_len >> 8); h[7] = (uint8_t)payload_len;
    uint16_t hc = x3_crc16(h, 16);
    h[16] = (uint8_t)(hc >> 8); h[17] = (uint8_t)hc;
    h[18] = (uint8_t)(payload_crc >> 8); h[19] = (uint8_t)payload_crc;
}

// Encode one frame (header + payload) at out; returns bytes written or -1.
//
// Hot-loop structure (round 3): diffs are computed ONCE per block into a
// stack buffer, per-sample (code, bits) are precomputed in branchless
// passes the compiler auto-vectorizes, and items are emitted to the bit
// writer in QUADS on the capacity-proven path (PAIRS on the checked one) —
// a single code never exceeds 16 bits (Rice <= offset-bounded 13 bits with
// valid Parameters, BFP <= 15, literal 16), so two codes always fit a
// 32-bit emit and four codes almost always fit the 56-bit fast emit.
// MSB-first concatenation (a << bits_b) | b is bit-identical to emitting
// a then b.
#define X3_MAX_BLOCK 60  // Parameters::MAX_BLOCK_LENGTH (x3.rs:96)

}  // extern "C" (templates below need C++ linkage; all are static)

template <bool FAST>
static inline void bw_emit(BitWriter* bw, uint32_t value, int32_t n) {
    if (FAST) bw_bits_fast(bw, value, n);
    else bw_bits(bw, value, n);
}

template <bool FAST>
static void encode_frame_blocks(const int16_t* wav, int32_t n, const X3Params* p,
                                BitWriter* bwp, int64_t* stats) {
    BitWriter& bw = *bwp;
    int32_t dbuf[X3_MAX_BLOCK];
    uint32_t cbuf[X3_MAX_BLOCK];
    int32_t bbuf[X3_MAX_BLOCK];
    int32_t bl = p->block_len;
    for (int32_t start = 1; start < n && !bw.overflow; start += bl) {
        int32_t len = (n - start) < bl ? (n - start) : bl;
        const int16_t* w = wav + start;
        // block diffs + max |diff| (one pass, vectorized)
        int32_t max_abs = 0;
        for (int32_t i = 0; i < len; i++) {
            int32_t d = (int32_t)w[i] - (int32_t)w[i - 1];
            dbuf[i] = d;
            int32_t a = d < 0 ? -d : d;
            max_abs = a > max_abs ? a : max_abs;
        }
        if (max_abs <= p->thresholds[2]) {
            int32_t ftype = (max_abs > p->thresholds[0]) + (max_abs > p->thresholds[1]);
            int32_t order = p->codes[ftype];
            if (order == 0) {
                for (int32_t i = 0; i < len; i++) {
                    int32_t d = dbuf[i];
                    cbuf[i] = 1;
                    bbuf[i] = 2 * (d < 0 ? -d : d) + (d >= 0 ? 1 : 0);
                }
            } else {
                int32_t k = order;
                for (int32_t i = 0; i < len; i++) {
                    int32_t d = dbuf[i];
                    int32_t e = d >= 0 ? d : -d - 1;
                    bbuf[i] = (k + 1) + (e >> (k - 1));
                    int32_t low = (d & ((1 << (k - 1)) - 1)) << 1;
                    cbuf[i] = d >= 0 ? (uint32_t)((1 << k) | low)
                                     : (uint32_t)(((1 << (k + 1)) - 1) - low);
                }
            }
            bw_emit<FAST>(&bw, (uint32_t)(ftype + 1), 2);
            int32_t i = 0;
            if (FAST) {  // quads: 4 codes almost always fit one 56-bit emit
                for (; i + 4 <= len; i += 4) {
                    uint32_t ca = (cbuf[i] << bbuf[i + 1]) | cbuf[i + 1];
                    int32_t ba = bbuf[i] + bbuf[i + 1];
                    uint32_t cb = (cbuf[i + 2] << bbuf[i + 3]) | cbuf[i + 3];
                    int32_t bb = bbuf[i + 2] + bbuf[i + 3];
                    if (ba + bb <= 56) {
                        bw_bits_fast(&bw, ((uint64_t)ca << bb) | cb, ba + bb);
                    } else {
                        bw_bits_fast(&bw, ca, ba);
                        bw_bits_fast(&bw, cb, bb);
                    }
                }
            }
            for (; i + 2 <= len; i += 2)
                bw_emit<FAST>(&bw, (cbuf[i] << bbuf[i + 1]) | cbuf[i + 1], bbuf[i] + bbuf[i + 1]);
            if (i < len) bw_emit<FAST>(&bw, cbuf[i], bbuf[i]);
            // statistics slot = nsubs of the code, which equals its order
            if (stats) stats[order] += len;
        } else {
            int32_t nb = 0;
            for (uint32_t v = (uint32_t)max_abs; v; v >>= 1) nb++;
            if (nb >= 15) {  // pass-through: raw samples (encoder.rs:278-285)
                bw_emit<FAST>(&bw, 15, 6);
                int32_t i = 0;
                for (; i + 2 <= len; i += 2)
                    bw_emit<FAST>(&bw, ((uint32_t)(uint16_t)w[i] << 16) | (uint16_t)w[i + 1], 32);
                if (i < len) bw_emit<FAST>(&bw, (uint16_t)w[i], 16);
                if (stats) stats[5] += len;
            } else {  // BFP: nb+1 bits per diff (encoder.rs:269-276)
                bw_emit<FAST>(&bw, (uint32_t)nb, 6);
                uint32_t mask = (1u << (nb + 1)) - 1;
                int32_t i = 0;
#if X3_SIMD_BFP
                if (FAST && nb >= 6 && nb <= 13 && len >= 16) {
                    // Vector pack: 16 fields -> 2w output bytes per group
                    // (bit-identical to the quad emission).  bw_bits_fast
                    // leaves acc_bits <= 7, so the group phase is acc_bits
                    // and stays invariant (16w = 0 mod 8).
                    int32_t w1 = nb + 1;
                    int32_t phi = bw.acc_bits;
                    const BfpPackTab* t = &BFPP_TAB[w1 - 7][phi];
                    __m512i ia0 = _mm512_load_si512((const void*)t->ia);
                    __m512i ia1 = _mm512_load_si512((const void*)(t->ia + 16));
                    __m512i ib0 = _mm512_load_si512((const void*)t->ib);
                    __m512i ib1 = _mm512_load_si512((const void*)(t->ib + 16));
                    __m512i sh0 = _mm512_load_si512((const void*)t->sh);
                    __m512i sh1 = _mm512_load_si512((const void*)(t->sh + 16));
                    __mmask16 mb0 = (__mmask16)t->mb, mb1 = (__mmask16)(t->mb >> 16);
                    __m512i vw = _mm512_set1_epi32(w1);
                    __m512i vmask = _mm512_set1_epi32((int32_t)mask);
                    __mmask16 st0 = 2 * w1 >= 16 ? (__mmask16)0xffff
                                                 : (__mmask16)((1u << (2 * w1)) - 1);
                    __mmask16 st1 = 2 * w1 > 16 ? (__mmask16)((1u << (2 * w1 - 16)) - 1)
                                                : (__mmask16)0;
                    uint32_t carry = (uint32_t)(bw.acc & ((phi ? (1ULL << phi) : 1ULL) - 1));
                    for (; i + 16 <= len; i += 16) {
                        __m512i v = _mm512_and_si512(
                            _mm512_loadu_si512((const void*)(dbuf + i)), vmask);
                        __m512i p0 = _mm512_or_si512(
                            _mm512_sllv_epi32(_mm512_permutexvar_epi32(ia0, v), vw),
                            _mm512_maskz_permutexvar_epi32(mb0, ib0, v));
                        __m512i b0 = _mm512_srlv_epi32(p0, sh0);
                        _mm512_mask_cvtepi32_storeu_epi8((void*)(bw.out + bw.len), st0, b0);
                        if (st1) {
                            __m512i p1 = _mm512_or_si512(
                                _mm512_sllv_epi32(_mm512_permutexvar_epi32(ia1, v), vw),
                                _mm512_maskz_permutexvar_epi32(mb1, ib1, v));
                            __m512i b1 = _mm512_srlv_epi32(p1, sh1);
                            _mm512_mask_cvtepi32_storeu_epi8(
                                (void*)(bw.out + bw.len + 16), st1, b1);
                        }
                        if (phi) bw.out[bw.len] |= (uint8_t)(carry << (8 - phi));
                        carry = (uint32_t)dbuf[i + 15] & ((phi ? (1u << phi) : 1u) - 1);
                        bw.len += 2 * w1;
                    }
                    bw.acc = carry;  // acc_bits stays phi
                }
#endif
                if (FAST && nb <= 13) {  // 4*(nb+1) <= 56: quad emission
                    int32_t w1 = nb + 1;
                    for (; i + 4 <= len; i += 4) {
                        uint64_t q = ((uint64_t)((uint32_t)dbuf[i] & mask) << (3 * w1)) |
                                     ((uint64_t)((uint32_t)dbuf[i + 1] & mask) << (2 * w1)) |
                                     ((uint64_t)((uint32_t)dbuf[i + 2] & mask) << w1) |
                                     ((uint32_t)dbuf[i + 3] & mask);
                        bw_bits_fast(&bw, q, 4 * w1);
                    }
                }
                for (; i + 2 <= len; i += 2)
                    bw_emit<FAST>(&bw, (((uint32_t)dbuf[i] & mask) << (nb + 1)) | ((uint32_t)dbuf[i + 1] & mask),
                            2 * (nb + 1));
                if (i < len) bw_emit<FAST>(&bw, (uint32_t)dbuf[i] & mask, nb + 1);
                if (stats) stats[4] += len;
            }
        }
    }
}

extern "C" {

static int64_t encode_frame(const int16_t* wav, int32_t n, const X3Params* p,
                            uint8_t* out, int64_t cap, int64_t* stats) {
    if (cap < 20 || p->block_len > X3_MAX_BLOCK) return -1;
    BitWriter bw;
    bw_init(&bw, out + 20, cap - 20);
    bw_bits(&bw, (uint16_t)wav[0], 16);
    // Worst-case payload bytes: 2 (first sample) + per block 6 header bits
    // + 16 bits/sample, plus word-align slack.  When the output buffer
    // provably holds it, the capacity-unchecked emit path runs.
    int32_t bl = p->block_len;
    int64_t nblocks = (n - 1 + bl - 1) / bl;
    int64_t bound = 4 + (16 + nblocks * 6 + (int64_t)(n - 1) * 16 + 7) / 8;
    // +8: the fast emitter's unconditional 8-byte store may scribble past
    // the current length; those scratch bytes never exceed bound + 8.
    if (cap - 20 >= bound + 8)
        encode_frame_blocks<true>(wav, n, p, &bw, stats);
    else
        encode_frame_blocks<false>(wav, n, p, &bw, stats);
    bw_word_align(&bw, 0);
    if (bw.overflow) return -1;
    write_frame_header(out, n, 1, (int32_t)bw.len, x3_crc16(out + 20, bw.len));
    return 20 + bw.len;
}

// Encode a whole stream into frames.  Returns bytes written, or -1 on error.
int64_t x3_encode(const int16_t* samples, int64_t n, const X3Params* params,
                  uint8_t* out, int64_t cap, int64_t* stats6) {
    crc_init();
    int64_t spf = (int64_t)params->block_len * params->blocks_per_frame;
    int64_t pos = 0;
    for (int64_t start = 0; start < n; start += spf) {
        int32_t fn = (int32_t)((n - start) < spf ? (n - start) : spf);
        int64_t wrote = encode_frame(samples + start, fn, params, out + pos, cap - pos, stats6);
        if (wrote < 0) return -1;
        pos += wrote;
    }
    return pos;
}

// Multithreaded stream encode: frames are self-contained, so threads take
// contiguous frame ranges into thread-local buffers which are concatenated
// in order.  Output is byte-identical to x3_encode (the reference runtime is
// single-threaded; this is the framework's host-side scale-up).
int64_t x3_encode_mt(const int16_t* samples, int64_t n, const X3Params* params,
                     uint8_t* out, int64_t cap, int64_t* stats6, int32_t nthreads) {
    crc_init();
    int64_t spf = (int64_t)params->block_len * params->blocks_per_frame;
    int64_t n_frames = n > 0 ? (n + spf - 1) / spf : 0;
    if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if ((int64_t)nthreads > n_frames) nthreads = (int32_t)(n_frames ? n_frames : 1);
    if (nthreads == 1) return x3_encode(samples, n, params, out, cap, stats6);

    struct Part {
        std::vector<uint8_t> buf;
        int64_t stats[6] = {0, 0, 0, 0, 0, 0};
        int64_t wrote = 0;
        bool failed = false;
    };
    std::vector<Part> parts(nthreads);
    int64_t frames_per = (n_frames + nthreads - 1) / nthreads;

    auto work = [&](int32_t t) {
        Part& p = parts[t];
        int64_t f0 = (int64_t)t * frames_per;
        int64_t f1 = f0 + frames_per < n_frames ? f0 + frames_per : n_frames;
        if (f0 >= f1) return;
        // Worst case (incompressible): 2 bytes/sample payload, a 6-bit
        // header per block, and per-frame header/align overhead.
        p.buf.resize((size_t)((f1 - f0) * (spf * 2 + spf / params->block_len + 128)));
        int64_t pos = 0;
        for (int64_t f = f0; f < f1; f++) {
            int64_t start = f * spf;
            int32_t fn = (int32_t)((n - start) < spf ? (n - start) : spf);
            int64_t wrote = encode_frame(samples + start, fn, params,
                                         p.buf.data() + pos, (int64_t)p.buf.size() - pos, p.stats);
            if (wrote < 0) { p.failed = true; return; }
            pos += wrote;
        }
        p.wrote = pos;
    };
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < nthreads; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();

    int64_t total = 0;
    for (auto& p : parts) {
        if (p.failed) return -1;
        total += p.wrote;
    }
    if (total > cap) return -1;
    int64_t pos = 0;
    for (auto& p : parts) {
        memcpy(out + pos, p.buf.data(), (size_t)p.wrote);
        pos += p.wrote;
        if (stats6)
            for (int i = 0; i < 6; i++) stats6[i] += p.stats[i];
    }
    return total;
}

// ---------------------------------------------------------------------------
// Decoder (decoder.rs:36-235; bitreader.rs semantics)
// ---------------------------------------------------------------------------

// 64-bit MSB-first bit reservoir: the next unread bit is always bit 63 of
// `cache`; bytes stream in on refill and reads past the data end return
// zeros, with unary zero runs capped at the data end exactly like the
// reference's BitReader tail handling (bitreader.rs:29-49, 129-139).
struct BitReader {
    const uint8_t* data;
    int64_t len;      // bytes
    int64_t pos;      // absolute bit position consumed so far
    uint64_t cache;   // left-aligned reservoir (next bit = bit 63)
    int32_t ncache;   // valid bits in cache
    int64_t bytepos;  // next byte to load
};

static inline void br_refill(BitReader* br) {
    if (br->ncache > 56) return;
    if (br->bytepos + 8 <= br->len) {
        // Bulk path: one 64-bit big-endian load appends every whole byte
        // that fits — identical cache contents to the byte loop.
        uint64_t w;
        memcpy(&w, br->data + br->bytepos, 8);
        w = __builtin_bswap64(w);
        int32_t bits = (64 - br->ncache) & ~7;
        br->cache |= (w >> (64 - bits)) << (64 - br->ncache - bits);
        br->bytepos += bits >> 3;
        br->ncache += bits;
        return;
    }
    while (br->ncache <= 56) {  // payload tail: zero fill past the end
        uint64_t b = (br->bytepos < br->len) ? br->data[br->bytepos] : 0;
        br->bytepos++;
        br->cache |= b << (56 - br->ncache);
        br->ncache += 8;
    }
}

static inline uint32_t br_nbits(BitReader* br, int32_t n) {  // 1 <= n <= 32
    // Only the top n cache bits are read, so refill only when they are not
    // all valid — the bulk refill then appends several bytes at once
    // instead of topping up one byte per read.
    if (br->ncache < n) br_refill(br);
    uint32_t r = (uint32_t)(br->cache >> (64 - n));
    br->cache <<= n;
    br->ncache -= n;
    br->pos += n;
    return r;
}

static inline void br_skip1(BitReader* br) {
    if (br->ncache < 1) br_refill(br);
    br->cache <<= 1;
    br->ncache -= 1;
    br->pos += 1;
}


static inline uint32_t ld32be(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return __builtin_bswap32(v);
}

// Reposition the reservoir at absolute bit b.  Callers guarantee b is in
// bounds (b < len*8 whenever b is not byte-aligned), so the partial lead
// byte always exists.
static inline void br_seek(BitReader* br, int64_t b) {
    br->pos = b;
    int32_t frac = (int32_t)(b & 7);
    int64_t byte = b >> 3;
    if (frac) {
        br->cache = (uint64_t)br->data[byte] << (56 + frac);
        br->ncache = 8 - frac;
        br->bytepos = byte + 1;
    } else {
        br->cache = 0;
        br->ncache = 0;
        br->bytepos = byte;
    }
}

static inline int32_t br_zeros(BitReader* br) {
    int64_t cap = br->len * 8 - br->pos;
    if (cap <= 0) return 0;
    int32_t c = 0;
    br_refill(br);
    while (br->cache == 0 && c < cap) {  // all-zero window: bulk-consume
        int32_t take = 57 <= cap - c ? 57 : (int32_t)(cap - c);
        br->ncache -= take;
        br->pos += take;
        c += take;
        br_refill(br);
    }
    int32_t z = br->cache ? __builtin_clzll(br->cache) : 0;
    if (c + z > cap) z = (int32_t)(cap - c);
    br->cache <<= z;
    br->ncache -= z;
    br->pos += z;
    return c + z;
}

// ---------------------------------------------------------------------------
// Multi-code decode LUTs: a W-bit peek of the reservoir decodes SEVERAL
// complete Rice codes per table lookup (classic multi-symbol Huffman
// decode), replacing the serial clz -> shift -> clz chain with one load
// plus register nibble extracts.  Entries hold only codes that are fully
// contained AND valid in the window; anything else (incomplete run, z past
// the table bound, negative idx) terminates the entry, so an invalid code
// is always re-seen as the FIRST code of a later lookup, where cnt==0
// routes to the exact scalar path that raises the proper error.  Tables
// are pure functions of (window bits, code geometry) — decode order and
// results are bit-identical to the scalar walk.
//
// Unary codes (ftype 1): 12-bit window, u64 entries
//   cnt(4) | bits(4) | up to 12 x 4-bit signed inv nibbles (z <= 11 in a
//   12-bit window -> inv in [-6, 6], fits a nibble).  4096 * 8 B = 32 KB.
// Suffix codes (ftype 2/3): 13-bit window, u32 entries
//   cnt(3) | bits(5) | up to 4 x 6-bit signed inv (inv_len <= 60 ->
//   inv in [-30, 30]) = exactly 32 bits.  8192 * 4 B = 32 KB per
//   (nbsuf, order) config — the window is deliberately L1-sized: each
//   lookup's address depends on the previous code's length, so the table
//   load is on the serial dependency chain and its LATENCY is the decode
//   cost.  A/B on this host (48 KB L1d): W=13 beats 16 (256 KB, L2
//   latency per peek) by ~8% on the hydrophone class and ~5% on music
//   despite holding fewer codes per window; W=14 (64 KB) loses again.

#define X3_ULUT_W 12
#define X3_SLUT_W 13

// cb[] duplicates each entry's chain-critical byte (cnt | used<<shift):
// the serial peek chain (index -> load -> length -> shift) then walks a
// dense 4/8 KB table instead of the full 32 KB entry array, cutting its
// L1 footprint 4-8x; the wide entries (invs/total) load OFF the chain.
struct UnaryLut { uint64_t e[1u << X3_ULUT_W]; uint8_t cb[1u << X3_ULUT_W]; };
struct SuffixLut { uint32_t e[1u << X3_SLUT_W]; uint8_t cb[1u << X3_SLUT_W]; };

static void build_unary_lut(UnaryLut* t, int32_t inv_len) {
    for (uint32_t k = 0; k < (1u << X3_ULUT_W); k++) {
        uint32_t win = k << (32 - X3_ULUT_W);  // left-aligned window
        int32_t used = 0, cnt = 0, tot = 0;
        uint64_t nibs = 0;
        while (used < X3_ULUT_W) {
            uint32_t rest = win << used;
            int32_t avail = X3_ULUT_W - used;
            int32_t z = rest ? __builtin_clz(rest) : 32;
            if (z >= avail) break;   // run continues past the window
            if (z >= inv_len) break; // invalid: leave as first code -> scalar -3
            int32_t inv = (z & 1) ? -((z + 1) >> 1) : (z >> 1);
            nibs |= (uint64_t)((uint32_t)inv & 15u) << (4 * cnt);
            tot += inv;
            used += z + 1;
            cnt++;
        }
        // total inv sum (int8, |tot| <= 6*12) in the spare top byte: the
        // vector emit updates the carry with ONE add off the peek chain.
        t->e[k] = (uint64_t)cnt | ((uint64_t)used << 4) | ((nibs & 0xffffffffffffULL) << 8) |
                  ((uint64_t)(uint8_t)(int8_t)tot << 56);
        t->cb[k] = (uint8_t)(cnt | (used << 4));
    }
}

static void build_suffix_lut(SuffixLut* t, int32_t nbsuf, int32_t level, int32_t inv_len) {
    int32_t zcap = (inv_len - 1) / level + 1;
    for (uint32_t k = 0; k < (1u << X3_SLUT_W); k++) {
        uint32_t win = k << (32 - X3_SLUT_W);
        int32_t used = 0, cnt = 0;
        uint32_t invs = 0;
        while (cnt < 4) {
            int32_t avail = X3_SLUT_W - used;
            if (avail <= 0) break;
            uint32_t rest = win << used;
            int32_t z = rest ? __builtin_clz(rest) : 32;
            if (z >= avail) break;  // run continues past the window
            if (z > zcap) break;    // invalid: scalar path raises -3
            // The stop bit is r's MSB (decoder.rs:180 hardwired-suffix
            // quirk): a code is z zeros + nbsuf bits, nothing in between.
            int32_t need = z + nbsuf;
            if (used + need > X3_SLUT_W) break;  // suffix incomplete
            uint32_t r = (uint32_t)(rest >> (32 - need)) & ((1u << nbsuf) - 1);
            int32_t idx = (int32_t)r + level * (z - 1);
            if (idx < 0 || idx >= inv_len) break;  // invalid: scalar -3
            int32_t inv = (idx & 1) ? -((idx + 1) >> 1) : (idx >> 1);
            invs |= ((uint32_t)inv & 63u) << (8 + 6 * cnt);
            used += need;
            cnt++;
        }
        t->e[k] = (uint32_t)cnt | ((uint32_t)used << 3) | invs;
        t->cb[k] = (uint8_t)(cnt | (used << 3));
    }
}

// Lazily built, thread-safe (decode_frames_mt calls from worker threads),
// keyed by the code geometry actually in use: unary by order (inv_len),
// suffix by (nbsuf in {2,4}, order in 0..3).
static const UnaryLut* unary_lut(int32_t order) {
    static UnaryLut* tabs[4];
    static std::once_flag flags[4];
    static const int32_t ilens[4] = {16, 26, 44, 60};
    std::call_once(flags[order], [order] {
        tabs[order] = new UnaryLut;
        build_unary_lut(tabs[order], ilens[order]);
    });
    return tabs[order];
}

static const SuffixLut* suffix_lut(int32_t nbsuf, int32_t order) {
    static SuffixLut* tabs[2][4];
    static std::once_flag flags[2][4];
    static const int32_t ilens[4] = {16, 26, 44, 60};
    int32_t ni = nbsuf == 4 ? 1 : 0;
    std::call_once(flags[ni][order], [ni, order, nbsuf] {
        tabs[ni][order] = new SuffixLut;
        build_suffix_lut(tabs[ni][order], nbsuf, 1 << order, ilens[order]);
    });
    return tabs[ni][order];
}

static inline int32_t sext6(uint32_t v) { return ((int32_t)(v & 63u) << 26) >> 26; }

// Decode one frame payload into wav.  Returns 0 on success, <0 error code.
int32_t x3_decode_frame(const uint8_t* payload, int64_t payload_len,
                        const X3Params* p, int32_t samples, int16_t* wav) {
    crc_init();
    if (payload_len < 2 || samples < 1) return -1;
    int16_t last = (int16_t)((payload[0] << 8) | payload[1]);
    wav[0] = last;
    BitReader br{payload + 2, payload_len - 2, 0, 0, 0, 0};
    int32_t done = 1;
    while (done < samples) {
        int32_t len = (samples - done) < p->block_len ? (samples - done) : p->block_len;
        uint32_t ftype = br_nbits(&br, 2);
        if (ftype == 0) {
            int32_t nb = (int32_t)br_nbits(&br, 4) + 1;
            if (nb <= 5) return -2;  // FrameDecodeInvalidBPF
            // Fixed-width bursts: refill once, then extract straight off the
            // reservoir with no per-sample refill branch.  Reads past the
            // data end see zero-fill, exactly br_nbits' semantics, so no
            // tail guard is needed; pos settles once per burst.
            // Direct-offset fast path: with a fixed field width, sample i's
            // bits start at the STATICALLY known offset pos + i*nb — every
            // extraction is an independent unaligned 32-bit load instead of
            // a serial shift chain through the reservoir (the reservoir
            // variant's `c <<= nb` dependency caps it at ~1 sample/cycle of
            // shift latency; independent loads run at memory-port ILP).
            // Taken only when every field AND its 4-byte window lie inside
            // the payload; the tail/zero-fill semantics keep the exact
            // reservoir loop below.
            if (((br.pos + (int64_t)(len - 1) * nb) >> 3) + 4 <= br.len) {
                const uint8_t* d = br.data;
                int64_t b = br.pos;
                if (nb == 16) {
                    for (int32_t i = 0; i < len; i++, b += 16) {
                        uint32_t v = ld32be(d + (b >> 3));
                        last = (int16_t)(uint16_t)((v << (b & 7)) >> 16);
                        wav[done + i] = last;
                    }
                } else {
                    int32_t half = 1 << (nb - 1), full = 1 << nb;
#if X3_SIMD_BFP
                    // 16-lane vector variant: one 64-byte load covers all 16
                    // fields (16*nb <= 240 bits); vpermb gathers each lane's
                    // big-endian window, variable shifts isolate the field,
                    // a masked subtract applies the asymmetric fold, and a
                    // log-step in-register prefix sum integrates the diffs
                    // (int32 partial sums truncated per lane = the scalar
                    // int16 wrap).  Needs every iteration's 64-byte load in
                    // bounds; otherwise the scalar direct-offset loop below.
                    int32_t iters = (len + 15) / 16;
                    int64_t lastbase = (b >> 3) + (int64_t)2 * nb * (iters - 1);
                    if (lastbase + 64 <= br.len) {
                        const BfpTab* t = &BFP_TAB[nb - 6][b & 7];
                        __m512i idx = _mm512_load_si512((const void*)t->idx);
                        __m512i lsh = _mm512_load_si512((const void*)t->lsh);
                        __m512i rsh = _mm512_set1_epi32(32 - nb);
                        __m512i vhalf = _mm512_set1_epi32(half);
                        __m512i vfull = _mm512_set1_epi32(full);
                        __m512i zero = _mm512_setzero_si512();
                        int32_t carry = last;
                        int64_t base = b >> 3;
                        for (int32_t i = 0; i < len; i += 16, base += 2 * nb) {
                            int32_t act = len - i >= 16 ? 16 : len - i;
                            __mmask16 m = (__mmask16)(act == 16 ? 0xffffu : (1u << act) - 1);
                            __m512i w = _mm512_loadu_si512((const void*)(d + base));
                            __m512i v = _mm512_permutexvar_epi8(idx, w);
                            v = _mm512_srlv_epi32(_mm512_sllv_epi32(v, lsh), rsh);
                            __mmask16 gt = _mm512_cmpgt_epi32_mask(v, vhalf);
                            v = _mm512_mask_sub_epi32(v, gt, v, vfull);
                            v = _mm512_maskz_mov_epi32(m, v);
                            v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 15));
                            v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 14));
                            v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 12));
                            v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 8));
                            v = _mm512_add_epi32(v, _mm512_set1_epi32(carry));
                            _mm512_mask_cvtepi32_storeu_epi16((void*)(wav + done + i), m, v);
                            if (act == 16) {
                                // full iteration: lane 15 straight from the
                                // register file — the spill/reload of the
                                // whole vector sat on the carry chain
                                carry = (int16_t)_mm_extract_epi32(
                                    _mm512_extracti32x4_epi32(v, 3), 3);
                            } else {
                                alignas(64) int32_t tmp[16];
                                _mm512_store_si512((void*)tmp, v);
                                carry = (int16_t)tmp[act - 1];
                            }
                        }
                        last = (int16_t)carry;
                        b += (int64_t)len * nb;
                    } else
#endif
                    for (int32_t i = 0; i < len; i++, b += nb) {
                        uint32_t v = ld32be(d + (b >> 3));
                        int32_t a = (int32_t)((v << (b & 7)) >> (32 - nb));
                        if (a > half) a -= full;  // asymmetric fold
                        last = (int16_t)(last + a);
                        wav[done + i] = last;
                    }
                }
                br_seek(&br, b);
            } else if (nb == 16) {
                int32_t i = 0;
                while (i < len) {
                    br_refill(&br);
                    uint64_t c = br.cache;
                    int32_t nc = br.ncache, n0 = nc;
                    while (i < len && nc >= 16) {
                        last = (int16_t)(c >> 48);
                        c <<= 16;
                        nc -= 16;
                        wav[done + i++] = last;
                    }
                    br.cache = c; br.ncache = nc; br.pos += n0 - nc;
                }
            } else {
                int32_t half = 1 << (nb - 1), full = 1 << nb;
                int32_t i = 0;
                while (i < len) {
                    br_refill(&br);
                    uint64_t c = br.cache;
                    int32_t nc = br.ncache, n0 = nc;
                    while (i < len && nc >= nb) {
                        int32_t a = (int32_t)(c >> (64 - nb));
                        c <<= nb;
                        nc -= nb;
                        if (a > half) a -= full;  // asymmetric fold
                        last = (int16_t)(last + a);
                        wav[done + i++] = last;
                    }
                    br.cache = c; br.ncache = nc; br.pos += n0 - nc;
                }
            }
        } else {
            int32_t order = p->codes[ftype - 1];
            // inv table closed form: inv(i) = i odd ? -(i+1)/2 : i/2
            int32_t inv_len;
            switch (order) {
                case 0: inv_len = 16; break;
                case 1: inv_len = 26; break;
                case 2: inv_len = 44; break;
                default: inv_len = 60; break;
            }
            // Unary-code bursts: in the stream interior every reservoir bit
            // is genuine payload (pos + ncache <= len*8), so the per-code
            // tail cap cannot engage and clz/shift consume is always valid
            // while the cache is nonzero — one refill serves a whole run of
            // codes with no guards, and pos settles once per burst.  The
            // payload tail and all-zero windows take the exact slow path
            // (br_zeros caps the run at the data end, bitreader.rs:129-139).
            if (ftype == 1) {
                const UnaryLut* ul = unary_lut(order);
                // Fast-loop guard: the LUT window AND one worst-case scalar
                // code must be fully cached (clz of the c|1 sentinel on an
                // all-zero valid region then reads z >= nc >= inv_len ->
                // the same -3 the exact path raises).
                int32_t uthresh = X3_ULUT_W > inv_len ? X3_ULUT_W : inv_len;
                int32_t i = 0;
                while (i < len) {
                    if (br.ncache <= 56) br_refill(&br);
                    if (br.pos + br.ncache <= br.len * 8 && br.ncache >= uthresh) {
                        uint64_t c = br.cache;
                        int32_t nc = br.ncache, n0 = nc;
                        while (i < len && nc >= uthresh) {
                            uint32_t uidx = (uint32_t)(c >> (64 - X3_ULUT_W));
                            uint32_t ucb = ul->cb[uidx];
                            uint64_t e = ul->e[uidx];
                            int32_t cnt = (int32_t)(ucb & 15);
                            if (!cnt) {  // first code spans past the window,
                                         // or is invalid: exact scalar decode
                                int32_t z = __builtin_clzll(c | 1);
                                if (z >= inv_len) return -3;  // OutOfBoundsInverse
                                c <<= z + 1;  // z+1 <= inv_len <= 60 < 64
                                nc -= z + 1;
                                int32_t inv = (z & 1) ? -((z + 1) >> 1) : (z >> 1);
                                last = (int16_t)(last + inv);
                                wav[done + i++] = last;
                                continue;
                            }
                            if (i + cnt > len) break;  // block tail: scalar below
                            int32_t bits = (int32_t)(ucb >> 4);
#if X3_SIMD_BFP
                            if (cnt >= 5 && i + 12 <= len) {
                                // Speculative 12-wide emit (cnt >= 5: short
                                // entries are cheaper through the nibble
                                // loop — the vector path costs ~4-5 scalar
                                // iterations of issue): expand the entry's
                                // nibbles (vpmultishiftqb on the broadcast
                                // word), sext4, log-step prefix sum, + carry,
                                // one masked store.  Lanes past cnt hold the
                                // zero nibbles the LUT build left, so their
                                // prefix stays at the carry value; they are
                                // inside [i, len) and rewritten later.  The
                                // carry update is ONE scalar add of the
                                // entry's precomputed total.
                                uint64_t nibs64 = (e >> 8) & 0xffffffffffffULL;
                                __m512i ms = _mm512_multishift_epi64_epi8(
                                    _mm512_load_si512((const void*)UNIB_CTRL),
                                    _mm512_set1_epi64((long long)nibs64));
                                __m512i v = _mm512_cvtepu8_epi32(_mm512_castsi512_si128(ms));
                                v = _mm512_srai_epi32(_mm512_slli_epi32(v, 28), 28);
                                __m512i zero = _mm512_setzero_si512();
                                v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 15));
                                v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 14));
                                v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 12));
                                v = _mm512_add_epi32(v, _mm512_alignr_epi32(v, zero, 8));
                                v = _mm512_add_epi32(v, _mm512_set1_epi32(last));
                                _mm512_mask_cvtepi32_storeu_epi16(
                                    (void*)(wav + done + i), (__mmask16)0x0fff, v);
                                last = (int16_t)(last + (int32_t)(int8_t)(uint8_t)(e >> 56));
                                i += cnt;
                                c <<= bits; nc -= bits;
                                continue;
                            }
#endif
                            uint64_t nib = e >> 8;
                            for (int32_t k = 0; k < cnt; k++) {
                                int32_t inv = ((int32_t)((uint32_t)nib & 15u) << 28) >> 28;
                                nib >>= 4;
                                last = (int16_t)(last + inv);
                                wav[done + i++] = last;
                            }
                            c <<= bits; nc -= bits;
                        }
                        // Block-tail codes (fewer than the entry holds):
                        // exact scalar burst off the same cached reservoir.
                        while (i < len && nc >= inv_len) {
                            int32_t z = __builtin_clzll(c | 1);
                            if (z >= inv_len) return -3;
                            c <<= z + 1;
                            nc -= z + 1;
                            int32_t inv = (z & 1) ? -((z + 1) >> 1) : (z >> 1);
                            last = (int16_t)(last + inv);
                            wav[done + i++] = last;
                        }
                        br.cache = c; br.ncache = nc; br.pos += n0 - nc;
                    } else {  // all-zero window / payload tail: exact slow path
                        int32_t z = br_zeros(&br);
                        br_skip1(&br);
                        if (z >= inv_len) return -3;
                        int32_t inv = (z & 1) ? -((z + 1) >> 1) : (z >> 1);
                        last = (int16_t)(last + inv);
                        wav[done + i++] = last;
                    }
                }
            } else {
                int32_t nbsuf = (ftype == 2) ? 2 : 4;  // decoder.rs:180 quirk
                int32_t level = 1 << order;            // 1 << nsubs
                // Any run longer than zcap makes idx = r + level*(z-1)
                // overrun the inverse table for every r >= 0, so z > zcap
                // is -3 without needing the exact run length; maxcode bounds
                // a whole legal code, so `nc >= maxcode` keeps every decode
                // fully cached and makes clz(c|1) safe (an all-zero valid
                // region reads as z >= nc >= maxcode > zcap -> same -3).
                int32_t zcap = (inv_len - 1) / level + 1;
                int32_t maxcode = zcap + nbsuf;
                uint32_t sufmask = (1u << nbsuf) - 1;
                const SuffixLut* sl = suffix_lut(nbsuf, order);
                // Guard covers the LUT window and one worst-case scalar code
                // (clz(c|1) on an all-zero valid region reads z >= nc >=
                // maxcode > zcap -> the same -3 the exact path raises).
                int32_t sthresh = X3_SLUT_W > maxcode ? X3_SLUT_W : maxcode;
                int32_t i = 0;
                while (i < len) {
                    if (br.ncache <= 56) br_refill(&br);
                    if (br.pos + br.ncache <= br.len * 8 && br.ncache >= sthresh) {
                        uint64_t c = br.cache;
                        int32_t nc = br.ncache, n0 = nc;
                        while (i < len && nc >= sthresh) {
                            uint32_t sidx = (uint32_t)(c >> (64 - X3_SLUT_W));
                            uint32_t scb = sl->cb[sidx];
                            uint32_t e = sl->e[sidx];
                            int32_t cnt = (int32_t)(scb & 7);
                            if (!cnt) {  // first code spans past the window,
                                         // or is invalid: exact scalar decode
                                int32_t z = __builtin_clzll(c | 1);
                                if (z > zcap) return -3;  // OutOfBoundsInverse
                                int32_t adv = z + nbsuf;
                                int32_t r = (int32_t)((c >> (64 - adv)) & sufmask);
                                c <<= adv;
                                nc -= adv;
                                int32_t idx = r + level * (z - 1);
                                if (idx < 0 || idx >= inv_len) return -3;
                                int32_t inv = (idx & 1) ? -((idx + 1) >> 1) : (idx >> 1);
                                last = (int16_t)(last + inv);
                                wav[done + i++] = last;
                                continue;
                            }
                            if (i + cnt > len) break;  // block tail: scalar below
                            int32_t bits = (int32_t)(scb >> 3);
                            uint32_t invs = e >> 8;
                            if (i + 4 <= len) {
                                // Speculative branchless 4-wide emit: compute
                                // and store all four prefix values in one
                                // 8-byte store (slots past cnt are garbage
                                // that later iterations rewrite), advance by
                                // cnt — kills the data-dependent loop-exit
                                // branch (A/B: hydro +14%, music +10%,
                                // pi240 +4%).  int16 truncation per step ==
                                // truncating the int32 prefix sums (addition
                                // is associative mod 2^16).
                                int32_t v0 = last + sext6(invs);
                                int32_t v1 = v0 + sext6(invs >> 6);
                                int32_t v2 = v1 + sext6(invs >> 12);
                                int32_t v3 = v2 + sext6(invs >> 18);
                                int16_t vs[4] = {(int16_t)v0, (int16_t)v1,
                                                 (int16_t)v2, (int16_t)v3};
                                memcpy(wav + done + i, vs, 8);
                                i += cnt;
                                last = vs[cnt - 1];
                            } else {
                                for (int32_t k = 0; k < cnt; k++) {
                                    last = (int16_t)(last + sext6(invs));
                                    invs >>= 6;
                                    wav[done + i++] = last;
                                }
                            }
                            c <<= bits; nc -= bits;
                        }
                        // Block-tail codes: exact scalar burst off the same
                        // cached reservoir.
                        while (i < len && nc >= maxcode) {
                            int32_t z = __builtin_clzll(c | 1);
                            if (z > zcap) return -3;
                            int32_t adv = z + nbsuf;
                            int32_t r = (int32_t)((c >> (64 - adv)) & sufmask);
                            c <<= adv;
                            nc -= adv;
                            int32_t idx = r + level * (z - 1);
                            if (idx < 0 || idx >= inv_len) return -3;
                            int32_t inv = (idx & 1) ? -((idx + 1) >> 1) : (idx >> 1);
                            last = (int16_t)(last + inv);
                            wav[done + i++] = last;
                        }
                        br.cache = c; br.ncache = nc; br.pos += n0 - nc;
                    } else {
                        int32_t z = br_zeros(&br);
                        int32_t r = (int32_t)br_nbits(&br, nbsuf);
                        int32_t idx = r + level * (z - 1);
                        if (idx < 0 || idx >= inv_len) return -3;
                        int32_t inv = (idx & 1) ? -((idx + 1) >> 1) : (idx >> 1);
                        last = (int16_t)(last + inv);
                        wav[done + i++] = last;
                    }
                }
            }
        }
        done += len;
    }
    return 0;
}

// Multithreaded frame-parallel decode: each frame's output position is the
// running sum of preceding frame sample counts, so threads write disjoint
// output ranges directly.  Returns 0, or the (negative) error code of the
// first failing frame; err_frame (if non-null) receives its index.
// expected_crcs (nullable): per-frame payload CRC16s verified in the same
// threaded pass (decodefile.rs:93-103); a mismatch returns -4.
int32_t x3_decode_frames_mt_crc(const uint8_t* data, const int64_t* payload_offsets,
                                const int32_t* samples, const int32_t* payload_lens,
                                const uint16_t* expected_crcs,
                                int64_t n_frames, const X3Params* params,
                                int16_t* wav_out, int64_t* err_frame, int32_t nthreads) {
    crc_init();
    std::vector<int64_t> out_pos((size_t)n_frames + 1, 0);
    for (int64_t i = 0; i < n_frames; i++) out_pos[(size_t)i + 1] = out_pos[(size_t)i] + samples[i];
    if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if ((int64_t)nthreads > n_frames) nthreads = (int32_t)(n_frames ? n_frames : 1);

    std::vector<int32_t> rcs(nthreads, 0);
    std::vector<int64_t> bad(nthreads, -1);
    int64_t frames_per = (n_frames + nthreads - 1) / nthreads;
    auto work = [&](int32_t t) {
        int64_t f0 = (int64_t)t * frames_per;
        int64_t f1 = f0 + frames_per < n_frames ? f0 + frames_per : n_frames;
        for (int64_t f = f0; f < f1; f++) {
            if (expected_crcs &&
                x3_crc16(data + payload_offsets[f], payload_lens[f]) != expected_crcs[f]) {
                rcs[t] = -4;  // FrameHeaderInvalidPayloadCRC
                bad[t] = f;
                return;
            }
            int32_t rc = x3_decode_frame(data + payload_offsets[f], payload_lens[f],
                                         params, samples[f], wav_out + out_pos[(size_t)f]);
            if (rc != 0) { rcs[t] = rc; bad[t] = f; return; }
        }
    };
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < nthreads; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
    for (int32_t t = 0; t < nthreads; t++) {
        if (rcs[t] != 0) {
            if (err_frame) *err_frame = bad[t];
            return rcs[t];
        }
    }
    return 0;
}

int32_t x3_decode_frames_mt(const uint8_t* data, const int64_t* payload_offsets,
                            const int32_t* samples, const int32_t* payload_lens,
                            int64_t n_frames, const X3Params* params,
                            int16_t* wav_out, int64_t* err_frame, int32_t nthreads) {
    return x3_decode_frames_mt_crc(data, payload_offsets, samples, payload_lens, nullptr,
                                   n_frames, params, wav_out, err_frame, nthreads);
}

// Assemble a frame stream from batched device outputs: out = concat over
// frames of (20-byte header || payload[:nbytes]).  Replaces the per-frame
// Python assembly loop in the device pipeline's host epilogue.  Returns bytes
// written, or -1 if cap is too small.
int64_t x3_assemble_frames(const uint8_t* headers, const uint8_t* payloads,
                           const int32_t* nbytes, int64_t n_frames,
                           int64_t payload_stride, uint8_t* out, int64_t cap) {
    int64_t pos = 0;
    for (int64_t f = 0; f < n_frames; f++) {
        int64_t nb = nbytes[f];
        if (pos + 20 + nb > cap) return -1;
        memcpy(out + pos, headers + f * 20, 20);
        pos += 20;
        memcpy(out + pos, payloads + f * payload_stride, (size_t)nb);
        pos += nb;
    }
    return pos;
}

// Walk a frame stream: validate header CRCs and return frame boundaries.
// offsets/samples/payload_lens must have capacity max_frames.
// Returns the number of frames indexed.
int64_t x3_index_frames(const uint8_t* data, int64_t len, int64_t start,
                        int64_t* payload_offsets, int32_t* samples,
                        int32_t* payload_lens, int64_t max_frames) {
    crc_init();
    int64_t pos = start, count = 0;
    while (len - pos > 20 && count < max_frames) {
        const uint8_t* h = data + pos;
        if (h[0] != 0x78 || h[1] != 0x33) break;
        uint16_t expect = (uint16_t)((h[16] << 8) | h[17]);
        if (x3_crc16(h, 16) != expect) break;
        if (h[3] > 1) break;  // channels byte (walker raises MoreThanOneChannel)
        int32_t pl = (h[6] << 8) | h[7];
        if (pl >= 0x7fe0 || len - (pos + 20) < pl) break;
        payload_offsets[count] = pos + 20;
        samples[count] = (h[4] << 8) | h[5];
        payload_lens[count] = pl;
        count++;
        pos += 20 + pl;
    }
    return count;
}

}  // extern "C"

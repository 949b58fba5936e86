// Native twin of the exact host rate-control search (ops/quant.py +
// models/encoder.py _bin_search_step_size/_inner_loop/_exact_eval).
//
// Behavioural reference (bit-for-bit): /root/reference/mp3stego/encoder/
//   MP3_Encoder.py: quantize 373-415, calc_run_len 266-291, count1_bit_count
//   171-211, count_bit 214-263, __subdivide 998-1036, __new_choose_table
//   1170-1264 (+ stego transform 1147-1168), bin search 958-996, inner loop
//   1064-1095.
//
// Everything here is integer arithmetic except quantize's float fallback,
// which uses only IEEE-exact ops (multiply, sqrt) in NumPy's source order —
// so results are bit-identical to the Python twin on any IEEE host. The
// build must keep -ffp-contract=off (see decode_plane_f64.cpp).
//
// State layout (int64[12], shared with Python GrInfo):
//   [0] quantizerStepSize [1] address1 [2] address2 [3] address3
//   [4] big_values [5] count1 [6] count1table_select
//   [7] region0_count [8] region1_count [9..11] table_select[0..2]
// Stale-field semantics are preserved: subdivide with big_values==0 leaves
// addresses untouched, bail evaluations touch nothing.

#include <cmath>
#include <cstdint>
#include <cstring>

// AVX-512 fast paths (guarded; scalar bodies remain the reference twins and
// the portable fallback). Exactness argument for every vector loop: each
// lane evaluates the identical integer expression as the scalar body — the
// only reassociation is of wraparound/int64 SUMS, which are associative —
// so vectorization cannot change results. The rare float-fallback lanes of
// quantize are redone with the EXACT scalar expression, preserving NumPy's
// operation order (see quantize()).
#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__) \
    && !defined(MP3STEGO_FORCE_SCALAR)
#include <immintrin.h>
#define MP3S_AVX512 1
#endif

namespace {

constexpr int kGranule = 576;
constexpr int64_t kMaxQuant = 8192;
constexpr int64_t kBailBits = 100000;

// ---- tables, copied once via rate_tables_init
double g_steptab[128];
int32_t g_steptabi[128];
int32_t g_int2idx[10000];
int32_t g_hlen[34 * 16 * 16];
int32_t g_xlen[34];
int32_t g_linbits[34];
int32_t g_linmax[34];
int32_t g_qlen0[16], g_qlen1[16];
// 18 rows: 0-8 the reference's tables (byte-identity), 9-17 the ISO/
// ecosystem rows used by the compliant LSF writer (tables.BAND_ALL).
int32_t g_band[18 * 23];
int64_t g_nband = 0;
int32_t g_subdv[23 * 2];
int32_t g_transform[32 * 2];

struct State {
  int64_t* s;  // the 12-slot layout above
  int64_t& qss() { return s[0]; }
  int64_t& a1() { return s[1]; }
  int64_t& a2() { return s[2]; }
  int64_t& a3() { return s[3]; }
  int64_t& bv() { return s[4]; }
  int64_t& c1() { return s[5]; }
  int64_t& c1t() { return s[6]; }
  int64_t& r0() { return s[7]; }
  int64_t& r1() { return s[8]; }
  int64_t& ts(int r) { return s[9 + r]; }
};

// util.mulr on scalars (encoder/util.py:131-134): Q32 rounded multiply,
// wrapped to int32.
inline int32_t mulr_scalar(int64_t a, int64_t b) {
  return int32_t((a * b + 2147483648LL) >> 32);
}

// The float fallback of quantize, NumPy operation order:
// (xrabs.astype(f64) * scale) * 4.656612875e-10, then sqrt(sqrt(dbl) * dbl)
// truncated to int32. xrabs is the int32-WRAPPED abs (np.abs semantics).
inline int32_t quant_float(int32_t xrabs_i, double scale) {
  const double dbl = (double(xrabs_i) * scale) * 4.656612875e-10;
  return int32_t(std::sqrt(std::sqrt(dbl) * dbl));
}

// quantize (MP3_Encoder.py:373-415 / quant.py:68-90). Returns false on the
// early xrmax bail (ix untouched, ixmax=16384); otherwise fills ix_tmp.
bool quantize(const int32_t* xr, const int32_t* xrabs, int64_t xrmax,
              int64_t step, int32_t* ix_tmp, int64_t* ixmax_out) {
  const int32_t scalei = g_steptabi[step + 127];
  if (mulr_scalar(xrmax, scalei) > 165140) {  // 8192**(4/3)
    *ixmax_out = 16384;
    return false;
  }
  const double scale = g_steptab[step + 127];
  int32_t mx = 0;
#ifdef MP3S_AVX512
  // ln = (labs * scalei + 2^31) >> 32 per lane. labs is the TRUE magnitude
  // (int64 in the scalar body) — vpabsd's INT32_MIN -> 0x80000000 output is
  // exactly 2^31 when consumed UNSIGNED, and scalei is positive (STEPTABI in
  // [2, 2^31-1]), so unsigned 32x32->64 multiplies reproduce labs*scalei for
  // every input. The bail above caps ln at 165140 (mulr is monotone in
  // labs), so ln always fits 32 bits and the signed ln<10000 compare holds.
  const __m512i vscale = _mm512_set1_epi64(int64_t(uint32_t(scalei)));
  const __m512i vround = _mm512_set1_epi64(1LL << 31);
  const __m512i v10k = _mm512_set1_epi32(10000);
  __m512i vmx = _mm512_setzero_si512();
  for (int i = 0; i < kGranule; i += 16) {
    const __m512i v = _mm512_loadu_si512(xr + i);
    const __m512i a = _mm512_abs_epi32(v);
    __m512i pe = _mm512_mul_epu32(a, vscale);
    __m512i po = _mm512_mul_epu32(_mm512_srli_epi64(a, 32), vscale);
    pe = _mm512_srli_epi64(_mm512_add_epi64(pe, vround), 32);
    po = _mm512_srli_epi64(_mm512_add_epi64(po, vround), 32);
    const __m512i ln = _mm512_or_si512(pe, _mm512_slli_epi64(po, 32));
    const __mmask16 big = _mm512_cmpge_epi32_mask(ln, v10k);
    __m512i vx = _mm512_mask_i32gather_epi32(
        _mm512_setzero_si512(), __mmask16(~big), ln, g_int2idx, 4);
    if (big) {  // rare: redo those lanes with the exact scalar expression
      alignas(64) int32_t vals[16];
      _mm512_store_si512(vals, vx);
      unsigned m = big;
      while (m) {
        const int k = __builtin_ctz(m);
        m &= m - 1;
        vals[k] = quant_float(xrabs[i + k], scale);
      }
      vx = _mm512_load_si512(vals);
    }
    _mm512_storeu_si512(ix_tmp + i, vx);
    vmx = _mm512_max_epi32(vmx, vx);
  }
  mx = _mm512_reduce_max_epi32(vmx);
#else
  for (int i = 0; i < kGranule; ++i) {
    const int64_t labs = xr[i] < 0 ? -int64_t(xr[i]) : int64_t(xr[i]);
    const int32_t ln = int32_t((labs * scalei + 2147483648LL) >> 32);
    const int32_t v = ln < 10000 ? g_int2idx[ln] : quant_float(xrabs[i], scale);
    ix_tmp[i] = v;
    if (v > mx) mx = v;
  }
#endif
  *ixmax_out = mx < 0 ? 0 : mx;
  return true;
}

// calc_run_len (MP3_Encoder.py:266-291)
void calc_run_len(const int32_t* ix, State st) {
  int i = 0;
#ifdef MP3S_AVX512
  // last nonzero via 16-lane masked scans from the tail (576 % 16 == 0)
  for (int k = kGranule - 16; k >= 0; k -= 16) {
    const __mmask16 m = _mm512_test_epi32_mask(
        _mm512_loadu_si512(ix + k), _mm512_set1_epi32(-1));
    if (m) { i = k + (31 - __builtin_clz(unsigned(m))) + 1; break; }
  }
#else
  for (int k = kGranule - 1; k >= 0; --k)
    if (ix[k] != 0) { i = k + 1; break; }
#endif
  i += i & 1;
  int lim = 0;
#ifdef MP3S_AVX512
  {
    const __m512i one = _mm512_set1_epi32(1);
    int k = i - 1;
    // unaligned head: the top (i % 16) elements
    const int head = (k + 1) & 15;
    if (head) {
      const int base = k + 1 - head;
      const __mmask16 keep = __mmask16((1u << head) - 1u);
      const __mmask16 m = _mm512_mask_cmpgt_epi32_mask(
          keep, _mm512_maskz_loadu_epi32(keep, ix + base), one);
      if (m) lim = base + (31 - __builtin_clz(unsigned(m))) + 1;
      k = base - 1;
    }
    if (!lim) {
      for (int b = k - 15; b >= 0; b -= 16) {
        const __mmask16 m = _mm512_cmpgt_epi32_mask(
            _mm512_loadu_si512(ix + b), one);
        if (m) { lim = b + (31 - __builtin_clz(unsigned(m))) + 1; break; }
      }
    }
  }
#else
  for (int k = i - 1; k >= 0; --k)
    if (ix[k] > 1) { lim = k + 1; break; }
#endif
  int knum = (i - lim) / 4;
  if (i / 4 < knum) knum = i / 4;
  if (knum < 0) knum = 0;
  st.c1() = knum;
  i -= 4 * knum;
  st.bv() = i >> 1;
}

// count1_bit_count (MP3_Encoder.py:171-211)
int64_t count1_bit_count(const int32_t* ix, State st) {
  const int start = int(st.bv()) << 1;
  int64_t sign_bits = 0, q0 = 0, q1 = 0;
  int q = 0;
#ifdef MP3S_AVX512
  // 4 quads (16 values) per iteration; the two 16-entry quad-length tables
  // live in registers, indexed with vpermd (no memory gathers). In the
  // count1 region every value is 0 or 1 (calc_run_len guarantees it), so
  // p = quad[0] + 2*quad[1] + 4*quad[2] + 8*quad[3] == the movemask of the
  // nonzero lanes, reassembled per 4-lane group.
  if (st.c1() >= 4) {
    const __m512i t0 = _mm512_loadu_si512(g_qlen0);
    const __m512i t1 = _mm512_loadu_si512(g_qlen1);
    const __m512i zero = _mm512_setzero_si512();
    for (; q + 4 <= st.c1(); q += 4) {
      const __m512i v = _mm512_loadu_si512(ix + start + 4 * q);
      const unsigned nz = _mm512_cmpneq_epi32_mask(v, zero);
      sign_bits += _mm_popcnt_u32(nz);
      const __m128i p4 = _mm_set_epi32(int((nz >> 12) & 15),
                                       int((nz >> 8) & 15),
                                       int((nz >> 4) & 15), int(nz & 15));
      const __m512i pz = _mm512_castsi128_si512(p4);
      __m128i l0 = _mm512_castsi512_si128(_mm512_permutexvar_epi32(pz, t0));
      __m128i l1 = _mm512_castsi512_si128(_mm512_permutexvar_epi32(pz, t1));
      alignas(16) int32_t b0[4], b1[4];
      _mm_store_si128(reinterpret_cast<__m128i*>(b0), l0);
      _mm_store_si128(reinterpret_cast<__m128i*>(b1), l1);
      q0 += b0[0] + b0[1] + b0[2] + b0[3];
      q1 += b1[0] + b1[1] + b1[2] + b1[3];
    }
  }
#endif
  for (; q < st.c1(); ++q) {
    const int32_t* quad = ix + start + 4 * q;
    const int p = quad[0] + (quad[1] << 1) + (quad[2] << 2) + (quad[3] << 3);
    sign_bits += (quad[0] != 0) + (quad[1] != 0) + (quad[2] != 0)
               + (quad[3] != 0);
    q0 += g_qlen0[p];
    q1 += g_qlen1[p];
  }
  const int64_t sum0 = sign_bits + q0, sum1 = sign_bits + q1;
  if (sum0 < sum1) {
    st.c1t() = 0;
    return sum0;
  }
  st.c1t() = 1;
  return sum1;
}

// count_bit (MP3_Encoder.py:214-263)
int64_t count_bit(const int32_t* ix, int64_t start, int64_t end,
                  int64_t table) {
  if (table == 0) return 0;
  const int32_t* hl = g_hlen + table * 256;
  int64_t h_sum = 0;
  const int64_t lin = table > 15 ? g_linbits[table] : 0;
  int64_t i = start;
#ifdef MP3S_AVX512
  // 16 (x, y) pairs per iteration: deinterleave two zmm loads, clamp/count
  // linbits lanes, one 16-lane gather over the table's 16x16 h_len block.
  if (end - i >= 32) {
    const __m512i evens = _mm512_set_epi32(30, 28, 26, 24, 22, 20, 18, 16,
                                           14, 12, 10, 8, 6, 4, 2, 0);
    const __m512i odds = _mm512_set_epi32(31, 29, 27, 25, 23, 21, 19, 17,
                                          15, 13, 11, 9, 7, 5, 3, 1);
    const __m512i v14 = _mm512_set1_epi32(14);
    const __m512i v15 = _mm512_set1_epi32(15);
    const __m512i zero = _mm512_setzero_si512();
    int64_t lin_n = 0, sign_n = 0, hl_sum = 0;
    for (; i + 32 <= end; i += 32) {
      const __m512i v0 = _mm512_loadu_si512(ix + i);
      const __m512i v1 = _mm512_loadu_si512(ix + i + 16);
      __m512i x = _mm512_permutex2var_epi32(v0, evens, v1);
      __m512i y = _mm512_permutex2var_epi32(v0, odds, v1);
      if (table > 15) {
        lin_n += _mm_popcnt_u32(_mm512_cmpgt_epi32_mask(x, v14));
        lin_n += _mm_popcnt_u32(_mm512_cmpgt_epi32_mask(y, v14));
        x = _mm512_min_epi32(x, v15);
        y = _mm512_min_epi32(y, v15);
      }
      sign_n += _mm_popcnt_u32(_mm512_cmpneq_epi32_mask(x, zero));
      sign_n += _mm_popcnt_u32(_mm512_cmpneq_epi32_mask(y, zero));
      const __m512i idx = _mm512_add_epi32(_mm512_slli_epi32(x, 4), y);
      hl_sum += _mm512_reduce_add_epi32(_mm512_i32gather_epi32(idx, hl, 4));
    }
    h_sum = hl_sum + sign_n + lin * lin_n;
  }
#endif
  for (; i < end; i += 2) {
    int32_t x = ix[i], y = ix[i + 1];
    if (table > 15) {
      if (x > 14) { h_sum += lin; x = 15; }
      if (y > 14) { h_sum += lin; y = 15; }
    }
    h_sum += hl[x * 16 + y];
    h_sum += (x != 0) + (y != 0);
  }
  return h_sum;
}

// __subdivide (MP3_Encoder.py:998-1036): big_values==0 leaves addresses
// stale; the band walk runs over the FLATTENED table from the sr row on
// (reference quirk — it can cross into later samplerate rows).
void subdivide(State st, int64_t sr_off) {
  if (st.bv() == 0) {
    st.r0() = 0;
    st.r1() = 0;
    return;
  }
  const int32_t* band = g_band + sr_off;
  const int64_t bvr = 2 * st.bv();

  int scfb_anz = 0;
  while (band[scfb_anz] < bvr) ++scfb_anz;

  int this_count = g_subdv[scfb_anz * 2 + 0];
  while (this_count > 0) {
    if (band[this_count + 1] <= bvr) break;
    --this_count;
  }
  st.r0() = this_count;
  st.a1() = band[this_count + 1];

  const int32_t* band2 = band + this_count + 1;
  this_count = g_subdv[scfb_anz * 2 + 1];
  while (this_count > 0) {
    if (band2[this_count + 1] <= bvr) break;
    --this_count;
  }
  st.r1() = this_count;
  st.a2() = band2[this_count + 1];
  st.a3() = bvr;
}

// __new_choose_table (MP3_Encoder.py:1170-1264) — including the descending
// no-linbits scan that always lands on 13 first, and alternates compared
// against the ORIGINAL sum with last-winner-sticks.
int64_t choose_table(const int32_t* ix, int64_t begin, int64_t end) {
  int32_t ix_max = 0;
  for (int64_t i = begin; i < end; ++i)
    if (ix[i] > ix_max) ix_max = ix[i];
  if (ix_max == 0) return 0;

  if (ix_max < 15) {
    int64_t choice0 = 0;
    for (int i = 13; i >= 0; --i)
      if (g_xlen[i] > ix_max) { choice0 = i; break; }
    const int64_t sum0 = count_bit(ix, begin, end, choice0);
    static const int kAltOf[14][2] = {{-1,-1},{-1,-1},{3,-1},{-1,-1},{-1,-1},
                                      {6,-1},{-1,-1},{8,9},{-1,-1},{-1,-1},
                                      {11,12},{-1,-1},{-1,-1},{15,-1}};
    const int* alts = kAltOf[choice0];  // row fixed by the ORIGINAL choice
    for (int a = 0; a < 2; ++a) {
      if (alts[a] < 0) continue;
      if (count_bit(ix, begin, end, alts[a]) <= sum0) choice0 = alts[a];
    }
    return choice0;
  }

  ix_max -= 15;
  int64_t choice0 = 0;
  for (int i = 15; i < 24; ++i)
    if (g_linmax[i] >= ix_max) { choice0 = i; break; }
  int64_t choice1 = 0;
  for (int i = 24; i < 32; ++i)
    if (g_linmax[i] >= ix_max) { choice1 = i; break; }
  const int64_t s0 = count_bit(ix, begin, end, choice0);
  const int64_t s1 = count_bit(ix, begin, end, choice1);
  return s1 < s0 ? choice1 : choice0;
}

// choose + stego pair transform (encoder.py _choose / MP3_Encoder.py:1147-68)
inline int64_t choose_with_hide(const int32_t* ix, int64_t begin, int64_t end,
                                const uint8_t* hide, int64_t hide_len,
                                int64_t idx) {
  const int64_t c = choose_table(ix, begin, end);
  if (hide_len > 0 && idx < hide_len)
    return g_transform[c * 2 + hide[idx]];
  return c;
}

// _big_v_tab_select (encoder.py:773-787): the cursor advances only over
// regions whose CHOSEN (post-transform) table is nonzero.
void big_v_tab_select(const int32_t* ix, State st, const uint8_t* hide,
                      int64_t hide_len, int64_t hide_off) {
  int64_t idx = hide_off;
  st.ts(0) = st.a1() <= 0 ? 0
      : choose_with_hide(ix, 0, st.a1(), hide, hide_len, hide_off);
  if (st.ts(0) > 0) ++idx;
  st.ts(1) = st.a2() <= st.a1() ? 0
      : choose_with_hide(ix, st.a1(), st.a2(), hide, hide_len, idx);
  if (st.ts(1) > 0) ++idx;
  st.ts(2) = (st.bv() << 1) <= st.a2() ? 0
      : choose_with_hide(ix, st.a2(), st.bv() << 1, hide, hide_len, idx);
}

// big_v_bit_count (MP3_Encoder.py:294-318)
int64_t big_v_bit_count(const int32_t* ix, State st) {
  int64_t bits = 0;
  if (st.ts(0)) bits += count_bit(ix, 0, st.a1(), st.ts(0));
  if (st.ts(1)) bits += count_bit(ix, st.a1(), st.a2(), st.ts(1));
  if (st.ts(2)) bits += count_bit(ix, st.a2(), st.bv() << 1, st.ts(2));
  return bits;
}

// _eval: the shared search-evaluation body
int64_t eval_ix(const int32_t* ix, State st, int64_t sr_off,
                const uint8_t* hide, int64_t hide_len, int64_t hide_off) {
  calc_run_len(ix, st);
  int64_t bits = count1_bit_count(ix, st);
  subdivide(st, sr_off);
  big_v_tab_select(ix, st, hide, hide_len, hide_off);
  bits += big_v_bit_count(ix, st);
  return bits;
}

}  // namespace

extern "C" int64_t rate_tables_init(
    const double* steptab, const int32_t* steptabi, const int32_t* int2idx,
    const int32_t* hlen, const int32_t* xlen, const int32_t* linbits,
    const int32_t* linmax, const int32_t* qlen0, const int32_t* qlen1,
    const int32_t* band, int64_t nband, const int32_t* subdv,
    const int32_t* transform) {
  std::memcpy(g_steptab, steptab, sizeof(g_steptab));
  std::memcpy(g_steptabi, steptabi, sizeof(g_steptabi));
  std::memcpy(g_int2idx, int2idx, sizeof(g_int2idx));
  std::memcpy(g_hlen, hlen, sizeof(g_hlen));
  std::memcpy(g_xlen, xlen, sizeof(g_xlen));
  std::memcpy(g_linbits, linbits, sizeof(g_linbits));
  std::memcpy(g_linmax, linmax, sizeof(g_linmax));
  std::memcpy(g_qlen0, qlen0, sizeof(g_qlen0));
  std::memcpy(g_qlen1, qlen1, sizeof(g_qlen1));
  if (nband > int64_t(sizeof(g_band) / sizeof(g_band[0]))) return -1;
  std::memcpy(g_band, band, nband * sizeof(int32_t));
  g_nband = nband;
  std::memcpy(g_subdv, subdv, sizeof(g_subdv));
  std::memcpy(g_transform, transform, sizeof(g_transform));
  return 0;
}

// _exact_eval (encoder.py:865-870): quantize at `step`; on bail return
// 100000 with ix untouched, else write ix and evaluate.
extern "C" int64_t rate_exact_eval(
    const int32_t* xr, const int32_t* xrabs, int64_t xrmax, int64_t step,
    int64_t sr_off, const uint8_t* hide, int64_t hide_len, int64_t hide_off,
    int64_t* state, int32_t* ix) {
  State st{state};
  int32_t tmp[kGranule];
  int64_t ixmax;
  if (!quantize(xr, xrabs, xrmax, step, tmp, &ixmax) || ixmax > kMaxQuant)
    return kBailBits;
  std::memcpy(ix, tmp, sizeof(tmp));
  return eval_ix(ix, st, sr_off, hide, hide_len, hide_off);
}

// VBR rate choice (models/encoder.py::_vbr_framing): bits to code every
// lane at ONE quantizer step, hide-free and with fresh per-lane state (the
// stale-address chain is a property of the actual search, not of a budget
// estimate). Lanes whose quantization bails or overflows the ixmax gate
// record `big_bits`. One vectorized pass per lane (~8 ms for a 30s stereo
// file) — the exact host twin of one column of quant_batch's device grid,
// which is gather-heavy on the device.
extern "C" int64_t rate_cost_step(
    const int32_t* xr_all, int64_t lanes, int64_t step, int64_t sr_off,
    int64_t big_bits, int64_t* out_bits) {
  int32_t xrabs[kGranule];
  int32_t ix[kGranule];
  for (int64_t g = 0; g < lanes; ++g) {
    const int32_t* row = xr_all + g * kGranule;
    int32_t mx = 0;
    for (int i = 0; i < kGranule; ++i) {
      const int32_t av =
          int32_t(row[i] < 0 ? 0u - uint32_t(row[i]) : uint32_t(row[i]));
      xrabs[i] = av;
      if (av > mx) mx = av;
    }
    int64_t ixmax;
    if (!quantize(row, xrabs, mx, step, ix, &ixmax) || ixmax > kMaxQuant) {
      out_bits[g] = big_bits;
      continue;
    }
    int64_t state[12] = {0};
    State st{state};
    out_bits[g] = eval_ix(ix, st, sr_off, nullptr, 0, 0);
  }
  return 0;
}

// _bin_search_step_size (MP3_Encoder.py:958-996): returns the step; the ix
// buffer keeps the LAST successful quantization (bails leave it stale).
extern "C" int64_t rate_bin_search(
    const int32_t* xr, const int32_t* xrabs, int64_t xrmax,
    int64_t desired_rate, int64_t sr_off, const uint8_t* hide,
    int64_t hide_len, int64_t hide_off, int64_t* state, int32_t* ix) {
  State st{state};
  int32_t tmp[kGranule];
  int64_t nxt = -120, count = 120;
  while (true) {
    const int64_t half = count / 2;
    int64_t ixmax, bit;
    if (!quantize(xr, xrabs, xrmax, nxt + half, tmp, &ixmax)
        || ixmax > kMaxQuant) {
      bit = kBailBits;
    } else {
      std::memcpy(ix, tmp, sizeof(tmp));
      bit = eval_ix(ix, st, sr_off, hide, hide_len, hide_off);
    }
    if (bit < desired_rate) {
      count = half;
    } else {
      nxt += half;
      count -= half;
    }
    if (count <= 1) break;
  }
  return nxt;
}

extern "C" int64_t rate_bin_search(
    const int32_t* xr, const int32_t* xrabs, int64_t xrmax,
    int64_t desired_rate, int64_t sr_off, const uint8_t* hide,
    int64_t hide_len, int64_t hide_off, int64_t* state, int32_t* ix);
extern "C" int64_t rate_inner_loop(
    const int32_t* xr, const int32_t* xrabs, int64_t xrmax, int64_t max_bits,
    int64_t sr_off, const uint8_t* hide, int64_t hide_len, int64_t hide_off,
    int64_t* state, int32_t* ix);

// Whole-file sequential rate search: the reference's frame loop order
// (f, ch, gr) with per-(gr, ch)-slot GrInfo state persisting across frames
// (stale addresses included) and a live stego cursor — one call replaces the
// per-granule Python loop entirely. Reference: MP3_Encoder.py:760-815 with
// part2_length == 0 (scale_fac_compress stays 0, slen tables start at 0).
//
// res layout per lane (int64[12]):
//   [0] step [1] bits [2] bv [3] c1 [4] cts [5] r0c [6] r1c
//   [7] ch0 [8] ch1 [9] ch2 [10] xrmax0 (1 = skipped) [11] unused
// Also emits per-lane scfsi energy sums (MP3_Encoder.py:817-850 semantics:
// int32-wrapped sums of mulsr(xr,xr)>>10, total + 21 long bands).
extern "C" int64_t rate_search_file(
    const int32_t* xr,        // (nch*tg, 576), lane g = ch*tg + f*gpf + gr
    const int32_t* max_bits,  // (nch*tg,)
    int64_t nch, int64_t tg, int64_t gpf, int64_t sr_off,
    const uint8_t* hide, int64_t hide_len, int64_t hide_off0,
    int64_t* res,             // (nch*tg, 12)
    int32_t* ix_out,          // (nch*tg, 576)
    int32_t* en_tot,          // (nch*tg,)
    int32_t* en21,            // (nch*tg, 21)
    // chunked/streaming encode: the per-slot search chains, saved at return
    // and re-seeded on the next call so chunk boundaries are invisible
    // (byte-identical to one whole-file call). chain_in=0 starts fresh.
    int64_t* chain_state,     // (2*2*12) [gr][ch] qss/addr chain, or null
    int32_t* chain_ix,        // (2*2*576) [gr][ch] stale-ix buffers, or null
    int64_t chain_in) {
  const int64_t nf = tg / gpf;
  int64_t slot_state[2][2][12];  // [gr][ch]
  std::memset(slot_state, 0, sizeof(slot_state));
  // the reference's l3_enc[ch][gr] ix buffers persist across frames: a
  // quantize bail mid-search leaves the PREVIOUS granule's samples in the
  // slot and _eval consumes them (stale-ix quirk) — so the search must run
  // on per-slot buffers, copied out per granule
  static thread_local int32_t slot_ix[2][2][kGranule];
  std::memset(slot_ix, 0, sizeof(slot_ix));
  if (chain_in && chain_state && chain_ix) {
    std::memcpy(slot_state, chain_state, sizeof(slot_state));
    std::memcpy(slot_ix, chain_ix, sizeof(slot_ix));
  }
  int64_t cursor = hide_off0;
  const int32_t* band = g_band + sr_off;

  int32_t xrabs[kGranule];
  for (int64_t f = 0; f < nf; ++f) {
    for (int64_t ch = 0; ch < nch; ++ch) {
      for (int64_t gr = 0; gr < gpf; ++gr) {
        const int64_t g = ch * tg + f * gpf + gr;
        const int32_t* row = xr + g * kGranule;
        int64_t* r = res + g * 12;

        // scfsi energies: terms = mulsr(xr, xr) >> 10, int32-wrapped sums
        uint32_t tot = 0;
        int32_t terms[kGranule];
        int32_t mx = 0;
        for (int i = 0; i < kGranule; ++i) {
          const int64_t v = row[i];
          terms[i] = int32_t((v * v + 1073741824LL) >> 31) >> 10;
          tot += uint32_t(terms[i]);
          // xrabs with int32 wraparound (np.abs semantics)
          const int32_t av =
              int32_t(row[i] < 0 ? 0u - uint32_t(row[i]) : uint32_t(row[i]));
          xrabs[i] = av;
          if (av > mx) mx = av;
        }
        en_tot[g] = int32_t(tot);
        for (int sfb = 0; sfb < 21; ++sfb) {
          uint32_t s = 0;
          for (int32_t i = band[sfb]; i < band[sfb + 1]; ++i)
            s += uint32_t(terms[i]);
          en21[g * 21 + sfb] = int32_t(s);
        }

        const int64_t xrmax = mx < 0 ? 0 : mx;
        if (xrmax == 0) {
          for (int k = 0; k < 12; ++k) r[k] = 0;
          r[10] = 1;  // skipped: slot state untouched, cursor unmoved
          continue;
        }
        State st{slot_state[gr][ch]};
        int32_t* ix = slot_ix[gr][ch];
        const int64_t desired = max_bits[g];
        st.qss() = rate_bin_search(row, xrabs, xrmax, desired, sr_off,
                                   hide, hide_len, cursor,
                                   slot_state[gr][ch], ix);
        const int64_t bits = rate_inner_loop(row, xrabs, xrmax, desired,
                                             sr_off, hide, hide_len, cursor,
                                             slot_state[gr][ch], ix);
        r[0] = st.qss();
        r[1] = bits;
        r[2] = st.bv();
        r[3] = st.c1();
        r[4] = st.c1t();
        r[5] = st.r0();
        r[6] = st.r1();
        r[7] = st.ts(0);
        r[8] = st.ts(1);
        r[9] = st.ts(2);
        r[10] = 0;
        cursor += (st.ts(0) > 0) + (st.ts(1) > 0) + (st.ts(2) > 0);
      }
    }
    // frame serialization: the reference signs l3_enc IN PLACE per slot
    // (neg = (mdct < 0) & (l3 > 0), MP3_Encoder's format step) — the signed
    // buffer is what the serializer consumes AND what carries into the next
    // frame's slot state
    for (int64_t ch = 0; ch < nch; ++ch) {
      for (int64_t gr = 0; gr < gpf; ++gr) {
        const int64_t g = ch * tg + f * gpf + gr;
        const int32_t* row = xr + g * kGranule;
        int32_t* ix = slot_ix[gr][ch];
        for (int i = 0; i < kGranule; ++i)
          if (row[i] < 0 && ix[i] > 0) ix[i] = -ix[i];
        std::memcpy(ix_out + g * kGranule, ix, kGranule * sizeof(int32_t));
      }
    }
  }
  if (chain_state && chain_ix) {
    std::memcpy(chain_state, slot_state, sizeof(slot_state));
    std::memcpy(chain_ix, slot_ix, sizeof(slot_ix));
  }
  return cursor;
}

// _inner_loop (MP3_Encoder.py:1064-1095). Note the asymmetry vs bin search:
// a successful quantize updates ix EVEN when ixmax > 8192 (the step is then
// retried higher); only the early xrmax bail leaves ix stale. Reads and
// writes quantizerStepSize in state[0]; returns the bit count.
extern "C" int64_t rate_inner_loop(
    const int32_t* xr, const int32_t* xrabs, int64_t xrmax, int64_t max_bits,
    int64_t sr_off, const uint8_t* hide, int64_t hide_len, int64_t hide_off,
    int64_t* state, int32_t* ix) {
  State st{state};
  int32_t tmp[kGranule];
  if (max_bits < 0) --st.qss();
  while (true) {
    while (true) {
      int64_t ixmax;
      if (quantize(xr, xrabs, xrmax, st.qss() + 1, tmp, &ixmax))
        std::memcpy(ix, tmp, sizeof(tmp));
      if (ixmax <= kMaxQuant) break;
      ++st.qss();
    }
    ++st.qss();
    const int64_t bits = eval_ix(ix, st, sr_off, hide, hide_len, hide_off);
    if (bits <= max_bits) return bits;
  }
}

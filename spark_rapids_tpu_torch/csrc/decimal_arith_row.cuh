// The per-row logic of the decimal_arith kernel (csrc/decimal_arith.cu):
// Spark's decimal add, subtract, remainder, multiply, divide, rescale and
// average, and Java's BigDecimal.doubleValue, over decimals held as their
// unscaled values in int64 lanes (types.py DecimalType). Intermediates are
// 128-bit (unsigned __int128, which nvcc and g++ both take).
// Everything a thread runs is __host__ __device__, so g++ builds it on a
// machine without CUDA and the tests hold it to the plain version and to
// Python's decimal arithmetic (tests/test_torch_decimal_arith.py).
//
// Rounding is HALF_UP (a tie rounds away from zero): magnitudes are
// rounded, then the sign is put back. A result whose magnitude passes its
// declared precision p (10^p - 1) or int64 is NULL, Spark's non-ANSI
// overflow answer: every function returns whether its result is valid.
//
// A launch's powers of ten, and the reciprocals of those it divides by,
// are computed once on the host (da_consts) and reach every thread by
// value (DaConsts): no row loops over digits. No `/` or `%` on a 64- or
// 128-bit integer is left in a thread's code (the GPU has no integer
// divide instruction: nvcc would call a software routine of tens of
// instructions, or a loop). Division takes one of three paths:
//   (a) by a launch constant 10^j: its normalized limbs and reciprocal
//       are in the DaConsts (da_divrem, da_divrem64);
//   (b) by a divisor of one row that fits 64 bits (avg's count, div's and
//       rem's divisors): a reciprocal built for the row from a double
//       estimate and two integer corrections (da_recip), then a 2-by-1
//       step a limb (da_div21);
//   (c) by a divisor past 64 bits: the quotient is below 2^64, one 3-by-2
//       step from the divisor's top limb with at most two corrections
//       (da_div32, Knuth's algorithm D). On the kernel's paths such a
//       divisor is a launch constant (10^j, j >= 20; to_double's 10^s) or
//       exceeds its dividend (div with e < 0, rem's b 10^kr), which
//       leaves a quotient of 0.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define DA_HD __host__ __device__ __forceinline__
#else
#define DA_HD inline
#endif

typedef unsigned __int128 da_u128;

// The functions of a launch (exprs/decimal_arith.py OPS)
enum DaOp { DA_MUL = 0, DA_DIV = 1, DA_RESCALE = 2, DA_AVG = 3,
            DA_TO_DOUBLE = 4, DA_ADD = 5, DA_SUB = 6, DA_REM = 7 };

// The widest decimal: 10^38 < 2^127, and every power of ten up to it is
// a da_u128
#define DA_MAX_DIGITS 38

// The base of a decimal SUM's partial limbs (exprs/aggregates.py
// DEC_LIMB)
#define DA_LIMB 1000000000000LL

// ---------------------------------------------------------------------------
// 64-bit pieces: the device's instructions, or the host's equivalents
// ---------------------------------------------------------------------------

// a * b, all 128 bits
DA_HD da_u128 da_mul_wide(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return ((da_u128)__umul64hi(a, b) << 64) | (a * b);
#else
  return (da_u128)a * b;
#endif
}

// a * b of signed values, all 128 bits
DA_HD __int128 da_smul_wide(int64_t a, int64_t b) {
#ifdef __CUDA_ARCH__
  return (__int128)(((da_u128)(uint64_t)__mul64hi(a, b) << 64) |
                    (uint64_t)(a * b));
#else
  return (__int128)a * b;
#endif
}

// The leading zero bits of x != 0
DA_HD int da_clz(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __clzll((long long)x);
#else
  return __builtin_clzll(x);
#endif
}

// 1 / x, correctly rounded
DA_HD double da_rcp(double x) {
#ifdef __CUDA_ARCH__
  return __drcp_rn(x);
#else
  return 1.0 / x;
#endif
}

// The double whose bits are b
DA_HD double da_bits_double(uint64_t b) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double((long long)b);
#else
  double v;
  memcpy(&v, &b, sizeof v);
  return v;
#endif
}

// |x| as an unsigned 64-bit value (|INT64_MIN| = 2^63 included)
DA_HD uint64_t da_mag(int64_t x) {
  return x < 0 ? 0ull - (uint64_t)x : (uint64_t)x;
}

// The bit length of v (0 for 0)
DA_HD int da_bits(da_u128 v) {
  const uint64_t hi = (uint64_t)(v >> 64), lo = (uint64_t)v;
  if (hi) return 128 - da_clz(hi);
  return lo ? 64 - da_clz(lo) : 0;
}

// ---------------------------------------------------------------------------
// division
// ---------------------------------------------------------------------------

// v = floor((2^128 - 1) / d) - 2^64 for d in [2^63, 2^64): the reciprocal
// that da_div21 multiplies by. d = dh 2^32 + dl, both halves exact
// doubles. With y the correctly rounded 1 / dh and e = 1 - (dh + dl 2^-32)
// y (|e| < 2^-31; the fused 1 - dh y is exact), 2^128 / d = 2^96 y (1 + e
// + e^2 + ...) = Y0 + Y1 to within 2^-16, Y0 = 2^96 y an integer in
// (2^64, 2^65]. So floor(Y0 + Y1 - 2^-15) - 2^64 is v or v - 1, and one
// product of it with d settles which.
DA_HD uint64_t da_recip(uint64_t d) {
  const double xh = (double)(uint32_t)(d >> 32), xl = (double)(uint32_t)d;
  const double y = da_rcp(xh);
  const double e = fma(-(xl * 0x1p-32), y, fma(-xh, y, 1.0));
  const double Y0 = y * 0x1p96;
  const double Y1 = Y0 * fma(e, e, e);
  // Y0 - 2^64 is a multiple of 2^12 in [2^12, 2^64]
  uint64_t v = (uint64_t)((Y0 - 0x1p64) - 0x1p12) +
               (uint64_t)(int64_t)floor(Y1 + (0x1p12 - 0x1p-15));
  // 2^128 - 1 - (2^64 + v) d is in [0, 2d)
  const da_u128 R = ~(da_u128)0 - ((da_u128)d << 64) - da_mul_wide(v, d);
  if (R >= d) ++v;
  return v;
}

// (u1 2^64 + u0) / d for d with its top bit set, u1 < d, v = da_recip(d):
// the quotient, the remainder in *r. Moller and Granlund, "Improved
// division by invariant integers" (2011), Algorithm 4: one 64 by 64 bit
// product, a low product and at most two corrections.
DA_HD uint64_t da_div21(uint64_t u1, uint64_t u0, uint64_t d, uint64_t v,
                        uint64_t* r) {
  const da_u128 q = da_mul_wide(v, u1) + (((da_u128)u1 << 64) | u0);
  uint64_t q1 = (uint64_t)(q >> 64) + 1;
  const uint64_t q0 = (uint64_t)q;
  uint64_t rr = u0 - q1 * d;
  if (rr > q0) {
    --q1;
    rr += d;
  }
  if (rr >= d) {
    ++q1;
    rr -= d;
  }
  *r = rr;
  return q1;
}

// (n2 2^128 + n1 2^64 + n0) / (d1 2^64 + d0) for d1 with its top bit set
// and n2 < d1 (so the quotient is below 2^64), v = da_recip(d1): the
// quotient, the remainder in *rem. Knuth's algorithm D for one quotient
// digit: the estimate from the top limbs over d1 is at most 2 too large,
// and the test of its product with d0 against the partial remainder
// (exact for a two-limb divisor) takes it down; each step down takes d0
// off the product and adds d1 to the remainder, so one product serves.
DA_HD uint64_t da_div32(uint64_t n2, uint64_t n1, uint64_t n0, uint64_t d1,
                        uint64_t d0, uint64_t v, da_u128* rem) {
  uint64_t rh;
  uint64_t q = da_div21(n2, n1, d1, v, &rh);
  da_u128 p = da_mul_wide(q, d0);
  bool over = false;                          // rh has passed 2^64
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int i = 0; i < 2; ++i) {
    if (over || p <= (((da_u128)rh << 64) | n0)) break;
    --q;
    p -= d0;
    rh += d1;
    over = rh < d1;
  }
  // below d1 2^64 + d0: modulo 2^128 the carry out of rh drops
  *rem = (((da_u128)rh << 64) | n0) - p;
  return q;
}

// A divisor d >= 1 made ready for division: d << sh with its top bit set,
// as one limb (d1; d < 2^64) or two (d1, d0), and the reciprocal of d1.
struct DaDiv {
  da_u128 d;
  uint64_t d1, d0, v;
  int sh;
  int wide;                                   // d >= 2^64
};

DA_HD DaDiv da_divider(da_u128 d) {
  DaDiv D;
  const uint64_t hi = (uint64_t)(d >> 64), lo = (uint64_t)d;
  D.d = d;
  D.wide = hi != 0;
  D.sh = da_clz(D.wide ? hi : lo);
  D.d1 = D.wide ? (hi << D.sh) | ((lo >> 1) >> (63 - D.sh)) : lo << D.sh;
  D.d0 = D.wide ? lo << D.sh : 0;
  D.v = da_recip(D.d1);
  return D;
}

// floor(n / D), the remainder in *rem, for any n < 2^128: two 2-by-1
// steps where D is one limb (the quotient may take 128 bits), one 3-by-2
// step where it is two (the quotient is below 2^64). n << sh takes three
// limbs, the top one below 2^sh <= 2^63 <= d1.
DA_HD da_u128 da_divrem(da_u128 n, const DaDiv& D, da_u128* rem) {
  const uint64_t hi = (uint64_t)(n >> 64), lo = (uint64_t)n;
  const int sh = D.sh;
  const uint64_t n2 = (hi >> 1) >> (63 - sh);
  const uint64_t n1 = (hi << sh) | ((lo >> 1) >> (63 - sh));
  const uint64_t n0 = lo << sh;
  if (D.wide) {
    da_u128 r;
    const uint64_t q = da_div32(n2, n1, n0, D.d1, D.d0, D.v, &r);
    *rem = r >> sh;
    return q;
  }
  uint64_t r;
  const uint64_t qh = da_div21(n2, n1, D.d1, D.v, &r);
  const uint64_t ql = da_div21(r, n0, D.d1, D.v, &r);
  *rem = r >> sh;
  return ((da_u128)qh << 64) | ql;
}

// floor(n / D) and *rem for a dividend of one limb: one 2-by-1 step, or
// none where D passes 2^64
DA_HD uint64_t da_divrem64(uint64_t n, const DaDiv& D, da_u128* rem) {
  if (D.wide) {
    *rem = n;
    return 0;
  }
  uint64_t r;
  const uint64_t q = da_div21((n >> 1) >> (63 - D.sh), n << D.sh, D.d1,
                              D.v, &r);
  *rem = r >> D.sh;
  return q;
}

// floor(n / D) and *rem where n's high limb is below D (one limb), so
// the quotient is below 2^64: one 2-by-1 step. Every function's result
// past 2^64 is NULL, so where the quotient is the result (less a
// rounding), a larger n needs no second step: the caller finds it NULL.
DA_HD uint64_t da_divrem_narrow(da_u128 n, const DaDiv& D, da_u128* rem) {
  const uint64_t hi = (uint64_t)(n >> 64), lo = (uint64_t)n;
  uint64_t r;
  const uint64_t q = da_div21((hi << D.sh) | ((lo >> 1) >> (63 - D.sh)),
                              lo << D.sh, D.d1, D.v, &r);
  *rem = r >> D.sh;
  return q;
}

// n / D rounded HALF_UP (magnitudes) into *q, or false where the
// quotient passes 2^64 (NULL)
DA_HD bool da_div_half_up(da_u128 n, const DaDiv& D, da_u128* q) {
  da_u128 r, qq;
  if (D.wide) {
    qq = da_divrem(n, D, &r);                   // below 2^64
  } else {
    if ((uint64_t)(n >> 64) >= (uint64_t)D.d) return false;
    qq = da_divrem_narrow(n, D, &r);
  }
  *q = qq + (r >= D.d - r ? 1 : 0);             // 2r >= d, without overflow
  return true;
}

DA_HD uint64_t da_div_half_up64(uint64_t n, const DaDiv& D) {
  da_u128 r;
  const uint64_t q = da_divrem64(n, D, &r);
  return q + (r >= D.d - r ? 1 : 0);
}

// ---------------------------------------------------------------------------
// a launch's constants
// ---------------------------------------------------------------------------

// One side of da_add (da_split): its scale k digits up, then m down
struct DaSplit {
  int k;
  da_u128 up;                                 // 10^(k - m), where k >= m
  da_u128 frac;                               // 10^k, where k < m
  DaDiv down;                                 // 10^(m - k), where k < m
};

// A launch's constants k, t, m, p (their meaning by function:
// exprs/decimal_arith.py) and what follows from them, the same for every
// row. A power is set only where its exponent is in [0, DA_MAX_DIGITS]
// (the functions test the exponent first).
struct DaConsts {
  int k, t, m, p;
  uint64_t lim_pos, lim_neg;                  // da_limit(p, false / true)
  // mul (k < 0): 10^-k; rescale (k > 0): 10^k; div: 10^|e| (the
  // dividend's for e > 0, the divisor's for e < 0); avg: 10^e; rem: 10^kr
  da_u128 up;
  da_u128 tpow;                               // div, avg: 10^t
  da_u128 post;                               // avg (m < 0): 10^-m
  da_u128 pm;                                 // add: 10^m; rem: 10^kl
  // mul (k > 0): 10^k; rescale (k < 0): 10^-k; avg (m > 0): 10^m;
  // to_double: 10^s (d1, d0 are 10^s 2^(128 - lp), with the bit length lp)
  DaDiv down;
  DaSplit left, right;                        // add: kl, kr
  // add, where one side's scale is 0 and the other's at most 19: 10^kl,
  // 10^kr and 10^m (a divisor; m <= 32)
  int add_direct;
  uint64_t kl_pow, kr_pow;
  DaDiv mdiv;
  double pd;                                  // to_double: 10.0^s, s <= 22
  int lp;
};

// 10^k, k in [0, DA_MAX_DIGITS]: host only, once a launch
inline da_u128 da_pow10(int k) {
  da_u128 p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

// The largest magnitude a result of precision p may take: 10^p - 1, and
// at most 2^63 - 1 (2^63 for a negative result), the int64 lane's
inline uint64_t da_limit(int p, bool neg) {
  const uint64_t cap = neg ? (1ull << 63) : (1ull << 63) - 1;
  if (p >= 19) return cap;
  const uint64_t lim = (uint64_t)da_pow10(p < 0 ? 0 : p) - 1;
  return lim < cap ? lim : cap;
}

inline bool da_in_range(int x) { return x >= 0 && x <= DA_MAX_DIGITS; }

inline DaSplit da_split_consts(int k, int m) {
  DaSplit s = {};
  s.k = k;
  if (k >= m) {
    if (da_in_range(k - m)) s.up = da_pow10(k - m);
  } else if (da_in_range(m - k) && da_in_range(k)) {
    s.frac = da_pow10(k);
    s.down = da_divider(da_pow10(m - k));
  }
  return s;
}

// The constants of a launch of ``op`` with k, t, m, p: on the host, once
inline DaConsts da_consts(int op, int k, int t, int m, int p) {
  DaConsts c = {};
  c.k = k;
  c.t = t;
  c.m = m;
  c.p = p;
  c.lim_pos = da_limit(p, false);
  c.lim_neg = da_limit(p, true);
  if (da_in_range(t)) c.tpow = da_pow10(t);
  switch (op) {
    case DA_MUL:
      if (k > 0 && da_in_range(k)) c.down = da_divider(da_pow10(k));
      if (k < 0 && da_in_range(-k)) c.up = da_pow10(-k);
      break;
    case DA_RESCALE:
      if (k > 0 && da_in_range(k)) c.up = da_pow10(k);
      if (k < 0 && da_in_range(-k)) c.down = da_divider(da_pow10(-k));
      break;
    case DA_DIV:
      if (da_in_range(k < 0 ? -k : k)) c.up = da_pow10(k < 0 ? -k : k);
      break;
    case DA_AVG:
      if (da_in_range(k)) c.up = da_pow10(k);
      if (m > 0 && da_in_range(m)) c.down = da_divider(da_pow10(m));
      if (m < 0 && da_in_range(-m)) c.post = da_pow10(-m);
      break;
    case DA_ADD:
    case DA_SUB:
      if (m >= 0 && m <= 32) {
        c.pm = da_pow10(m);
        c.left = da_split_consts(k, m);
        c.right = da_split_consts(t, m);
        c.add_direct = (k == 0 || t == 0) && da_in_range(k) &&
                       da_in_range(t) && k <= 19 && t <= 19;
        if (c.add_direct) {
          c.kl_pow = (uint64_t)da_pow10(k);
          c.kr_pow = (uint64_t)da_pow10(t);
          c.mdiv = da_divider(c.pm);
        }
      }
      break;
    case DA_REM:
      if (da_in_range(k)) c.pm = da_pow10(k);
      if (da_in_range(t)) c.up = da_pow10(t);
      break;
    default:                                  // DA_TO_DOUBLE, s = k
      if (da_in_range(k)) {
        const da_u128 ps = da_pow10(k);
        c.down = da_divider(ps);
        c.lp = da_bits(ps);
        double pd = 1.0;
        for (int i = 0; i < k && i < 23; ++i) pd *= 10.0;
        c.pd = pd;                            // exact for s <= 22
      }
      break;
  }
  return c;
}

// ---------------------------------------------------------------------------
// the functions
// ---------------------------------------------------------------------------

// a * b into *out; false where the product passes 2^128. One 64 by 64
// bit product where both fit 64 bits, two where one of them does.
DA_HD bool da_mul_fits(da_u128 a, da_u128 b, da_u128* out) {
  const uint64_t ah = (uint64_t)(a >> 64), al = (uint64_t)a;
  const uint64_t bh = (uint64_t)(b >> 64), bl = (uint64_t)b;
  if (!ah && !bh) {
    *out = da_mul_wide(al, bl);
    return true;
  }
  if (ah && bh) return false;
  // x = xh 2^64 + xl times y, xh the one high limb that is not 0
  const uint64_t xh = ah | bh, xl = ah ? al : bl, y = ah ? bl : al;
  const da_u128 cross = da_mul_wide(xh, y);
  if (cross >> 64) return false;
  const da_u128 lo = da_mul_wide(xl, y);
  const da_u128 s = lo + (cross << 64);
  if (s < lo) return false;
  *out = s;
  return true;
}

// The signed result of magnitude mag into *out, or false (NULL) where it
// passes its precision or int64
DA_HD bool da_finish(da_u128 mag, bool neg, const DaConsts& c,
                     int64_t* out) {
  if (mag > (neg ? c.lim_neg : c.lim_pos)) return false;
  const uint64_t m = (uint64_t)mag;
  *out = (int64_t)(neg ? 0ull - m : m);
  return true;
}

// l * r (scales s_l + s_r) at a scale k digits lower, k = s_l + s_r -
// s_out: the exact product (below 2^126, so at most 38 digits: Spark's
// 38-digit MathContext keeps it whole), then rounded once. A negative k
// scales up.
DA_HD bool da_mul(int64_t l, int64_t r, const DaConsts& c, int64_t* out) {
  da_u128 mag = da_mul_wide(da_mag(l), da_mag(r));
  const bool neg = (l < 0) != (r < 0);
  if (c.k > DA_MAX_DIGITS) {
    mag = 0;                          // below 10^38 / 2: rounds to 0
  } else if (c.k > 0) {
    if (!da_div_half_up(mag, c.down, &mag)) return false;
  } else if (c.k < 0 && mag != 0) {
    if (-c.k > DA_MAX_DIGITS || !da_mul_fits(mag, c.up, &mag)) return false;
  }
  return da_finish(mag, neg, c, out);
}

// x (negated where flip) at a scale s.k digits higher, then m digits
// lower (0 <= m <= 32): its integer part *ip and the numerator *fr of its
// fraction over 10^m (|fr| < 10^m), both with x's sign. False where |ip|
// reaches 2^126.
DA_HD bool da_split(int64_t x, bool flip, const DaSplit& s, int m,
                    __int128* ip, __int128* fr) {
  const bool neg = (x < 0) != flip;
  const uint64_t mag = da_mag(x);
  da_u128 i = 0, f = 0;
  if (mag != 0 && s.k >= m) {
    if (s.k - m > DA_MAX_DIGITS || !da_mul_fits(mag, s.up, &i) ||
        (i >> 126))
      return false;
  } else if (mag != 0) {
    da_u128 r;
    i = da_divrem64(mag, s.down, &r);           // r < 2^64
    f = s.k == 0 ? r                            // below 10^m
                 : da_mul_wide((uint64_t)r, (uint64_t)s.frac) +
                       ((da_u128)((uint64_t)r * (uint64_t)(s.frac >> 64))
                        << 64);
  }
  *ip = neg ? -(__int128)i : (__int128)i;
  *fr = neg ? -(__int128)f : (__int128)f;
  return true;
}

// l + r (l - r where sub), l at a scale kl digits higher and r kr digits
// higher (the larger scale), then m digits lower HALF_UP (Spark's
// precision loss; m <= 32 under its rules). The exact sum can pass 2^128
// (a 10^38 rescale of an int64) where the result after m digits fits, so
// each side is split at the result's scale into an integer and a
// fraction over 10^m (da_split), and the sum X + F / 10^m rounded: a
// side whose integer reaches 2^126 makes a result past int64 (the other
// side's is below 2^63), so NULL.
DA_HD bool da_add(int64_t l, int64_t r, bool sub, const DaConsts& c,
                  int64_t* out) {
  if (c.m < 0 || c.m > 32) return false;
  if (c.add_direct) {
    // one side scaled by at most 10^19 (below 2^126.2), the other not:
    // the exact sum fits 127 bits, then one HALF_UP division by 10^m
    const uint64_t ml = da_mag(l), mr = da_mag(r);
    const da_u128 sl = c.k > 0 ? da_mul_wide(ml, c.kl_pow) : (da_u128)ml;
    const da_u128 sr = c.t > 0 ? da_mul_wide(mr, c.kr_pow) : (da_u128)mr;
    const bool nl = l < 0, nr = (r < 0) != sub;
    const __int128 sum = (nl ? -(__int128)sl : (__int128)sl) +
                         (nr ? -(__int128)sr : (__int128)sr);
    const bool neg = sum < 0;
    const da_u128 mag = neg ? (da_u128)0 - (da_u128)sum : (da_u128)sum;
    da_u128 q = mag;
    if (c.m > 0 && !da_div_half_up(mag, c.mdiv, &q)) return false;
    return da_finish(q, neg, c, out);
  }
  __int128 xl, fl, xr, fr;
  if (!da_split(l, false, c.left, c.m, &xl, &fl) ||
      !da_split(r, sub, c.right, c.m, &xr, &fr))
    return false;
  __int128 x = xl + xr, f = fl + fr;            // |x| < 2^127, |f| < 2 10^m
  const __int128 d = (__int128)c.pm;
  if (f >= d) {
    f -= d;
    x += 1;
  } else if (f <= -d) {
    f += d;
    x -= 1;
  }
  // now |f| < 10^m: the value is x + f / 10^m
  const bool xneg = x < 0, fneg = f < 0;
  const da_u128 mx = xneg ? (da_u128)0 - (da_u128)x : (da_u128)x;
  const da_u128 mf = fneg ? (da_u128)0 - (da_u128)f : (da_u128)f;
  const da_u128 half = (da_u128)d - mf;         // 2 mf >= d: mf >= half
  // |x| + |f| / 10^m rounds up where 2 |f| >= 10^m; |x| - |f| / 10^m
  // down where 2 |f| > 10^m (x != 0, f of the other sign)
  const bool same = mx == 0 || mf == 0 || xneg == fneg;
  const da_u128 mag = same ? mx + (mf >= half ? 1 : 0)
                           : mx - (mf > half ? 1 : 0);
  return da_finish(mag, mx == 0 ? fneg : xneg, c, out);
}

// Spark's l % r, both at the larger scale (l kl digits higher, r kr
// digits higher, one of them 0): the exact remainder of the truncated
// quotient, with l's sign. Its magnitude is below both |l| 10^kl and
// |r| 10^kr, so below 2^63, and Spark's result type keeps the larger
// scale. A zero divisor gives NULL. One reciprocal of |r| a row serves
// its three reductions.
DA_HD bool da_rem(int64_t l, int64_t r, const DaConsts& c, int64_t* out) {
  const int kl = c.k, kr = c.t;
  if (r == 0 || kl < 0 || kr < 0 || (kl > 0 && kr > 0) ||
      kl > DA_MAX_DIGITS || kr > DA_MAX_DIGITS)
    return false;
  const uint64_t a = da_mag(l), b = da_mag(r);
  da_u128 rem;
  if (kl > 0) {
    const DaDiv D = da_divider(b);
    if (!(c.pm >> 64)) {
      // 10^kl < 2^64: a 10^kl mod b, the product below 2^127
      da_divrem(da_mul_wide(a, (uint64_t)c.pm), D, &rem);
    } else {
      // (a mod b) (10^kl mod b) mod b: both factors below 2^63
      da_u128 ra, rp;
      da_divrem64(a, D, &ra);
      da_divrem(c.pm, D, &rp);
      da_divrem(da_mul_wide((uint64_t)ra, (uint64_t)rp), D, &rem);
    }
  } else {
    // |r| 10^kr past 2^64 leaves |l| < 2^64 whole
    da_u128 bs;
    if (!da_mul_fits(b, c.up, &bs) || (bs >> 64))
      rem = a;
    else
      da_divrem64(a, da_divider(bs), &rem);
  }
  return da_finish(rem, l < 0, c, out);
}

// Whether a quotient with remainder rem over d rounds up when it is first
// rounded HALF_UP t digits below the result's scale, then HALF_UP to it:
// where its fraction f, rounded at t digits, reaches one half, that is
// where f >= 1/2 - 10^-t / 2, or (d - 2 rem) * 10^t <= d (t = 0: 2 rem
// >= d).
DA_HD bool da_round_up(da_u128 rem, da_u128 d, const DaConsts& c) {
  da_u128 x = d - rem;
  if (rem >= x) return true;          // f >= 1/2
  if (c.t <= 0 || c.t > DA_MAX_DIGITS || c.tpow > d) return false;
  x -= rem;                           // d - 2 rem > 0: x 10^t >= 10^t > d
  da_u128 prod;
  return da_mul_fits(x, c.tpow, &prod) && prod <= d;
}

// Spark's decimal l / r: Java's BigDecimal.divide at scale 38, HALF_UP,
// then HALF_UP again to the result's scale, t = 38 - s_out digits lower.
// The quotient at the result's scale is (l * 10^e) / r, e = s_out + s_r
// - s_l (a negative e multiplies r instead). The first rounding can carry
// into the second (da_round_up). A zero divisor gives NULL.
DA_HD bool da_div(int64_t l, int64_t r, const DaConsts& c, int64_t* out) {
  if (r == 0) return false;
  if (l == 0) return da_finish(0, false, c, out);
  const int e = c.k;
  const bool neg = (l < 0) != (r < 0);
  da_u128 n = da_mag(l), d = da_mag(r);
  if (e > 0) {
    // past 2^128 the quotient passes 2^128 / 2^63: NULL
    if (e > DA_MAX_DIGITS || !da_mul_fits(n, c.up, &n)) return false;
  } else if (e < 0) {
    // a divisor at 2^127 or past leaves a quotient below 2^-64: 0
    if (-e > DA_MAX_DIGITS || !da_mul_fits(d, c.up, &d) || (d >> 127))
      return da_finish(0, false, c, out);
  }
  da_u128 q, rem;
  if (d >> 64) {                      // e < 0: n = |l| < 2^64 <= d
    q = 0;
    rem = n;
  } else {
    // a quotient past 2^64 is NULL: one 2-by-1 step
    if ((uint64_t)(n >> 64) >= (uint64_t)d) return false;
    q = da_divrem_narrow(n, da_divider(d), &rem);
  }
  return da_finish(q + (da_round_up(rem, d, c) ? 1 : 0), neg, c, out);
}

// x at a scale k digits higher (k > 0, exact) or -k digits lower (k < 0,
// HALF_UP)
DA_HD bool da_rescale(int64_t x, const DaConsts& c, int64_t* out) {
  const bool neg = x < 0;
  da_u128 mag = da_mag(x);
  if (c.k > 0 && mag != 0) {
    if (c.k > DA_MAX_DIGITS || !da_mul_fits(mag, c.up, &mag)) return false;
  } else if (c.k < 0) {
    mag = -c.k > DA_MAX_DIGITS ? 0 : da_div_half_up64((uint64_t)mag, c.down);
  }
  return da_finish(mag, neg, c, out);
}

// Spark's average of a decimal: its Divide of the exact total by the
// count, then the cast to the result type. The total is held as three
// limbs (l2 * 10^12 + l1) * 10^12 + l0 (l0, l1 in [0, 10^12)); the
// division's quotient is the total scaled by 10^e over the count, rounded
// at 38 digits, t digits below the division's scale, then to it (as
// da_div); the cast rounds m digits lower HALF_UP (a negative m scales
// up). NULL for no rows, for |l2| >= 2^40, and where the scaled total
// passes 2^128. (The division's own precision check never binds where
// the cast's does not: its type holds the input's integral digits.)
DA_HD bool da_avg(int64_t l0, int64_t l1, int64_t l2, int64_t count,
                  const DaConsts& c, int64_t* out) {
  if (count <= 0) return false;
  if (l2 >= ((int64_t)1 << 40) || l2 <= -((int64_t)1 << 40)) return false;
  // (l2 10^12 + l1) 10^12 + l0 (below 2^121) from 64 by 64 bit products:
  // |l2| 10^24 (10^24's two limbs times |l2|), then l1 10^12 + l0
  const da_u128 p24 = (da_u128)DA_LIMB * DA_LIMB;
  const uint64_t m2 = da_mag(l2);
  const da_u128 h = da_mul_wide(m2, (uint64_t)p24) +
                    ((da_u128)(m2 * (uint64_t)(p24 >> 64)) << 64);
  bool neg;
  da_u128 n;
  if ((uint64_t)l0 < DA_LIMB && (uint64_t)l1 < DA_LIMB) {
    // the limbs of a SUM: l1 10^12 + l0 < 10^24 <= |l2| 10^24 unless
    // l2 = 0, so the total has l2's sign
    const da_u128 low = da_mul_wide((uint64_t)l1, DA_LIMB) + (uint64_t)l0;
    neg = l2 < 0;
    n = neg ? h - low : h + low;
  } else {
    const __int128 total = (l2 < 0 ? -(__int128)h : (__int128)h) +
                           da_smul_wide(l1, DA_LIMB) + l0;
    neg = total < 0;
    n = neg ? (da_u128)0 - (da_u128)total : (da_u128)total;
  }
  if (n == 0) return da_finish(0, false, c, out);
  if (c.k > 0 && (c.k > DA_MAX_DIGITS || !da_mul_fits(n, c.up, &n)))
    return false;
  da_u128 rem;
  const da_u128 d = (da_u128)count;
  da_u128 q = da_divrem(n, da_divider(d), &rem);
  q += da_round_up(rem, d, c) ? 1 : 0;
  if (c.m > 0) {
    if (c.m > DA_MAX_DIGITS)
      q = 0;
    else if (!da_div_half_up(q, c.down, &q))
      return false;
  } else if (c.m < 0 && q != 0) {
    if (-c.m > DA_MAX_DIGITS || !da_mul_fits(q, c.post, &q)) return false;
  }
  return da_finish(q, neg, c, out);
}

// The double nearest u / 10^s (s = c.k in [0, 38], u >= 1), ties to
// even, in integers: u is brought to [2^62, 2^63) (un = u << z, z = 63 -
// bits), and Q = floor(un 2^(lp - 8) / 10^s), lp the bit length of 10^s,
// has 55 or 56 bits. Q with its last bit set where the remainder is not 0
// (two bits or more below the double's last, so it breaks a tie and
// nothing else), converted to double with the conversion's own rounding
// to nearest even, is the nearest double to Q and the fraction, scaled by
// 2^-(lp - 8 + z). With 10^s 2^(128 - lp) (two limbs, its top bit set;
// the low one 0 for s <= 19) as the divisor, Q is un 2^120 over it: one
// 3-by-2 step, or one 2-by-1 step.
DA_HD double da_to_double_int(uint64_t u, const DaConsts& c) {
  const int z = da_clz(u) - 1;               // -1 only for 2^63
  const uint64_t un = z >= 0 ? u << z : u >> 1;
  uint64_t Q;
  bool sticky;
  if (c.down.wide) {
    da_u128 rem;
    Q = da_div32(un >> 8, un << 56, 0, c.down.d1, c.down.d0, c.down.v,
                 &rem);
    sticky = rem != 0;
  } else {
    uint64_t r;
    Q = da_div21(un >> 8, un << 56, c.down.d1, c.down.v, &r);
    sticky = r != 0;
  }
  // times 2^e, a normal double's power (e in [-181, 8]): exact
  const int e = 8 - c.lp - z;
  return (double)(Q | (sticky ? 1 : 0)) *
         da_bits_double((uint64_t)(e + 1023) << 52);
}

// Java's BigDecimal.doubleValue of x / 10^s: below 2^53 and for s <= 22
// both operands are exact doubles and one IEEE division rounds once;
// else da_to_double_int. Both give the nearest double, so on the device a
// warp with any row past the exact doubles takes the integer path for
// all its rows, and no warp runs both.
DA_HD double da_to_double(int64_t x, const DaConsts& c) {
  const uint64_t u = da_mag(x);
  bool exact = u < (1ull << 53) && c.k <= 22;
#ifdef __CUDA_ARCH__
  exact = __all_sync(__activemask(), exact);
#endif
  double out;
  if (exact)
    out = (double)u / c.pd;
  else
    out = da_to_double_int(u | (u == 0), c);
  return x == 0 ? 0.0 : (x < 0 ? -out : out);
}

// One row of a launch of ``op`` with its constants ``c``, over the int64
// operands a..d (their meaning by op: exprs/decimal_arith.py), into *out
// (for DA_TO_DOUBLE the double's bits). Returns the result's validity.
// In the kernel op is a template parameter: one body a launch.
DA_HD bool da_row_c(int op, const DaConsts& c, int64_t a, int64_t b,
                    int64_t cc, int64_t d, int64_t* out) {
  switch (op) {
    case DA_MUL:
      return da_mul(a, b, c, out);
    case DA_DIV:
      return da_div(a, b, c, out);
    case DA_RESCALE:
      return da_rescale(a, c, out);
    case DA_AVG:
      return da_avg(a, b, cc, d, c, out);
    case DA_ADD:
    case DA_SUB:
      return da_add(a, b, op == DA_SUB, c, out);
    case DA_REM:
      return da_rem(a, b, c, out);
    default: {
      const double v = da_to_double(a, c);
#ifdef __CUDA_ARCH__
      *out = __double_as_longlong(v);
#else
      memcpy(out, &v, sizeof v);
#endif
      return true;
    }
  }
}

// One row of ``op`` with the launch's constants k, t, m, p: the
// constants made (da_consts), then da_row_c. Host only: a launch makes
// its constants once.
inline bool da_row(int op, int64_t a, int64_t b, int64_t c, int64_t d,
                   int k, int t, int m, int p, int64_t* out) {
  const DaConsts consts = da_consts(op, k, t, m, p);
  return da_row_c(op, consts, a, b, c, d, out);
}

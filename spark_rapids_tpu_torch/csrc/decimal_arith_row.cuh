// The per-row logic of the decimal_arith kernel (csrc/decimal_arith.cu):
// Spark's decimal add, subtract, remainder, multiply, divide, rescale and
// average, and Java's BigDecimal.doubleValue, over decimals held as their unscaled values in
// int64 lanes (types.py DecimalType). Intermediates are 128-bit
// (unsigned __int128, which nvcc and g++ both take).
// Everything here is __host__ __device__, so g++ builds it on a machine
// without CUDA and the tests hold it to the plain version and to Python's
// decimal arithmetic (tests/test_torch_decimal_arith.py).
//
// Rounding is HALF_UP (a tie rounds away from zero): magnitudes are
// rounded, then the sign is put back. A result whose magnitude passes its
// declared precision p (10^p - 1) or int64 is NULL, Spark's non-ANSI
// overflow answer: every function returns whether its result is valid.
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

// 10^k, k in [0, DA_MAX_DIGITS]
DA_HD da_u128 da_pow10(int k) {
  da_u128 p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

// |x| as an unsigned 64-bit value (|INT64_MIN| = 2^63 included)
DA_HD uint64_t da_mag(int64_t x) {
  return x < 0 ? 0ull - (uint64_t)x : (uint64_t)x;
}

// The bit length of v (0 for 0)
DA_HD int da_bits(da_u128 v) {
  const uint64_t hi = (uint64_t)(v >> 64), lo = (uint64_t)v;
#ifdef __CUDA_ARCH__
  if (hi) return 128 - __clzll((long long)hi);
  return lo ? 64 - __clzll((long long)lo) : 0;
#else
  if (hi) return 128 - __builtin_clzll(hi);
  return lo ? 64 - __builtin_clzll(lo) : 0;
#endif
}

// floor(n / d), with n mod d in *rem, for d in [1, 2^127): one hardware
// 64-bit division where both fit 64 bits, else restoring division over
// n's bits (the remainder stays below 2d < 2^128).
DA_HD da_u128 da_divmod(da_u128 n, da_u128 d, da_u128* rem) {
  if ((n >> 64) == 0 && (d >> 64) == 0) {
    const uint64_t q = (uint64_t)n / (uint64_t)d;
    *rem = n - (da_u128)q * d;
    return q;
  }
  if (n < d) {
    *rem = n;
    return 0;
  }
  da_u128 q = 0, r = 0;
  for (int i = da_bits(n) - 1; i >= 0; --i) {
    r = (r << 1) | ((n >> i) & 1);
    if (r >= d) {
      r -= d;
      q |= (da_u128)1 << i;
    }
  }
  *rem = r;
  return q;
}

// n / d rounded HALF_UP (magnitudes; d in [1, 2^127))
DA_HD da_u128 da_div_half_up(da_u128 n, da_u128 d) {
  da_u128 r;
  const da_u128 q = da_divmod(n, d, &r);
  return q + (r >= d - r ? 1 : 0);           // 2r >= d, without overflow
}

// a * b into *out; false where the product passes 2^128
DA_HD bool da_mul_fits(da_u128 a, da_u128 b, da_u128* out) {
  const uint64_t ah = (uint64_t)(a >> 64), al = (uint64_t)a;
  const uint64_t bh = (uint64_t)(b >> 64), bl = (uint64_t)b;
  if (ah && bh) return false;
  const da_u128 cross = (da_u128)ah * bl + (da_u128)al * bh;  // one is 0
  if (cross >> 64) return false;
  const da_u128 lo = (da_u128)al * bl;
  const da_u128 s = lo + (cross << 64);
  if (s < lo) return false;
  *out = s;
  return true;
}

// The largest magnitude a result of precision p may take: 10^p - 1, and
// at most 2^63 - 1 (2^63 for a negative result), the int64 lane's
DA_HD da_u128 da_limit(int p, bool neg) {
  const da_u128 cap = neg ? ((da_u128)1 << 63) : (((da_u128)1 << 63) - 1);
  if (p >= 19) return cap;
  const da_u128 lim = da_pow10(p) - 1;
  return lim < cap ? lim : cap;
}

// The signed result of magnitude mag into *out, or false (NULL) where it
// passes its precision or int64
DA_HD bool da_finish(da_u128 mag, bool neg, int p, int64_t* out) {
  if (mag > da_limit(p, neg)) return false;
  const uint64_t m = (uint64_t)mag;
  *out = (int64_t)(neg ? 0ull - m : m);
  return true;
}

// l * r (scales s_l + s_r) at a scale k digits lower, k = s_l + s_r -
// s_out: the exact product (below 2^126, so at most 38 digits: Spark's
// 38-digit MathContext keeps it whole), then rounded once. A negative k
// scales up.
DA_HD bool da_mul(int64_t l, int64_t r, int k, int p, int64_t* out) {
  da_u128 mag = (da_u128)da_mag(l) * da_mag(r);
  const bool neg = (l < 0) != (r < 0);
  if (k > DA_MAX_DIGITS) {
    mag = 0;                          // below 10^38 / 2: rounds to 0
  } else if (k > 0) {
    mag = da_div_half_up(mag, da_pow10(k));
  } else if (k < 0 && mag != 0) {
    if (-k > DA_MAX_DIGITS || !da_mul_fits(mag, da_pow10(-k), &mag))
      return false;
  }
  return da_finish(mag, neg, p, out);
}

// x (negated where flip) at a scale k digits higher, then m digits lower
// (0 <= m <= 32): its integer part *ip and the numerator *fr of its
// fraction over 10^m (|fr| < 10^m), both with x's sign. False where |ip|
// reaches 2^126.
DA_HD bool da_split(int64_t x, bool flip, int k, int m, __int128* ip,
                    __int128* fr) {
  const bool neg = (x < 0) != flip;
  const da_u128 mag = da_mag(x);
  da_u128 i = 0, f = 0;
  if (mag != 0 && k >= m) {
    if (k - m > DA_MAX_DIGITS || !da_mul_fits(mag, da_pow10(k - m), &i) ||
        (i >> 126))
      return false;
  } else if (mag != 0) {
    da_u128 r;
    i = da_divmod(mag, da_pow10(m - k), &r);
    f = r * da_pow10(k);                        // below 10^m
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
DA_HD bool da_add(int64_t l, int64_t r, bool sub, int kl, int kr, int m,
                  int p, int64_t* out) {
  if (m < 0 || m > 32) return false;
  __int128 xl, fl, xr, fr;
  if (!da_split(l, false, kl, m, &xl, &fl) ||
      !da_split(r, sub, kr, m, &xr, &fr))
    return false;
  __int128 x = xl + xr, f = fl + fr;            // |x| < 2^127, |f| < 2 10^m
  const __int128 d = (__int128)da_pow10(m);
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
  if (mx == 0) return da_finish(mf >= half ? 1 : 0, fneg, p, out);
  if (mf == 0 || xneg == fneg)                  // |x| + |f| / 10^m
    return da_finish(mx + (mf >= half ? 1 : 0), xneg, p, out);
  return da_finish(mx - (mf > half ? 1 : 0), xneg, p, out);  // |x| - ...
}

// Spark's l % r, both at the larger scale (l kl digits higher, r kr
// digits higher, one of them 0): the exact remainder of the truncated
// quotient, with l's sign. Its magnitude is below both |l| 10^kl and
// |r| 10^kr, so below 2^63, and Spark's result type keeps the larger
// scale. A zero divisor gives NULL.
DA_HD bool da_rem(int64_t l, int64_t r, int kl, int kr, int p,
                  int64_t* out) {
  if (r == 0 || kl < 0 || kr < 0 || (kl > 0 && kr > 0) ||
      kl > DA_MAX_DIGITS || kr > DA_MAX_DIGITS)
    return false;
  const da_u128 a = da_mag(l), b = da_mag(r);
  da_u128 rem;
  if (kl > 0) {
    // (a mod b) (10^kl mod b) mod b: both factors below 2^63
    da_u128 ra, rp;
    da_divmod(a, b, &ra);
    da_divmod(da_pow10(kl), b, &rp);
    da_divmod(ra * rp, b, &rem);
  } else {
    da_u128 bs;
    if (!da_mul_fits(b, da_pow10(kr), &bs))
      rem = a;                                  // |r| 10^kr > 2^128 > |l|
    else
      da_divmod(a, bs, &rem);
  }
  return da_finish(rem, l < 0, p, out);
}

// Whether a quotient with remainder rem over d rounds up when it is first
// rounded HALF_UP t digits below the result's scale, then HALF_UP to it:
// where its fraction f, rounded at t digits, reaches one half, that is
// where f >= 1/2 - 10^-t / 2, or (d - 2 rem) * 10^t <= d (t = 0: 2 rem
// >= d).
DA_HD bool da_round_up(da_u128 rem, da_u128 d, int t) {
  da_u128 x = d - rem;
  if (rem >= x) return true;          // f >= 1/2
  if (t <= 0) return false;
  x -= rem;                           // d - 2 rem > 0
  da_u128 prod;
  return t <= DA_MAX_DIGITS && da_mul_fits(x, da_pow10(t), &prod) &&
         prod <= d;
}

// Spark's decimal l / r: Java's BigDecimal.divide at scale 38, HALF_UP,
// then HALF_UP again to the result's scale, t = 38 - s_out digits lower.
// The quotient at the result's scale is (l * 10^e) / r, e = s_out + s_r
// - s_l (a negative e multiplies r instead). The first rounding can carry
// into the second (da_round_up). A zero divisor gives NULL.
DA_HD bool da_div(int64_t l, int64_t r, int e, int t, int p, int64_t* out) {
  if (r == 0) return false;
  if (l == 0) return da_finish(0, false, p, out);
  const bool neg = (l < 0) != (r < 0);
  da_u128 n = da_mag(l), d = da_mag(r);
  if (e > 0) {
    // past 2^128 the quotient passes 2^128 / 2^63: NULL
    if (e > DA_MAX_DIGITS || !da_mul_fits(n, da_pow10(e), &n)) return false;
  } else if (e < 0) {
    // a divisor at 2^127 or past leaves a quotient below 2^-64: 0
    if (-e > DA_MAX_DIGITS || !da_mul_fits(d, da_pow10(-e), &d) ||
        (d >> 127))
      return da_finish(0, false, p, out);
  }
  da_u128 rem;
  const da_u128 q = da_divmod(n, d, &rem);
  return da_finish(q + (da_round_up(rem, d, t) ? 1 : 0), neg, p, out);
}

// x at a scale k digits higher (k > 0, exact) or -k digits lower (k < 0,
// HALF_UP)
DA_HD bool da_rescale(int64_t x, int k, int p, int64_t* out) {
  const bool neg = x < 0;
  da_u128 mag = da_mag(x);
  if (k > 0 && mag != 0) {
    if (k > DA_MAX_DIGITS || !da_mul_fits(mag, da_pow10(k), &mag))
      return false;
  } else if (k < 0) {
    mag = -k > DA_MAX_DIGITS ? 0 : da_div_half_up(mag, da_pow10(-k));
  }
  return da_finish(mag, neg, p, out);
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
DA_HD bool da_avg(int64_t l0, int64_t l1, int64_t l2, int64_t count, int e,
                  int t, int m, int p, int64_t* out) {
  if (count <= 0) return false;
  if (l2 >= ((int64_t)1 << 40) || l2 <= -((int64_t)1 << 40)) return false;
  const __int128 total =
      ((__int128)l2 * DA_LIMB + l1) * DA_LIMB + l0;     // below 2^120
  if (total == 0) return da_finish(0, false, p, out);
  const bool neg = total < 0;
  da_u128 n = neg ? (da_u128)0 - (da_u128)total : (da_u128)total;
  if (e > 0 && (e > DA_MAX_DIGITS || !da_mul_fits(n, da_pow10(e), &n)))
    return false;
  da_u128 rem;
  const da_u128 d = (da_u128)count;
  da_u128 q = da_divmod(n, d, &rem);
  q += da_round_up(rem, d, t) ? 1 : 0;
  if (m > 0) {
    q = m > DA_MAX_DIGITS ? 0 : da_div_half_up(q, da_pow10(m));
  } else if (m < 0 && q != 0) {
    if (-m > DA_MAX_DIGITS || !da_mul_fits(q, da_pow10(-m), &q)) return false;
  }
  return da_finish(q, neg, p, out);
}

// 10.0^s, exact for s <= 22
DA_HD double da_pow10_double(int s) {
  double p = 1.0;
  for (int i = 0; i < s; ++i) p *= 10.0;
  return p;
}

// Java's BigDecimal.doubleValue of x / 10^s (s in [0, 38]): the double
// nearest the exact quotient, ties to even. Below 2^53 and for s <= 22
// both operands are exact doubles and one IEEE division rounds once.
// Else |x| is brought to [2^62, 2^63) (x << z, z = 63 - bits), and
// Q = floor(|x| << z << (lp - 8) / 10^s), lp the bit length of 10^s, has
// 55 or 56 bits: its top 53, rounded by the bits below and the
// remainder, scaled by 2^-(lp - 8 + z).
DA_HD double da_to_double(int64_t x, int s) {
  if (x == 0) return 0.0;
  const bool neg = x < 0;
  const uint64_t u = da_mag(x);
  double out;
  if (u < (1ull << 53) && s <= 22) {
    out = (double)u / da_pow10_double(s);
  } else {
    const int lu = da_bits((da_u128)u);
    const int z = 63 - lu;                   // -1 only for 2^63
    const uint64_t un = z >= 0 ? u << z : u >> 1;
    const da_u128 D = da_pow10(s);
    const int lp = da_bits(D);
    da_u128 Q, rem;
    if (lp < 8) {
      Q = da_divmod((da_u128)un, D << (8 - lp), &rem);
    } else if (lp - 8 < 56) {
      Q = da_divmod((da_u128)un << (lp - 8), D, &rem);
    } else {
      // the dividend passes 2^128, but its top bits over D are below D
      // and its low 56 bits are zero
      rem = (da_u128)un << (lp - 64);
      Q = 0;
      for (int i = 0; i < 56; ++i) {
        rem <<= 1;
        Q <<= 1;
        if (rem >= D) {
          rem -= D;
          Q |= 1;
        }
      }
    }
    const int sh = da_bits(Q) - 53;          // 2 or 3
    uint64_t mant = (uint64_t)(Q >> sh);
    const uint64_t dropped = (uint64_t)Q & ((1ull << sh) - 1);
    const uint64_t half = 1ull << (sh - 1);
    if (dropped > half || (dropped == half && (rem != 0 || (mant & 1))))
      ++mant;
    out = ldexp((double)mant, sh - (lp - 8) - z);
  }
  return neg ? -out : out;
}

// One row of a launch: ``op`` over its int64 operands a..d with the
// launch's constants k, t, m, p (their meaning by op:
// exprs/decimal_arith.py) into *out (for DA_TO_DOUBLE the double's bits).
// Returns the result's validity.
DA_HD bool da_row(int op, int64_t a, int64_t b, int64_t c, int64_t d, int k,
                  int t, int m, int p, int64_t* out) {
  switch (op) {
    case DA_MUL:
      return da_mul(a, b, k, p, out);
    case DA_DIV:
      return da_div(a, b, k, t, p, out);
    case DA_RESCALE:
      return da_rescale(a, k, p, out);
    case DA_AVG:
      return da_avg(a, b, c, d, k, t, m, p, out);
    case DA_ADD:
    case DA_SUB:
      return da_add(a, b, op == DA_SUB, k, t, m, p, out);
    case DA_REM:
      return da_rem(a, b, k, t, p, out);
    default: {
      const double v = da_to_double(a, k);
#ifdef __CUDA_ARCH__
      *out = __double_as_longlong(v);
#else
      memcpy(out, &v, sizeof v);
#endif
      return true;
    }
  }
}

"""Number formatting for report files: a semantic port of the reference's
dtoa_g (2.0/include/plink2_string.cc:2507, dtoa_so6 :2297, BankerRoundD*
:2234-2296): 6-significant-digit shortest formatting where the scaled double
is rounded with a banker's band of +/-5e-9 around .5 ties (kBankerRound8).
Bit-identical output requires reproducing both this rounding and the
caller's floating-point expression order.
"""

from __future__ import annotations

import numpy as np

_BR8 = (0.499999995, 0.500000005)


def _broundd(d: float) -> int:
    i = int(d)
    return i + int((d - i) + _BR8[i & 1])


_SMALL_LADDER = (
    (9.9999949999999e-16, 1e16, 16),
    (9.9999949999999e-8, 1e8, 8),
    (9.9999949999999e-4, 1e4, 4),
    (9.9999949999999e-2, 1e2, 2),
    (9.9999949999999e-1, 1e1, 1),
)
_BIG_LADDER = (
    (9.9999949999999e15, 1e-16, 16),
    (9.9999949999999e7, 1e-8, 8),
    (9.9999949999999e3, 1e-4, 4),
    (9.9999949999999e1, 1e-2, 2),
    (9.9999949999999e0, 1e-1, 1),
)


def _mantissa_1p5(dxx: float) -> str:
    """1 leading digit + up to 5 decimals, trailing zeros stripped."""
    r = _broundd(dxx * 100000.0)
    q, rem = divmod(r, 100000)
    if not rem:
        return str(q)
    s = f"{q}.{rem:05d}".rstrip("0")
    return s


def dtoa_g(x: float) -> str:
    if x != x:
        return "nan"
    sign = ""
    if x < 0:
        sign = "-"
        x = -x
    if x < 9.9999949999999e-5:
        if x == 0.0:
            return "0"
        xp10 = 0
        # extra deep-subnormal rungs (e-128 / e-256)
        if x < 9.9999949999999e-128:
            if x < 9.9999949999999e-256:
                x *= 1.0e256
                xp10 |= 256
            else:
                x *= 1.0e128
                xp10 |= 128
        if x < 9.9999949999999e-64:
            x *= 1.0e64
            xp10 |= 64
        if x < 9.9999949999999e-32:
            x *= 1.0e32
            xp10 |= 32
        for thresh, mult, bits in _SMALL_LADDER:
            if x < thresh:
                x *= mult
                xp10 |= bits
        return f"{sign}{_mantissa_1p5(x)}e-{xp10:02d}"
    if x >= 999999.49999999:
        if x > np.finfo(np.float64).max:
            return sign + "inf"
        xp10 = 0
        if x >= 9.9999949999999e127:
            if x >= 9.9999949999999e255:
                x *= 1.0e-256
                xp10 |= 256
            else:
                x *= 1.0e-128
                xp10 |= 128
        if x >= 9.9999949999999e63:
            x *= 1.0e-64
            xp10 |= 64
        if x >= 9.9999949999999e31:
            x *= 1.0e-32
            xp10 |= 32
        for thresh, mult, bits in _BIG_LADDER:
            if x >= thresh:
                x *= mult
                xp10 |= bits
        return f"{sign}{_mantissa_1p5(x)}e+{xp10:02d}"
    if x >= 0.99999949999999:
        # dtoa_so6: decimals shrink as magnitude grows.
        if x < 9.9999949999999:
            return sign + _mantissa_1p5(x)
        for bound, scale, digits in (
            (99.999949999999, 10000.0, 4),
            (999.99949999999, 1000.0, 3),
            (9999.9949999999, 100.0, 2),
            (99999.949999999, 10.0, 1),
        ):
            if x < bound:
                r = _broundd(x * scale)
                q, rem = divmod(r, int(scale))
                if not rem:
                    return f"{sign}{q}"
                s = f"{q}.{rem:0{digits}d}".rstrip("0")
                return sign + s
        return f"{sign}{_broundd(x)}"
    # 6 sig fig decimal in [~1e-4, 1).
    prefix = "0."
    if x < 9.9999949999999e-3:
        x *= 100
        prefix += "00"
    if x < 9.9999949999999e-2:
        x *= 10
        prefix += "0"
    r = _broundd(x * 1000000.0)
    s = f"{r:06d}".rstrip("0")
    return f"{sign}{prefix}{s}"


_BANKER_LADDER_P3 = (
    # (upper bound on |x|, banker band half-widths) per 1.9 dtoa_f_p3
    (99.999499999999, (0.4999999995, 0.5000000005)),   # banker_round9
    (999.99949999999, (0.499999995, 0.500000005)),     # banker_round8
    (9999.9994999999, (0.49999995, 0.50000005)),       # banker_round7
    (99999.999499999, (0.4999995, 0.5000005)),         # banker_round6
    (999999.99949999, (0.499995, 0.500005)),           # banker_round5
)


def dtoa_f_p3(x: float) -> str:
    """Fixed 3-decimal formatting, parity with 1.9 dtoa_f_p3
    (1.9/plink_common.c:2260): banker-rounding band narrows as the
    integer part grows."""
    if x != x:
        return "nan"
    sign = ""
    if x < 0:
        sign = "-"
        x = -x
    if x < 9.9994999999999:
        band = (0.49999999995, 0.50000000005)  # banker_round10
    else:
        for bound, b in _BANKER_LADDER_P3:
            if x < bound:
                band = b
                break
        else:
            if x == float("inf"):
                return sign + "inf"
            return f"{sign}{x:.3f}"
    d = x * 1000.0
    r = int(d)
    r += int((d - r) + band[r & 1])
    q, rem = divmod(r, 1000)
    return f"{sign}{q}.{rem:03d}"


def g6(x: float) -> str:
    if x != x:
        return "NA"
    return dtoa_g(float(x))


def g6_vec(xs) -> list[str]:
    return [g6(float(x)) for x in np.asarray(xs)]


def pval_str(p: float) -> str:
    if p != p:
        return "NA"
    return dtoa_g(float(p))


# exact binary64 constants from the reference (2.0/include/plink2_float.h)
_KLN10 = 2.3025850929940457
_KRECIP_LN10 = 0.43429448190325176


def logp_to_str(logp: float) -> str:
    """Format exp(logp) the way the reference's lntoa_g
    (2.0/include/plink2_string.cc:2876) does: stays nonzero below DBL_MIN
    by switching to mantissa x 10^-exp notation, distinguishing 1e-325
    from 1e-1000000 (2.0/README.md:96-100).

    The in-range branch (where exp() doesn't underflow) matches the
    reference through dtoa_g of the exponentiated value and is covered by
    the GLM/adjust byte-parity suites; the extreme branch reproduces
    lntoa_g's fma/truncation/banker-rounding sequence exactly."""
    if logp != logp:
        return "NA"
    log10p = logp / np.log(10.0)
    if log10p > -300:
        return dtoa_g(float(np.exp(logp)))
    if logp < 0x7FFFFFFB * -_KLN10:
        # exponent would overflow int32 (lntoa_g guard)
        return "0"
    # xp10 = (int32)fma(ln, 1/ln10, 5.000001349509205e-7/ln10), truncation
    # toward zero; 80-bit long-double emulation of the fma is exact to
    # 2^-64 relative, far inside the +5e-7 guard band
    ld = np.longdouble
    xp10 = int(ld(logp) * ld(_KRECIP_LN10)
               + ld(5.000001349509205e-7) * ld(_KRECIP_LN10))
    mant = float(np.exp(np.float64(ld(xp10) * ld(-_KLN10) + ld(logp))))
    if mant < 0.99999949999999:
        mant *= 10
        xp10 -= 1
    elif mant > 9.9999949999999:
        mant *= 0.1
        xp10 += 1
    # BankerRoundD5 + qrtoa_1p5 (plink2_string.cc:2273,2930)
    dxx = mant * 100000
    rem = int(dxx)
    rem += int((dxx - float(rem)) + (0.500000005 if rem & 1
                                     else 0.499999995))
    q, r = rem // 100000, rem % 100000
    s = _qrtoa_1p5(q, r)
    if xp10 < 0:
        return s + ("e-0" + str(-xp10) if xp10 > -10
                    else "e-" + str(-xp10))
    return s + ("e+0" + str(xp10) if xp10 < 10 else "e+" + str(xp10))


def _float_round(f) -> int:
    """1.9 float_round (plink_common.c:1690): (int)(f + 0.5) with the
    0.5 added in double."""
    return int(float(f) + 0.5)


def _qrtoa_1p5(q: int, r: int) -> str:
    """qrtoa_1p5 (plink_common.c:1466): 'q.rrrrr' with 2-digit-pair
    trailing-zero trimming."""
    out = str(q)
    if not r:
        return out
    out += "."
    q2 = r // 1000
    rem = r - 1000 * q2
    pairs = f"{q2:02d}"
    if rem:
        q3 = rem // 10
        rem2 = rem - 10 * q3
        pairs += f"{q3:02d}"
        if rem2:
            return out + pairs + str(rem2)
    if pairs[-1] == "0":
        pairs = pairs[:-1]
    return out + pairs


def _uitoa_trunc6(u: int) -> str:
    """uitoa_trunc6 (plink_common.c:1376)."""
    q = u // 10000
    out = f"{q:02d}"
    u -= 10000 * q
    if u:
        q2 = u // 100
        out += f"{q2:02d}"
        u -= 100 * q2
        if u:
            out += f"{u:02d}"
    if out[-1] == "0":
        out = out[:-1]
    return out


def _ftoa_so6(f) -> str:
    """ftoa_so6 (plink_common.c:1730): 6-sig-fig float in [1, 999999.44)."""
    F = np.float32
    d = float(f)
    if d < 99.999944:
        if d < 9.9999944:
            r = _float_round(F(f * F(100000)))
            return _qrtoa_1p5(r // 100000, r % 100000)
        r = _float_round(F(f * F(10000)))
        q, rem = r // 10000, r % 10000
        out = f"{q:02d}"
        if not rem:
            return out
        out += "."
        q2 = rem // 100
        rem -= 100 * q2
        out += f"{q2:02d}"
        if rem:
            out += f"{rem:02d}"
        if out[-1] == "0":
            out = out[:-1]
        return out
    if d < 9999.9944:
        if d < 999.99944:
            r = _float_round(F(f * F(1000)))
            uii, rem = r // 1000, r % 1000
            out = f"{uii:03d}"
            if not rem:
                return out
            out += "."
            q = rem // 10
            rem -= 10 * q
            out += f"{q:02d}"
            if rem:
                return out + str(rem)
            if out[-1] == "0":
                out = out[:-1]
            return out
        r = _float_round(F(f * F(100)))
        uii, rem = r // 100, r % 100
        out = f"{uii:04d}"
        if not rem:
            return out
        out += "." + f"{rem:02d}"
        if out[-1] == "0":
            out = out[:-1]
        return out
    if d < 99999.944:
        r = _float_round(F(f * F(10)))
        uii, rem = r // 10, r % 10
        out = f"{uii:05d}"
        if not rem:
            return out
        return out + "." + str(rem)
    return f"{_float_round(f):06d}"


def ftoa_g(x) -> str:
    """1.9 ftoa_g (plink_common.c): float-precision %g-style shortest
    form.  The input is quantized to float32 and every scaling multiply
    follows the reference's float/double promotion rules exactly."""
    F = np.float32
    f = F(x)
    if f != f:
        return "nan"
    sign = ""
    if f < 0:
        sign = "-"
        f = -f
    d = float(f)
    if d < 9.9999944e-5:
        xp10 = 0
        if d < 9.9999944e-16:
            if f == 0.0:
                return sign + "0"
            if d < 9.9999944e-32:
                f = F(float(f) * 1.0e32)
                xp10 |= 32
            else:
                f = F(float(f) * 1.0e16)
                xp10 |= 16
        if float(f) < 9.9999944e-8:
            f = F(f * F(100000000))
            xp10 |= 8
        if float(f) < 9.9999944e-4:
            f = F(f * F(10000))
            xp10 |= 4
        if float(f) < 9.9999944e-2:
            f = F(f * F(100))
            xp10 |= 2
        if float(f) < 9.9999944e-1:
            f = F(f * F(10))
            xp10 += 1
        r = _float_round(F(f * F(100000)))
        return (sign + _qrtoa_1p5(r // 100000, r % 100000)
                + f"e-{xp10:02d}")
    if d >= 999999.44:
        xp10 = 0
        if d >= 9.9999944e15:
            if f == np.inf:
                return sign + "inf"
            if d >= 9.9999944e31:
                f = F(float(f) * 1.0e-32)
                xp10 |= 32
            else:
                f = F(float(f) * 1.0e-16)
                xp10 |= 16
        if float(f) >= 9.9999944e7:
            f = F(float(f) * 1.0e-8)
            xp10 |= 8
        if float(f) >= 9.9999944e3:
            f = F(float(f) * 1.0e-4)
            xp10 |= 4
        if float(f) >= 9.9999944e1:
            f = F(float(f) * 1.0e-2)
            xp10 |= 2
        if float(f) >= 9.9999944e0:
            f = F(float(f) * 1.0e-1)
            xp10 += 1
        r = _float_round(F(f * F(100000)))
        return (sign + _qrtoa_1p5(r // 100000, r % 100000)
                + f"e+{xp10:02d}")
    if d >= 0.99999944:
        return sign + _ftoa_so6(f)
    out = "0."
    if float(f) < 9.9999944e-3:
        f = F(f * F(100))
        out += "00"
    if float(f) < 9.9999944e-2:
        f = F(f * F(10))
        out += "0"
    return sign + out + _uitoa_trunc6(_float_round(F(f * F(1000000))))


_BANKER7 = (0.49999995, 0.50000005)


def dtoa_f_w9p6(x: float) -> str:
    """1.9 dtoa_f_w9p6 (plink_common.c): ' q.rrrrrr' fixed-width for
    |x| < 10 (the only range the twolocus proportions use)."""
    if x != x:
        return "      nan"
    sign = " "
    if x < 0:
        sign = "-"
        x = -x
    d = x * 1000000
    r = int(d)
    r += int((d - r) + _BANKER7[r & 1])
    q, rem = divmod(r, 1000000)
    return f"{sign}{q}.{rem:06d}"


def dtoa_f_w9p6_spaced(x: float) -> str:
    """Trailing zeroes (and a bare '.') become spaces when the value
    is an exact multiple of 1e-5 (1.9 dtoa_f_w9p6_spaced)."""
    s = dtoa_f_w9p6(x)
    dyy = x * 100000 + 0.00000005
    if dyy - int(dyy) >= 0.0000001:
        return s
    t = s.rstrip("0")
    if t.endswith("."):
        t = t[:-1]
    return t + " " * (len(s) - len(t))


def dtoa_f_w9p6_clipped(x: float) -> str:
    s = dtoa_f_w9p6(x)
    dyy = x * 100000 + 0.00000005
    if dyy - int(dyy) >= 0.0000001:
        return s
    t = s.rstrip("0")
    if t.endswith("."):
        t = t[:-1]
    return t


def _g_wxp_generic(x: float, width: int, mant: str, band: tuple,
                   sig: int) -> str:
    """Shared body of 1.9's dtoa_g_wxp{2,8} (plink_common.c:2893,3244):
    <sig>-significant-figure shortest form, right-aligned.  `mant` is the
    threshold mantissa literal (e.g. "9.9999999499999" for 8 sig figs),
    `band` the banker-rounding half-widths used throughout that variant
    (banker_round6 for wxp8, banker_round12 for wxp2)."""
    def t(e):
        return float(f"{mant}e{e}")

    if x != x:
        return "nan".rjust(width)
    neg = x < 0
    ax = -x if neg else x

    def qr(v, dec):
        # double_broundN(v, band): integer part + dec rounded decimals
        q = int(v)
        r = int((v - q) * 10.0 ** dec + band[q & 1])
        return q, r

    def qr_str(q, r, dec):
        if not r:
            return str(q)
        return f"{q}.{r:0{dec}d}".rstrip("0")

    if ax < t(-5):
        if ax == 0.0:
            return "0".rjust(width)
        xp10 = 0
        if ax < t(-16):
            if ax < t(-128):
                if ax < t(-256):
                    ax *= 1.0e256
                    xp10 |= 256
                else:
                    ax *= 1.0e128
                    xp10 |= 128
            if ax < t(-64):
                ax *= 1.0e64
                xp10 |= 64
            if ax < t(-32):
                ax *= 1.0e32
                xp10 |= 32
            if ax < t(-16):
                ax *= 1.0e16
                xp10 |= 16
        if ax < t(-8):
            ax *= 1e8
            xp10 |= 8
        if ax < t(-4):
            ax *= 1e4
            xp10 |= 4
        if ax < t(-2):
            ax *= 1e2
            xp10 |= 2
        if ax < t(-1):
            ax *= 10.0
            xp10 += 1
        q, r = qr(ax, sig - 1)
        s = qr_str(q, r, sig - 1)
        exp = (f"e-{xp10 // 100}{xp10 % 100:02d}" if xp10 >= 100
               else f"e-{xp10:02d}")
        return (("-" if neg else "") + s + exp).rjust(width)
    if ax >= t(sig - 1):
        # large: exponential once past 10^sig - rounding slack
        xp10 = 0
        if ax >= t(15):
            if ax >= t(127):
                if ax == float("inf"):
                    return ("-inf" if neg else "inf").rjust(width)
                if ax >= t(255):
                    ax *= 1.0e-256
                    xp10 |= 256
                else:
                    ax *= 1.0e-128
                    xp10 |= 128
            if ax >= t(63):
                ax *= 1.0e-64
                xp10 |= 64
            if ax >= t(31):
                ax *= 1.0e-32
                xp10 |= 32
            if ax >= t(15):
                ax *= 1.0e-16
                xp10 |= 16
        if ax >= t(7):
            ax *= 1.0e-8
            xp10 |= 8
        if ax >= t(3):
            ax *= 1.0e-4
            xp10 |= 4
        if ax >= t(1):
            ax *= 1.0e-2
            xp10 |= 2
        if ax >= t(0):
            ax *= 1.0e-1
            xp10 += 1
        q, r = qr(ax, sig - 1)
        s = qr_str(q, r, sig - 1)
        exp = (f"e+{xp10 // 100}{xp10 % 100:02d}" if xp10 >= 100
               else f"e+{xp10:02d}")
        return (("-" if neg else "") + s + exp).rjust(width)
    if ax >= t(-1):
        # dtoa_soN fixed notation, 1..sig integer digits
        k = 0
        while k < sig - 1 and ax >= t(k):
            k += 1
        dec = sig - 1 - k
        if dec == 0:
            q = int(ax)
            q += int((ax - q) + band[q & 1])
            s = str(q)
        else:
            q, r = qr(ax, dec)
            s = qr_str(q, r, dec)
        return (("-" if neg else "") + s).rjust(width)
    prefix = "0."
    if ax < t(-3):
        ax *= 100.0
        prefix += "00"
    if ax < t(-2):
        ax *= 10.0
        prefix += "0"
    v = ax * 10.0 ** sig
    q = int(v)
    r = q + int((v - q) + band[q & 1])
    s = prefix + f"{r:0{sig}d}".rstrip("0")
    return (("-" if neg else "") + s).rjust(width)


def dtoa_g_wxp8(x: float, width: int) -> str:
    """1.9 dtoa_g_wxp8 (plink_common.c:3244): 8-sig-fig shortest form
    with banker_round6, right-aligned to `width`."""
    return _g_wxp_generic(x, width, "9.9999999499999",
                          (0.4999995, 0.5000005), 8)


def dtoa_g_wxp2(x: float, width: int) -> str:
    """1.9 dtoa_g_wxp2 (plink_common.c:2893): 2-sig-fig shortest form
    with banker_round12, right-aligned to `width`."""
    return _g_wxp_generic(x, width, "9.9499999999999",
                          (0.4999999999995, 0.5000000000005), 2)


_BR10 = (0.49999999995, 0.50000000005)


def _bround10(v: float) -> int:
    """1.9's double_bround with banker_round10 (plink_common.c:1540):
    half-to-even with a 5e-11 epsilon absorbing binary representation
    error, so e.g. 0.24375 (stored as ...749999) prints 0.2438."""
    i = int(v)
    return i + int((v - i) + _BR10[i & 1])


def dtoa_g_wxp4(x: float, width: int) -> str:
    """1.9 dtoa_g_wxp4 (plink_common.c:2992): 4-sig-fig shortest form
    with banker_round10, right-aligned to `width`.  A digit carried by the
    rounding starts the next decade (1.9995 -> "2"), as in plink_tpu's
    commands/assoc19.py `_g4`, the version plink_tpu's callers use."""
    if not np.isfinite(x):
        if x != x:
            return "nan".rjust(width)
        return ("inf" if x > 0 else "-inf").rjust(width)
    neg = x < 0
    x = abs(x)
    if x < 9.9994999999999e-5:
        if x == 0.0:
            s = "0"
        else:
            xp10 = 0
            while x < 9.9994999999999e-1:
                x *= 10
                xp10 += 1
            q = _bround10(x * 1000)
            whole, frac = divmod(q, 1000)
            s = str(whole)
            fs = f"{frac:03d}".rstrip("0")
            if fs:
                s += "." + fs
            s += f"e-{xp10:02d}"
    elif x >= 9999.4999999999:
        xp10 = 0
        while x >= 9.9994999999999:
            x /= 10
            xp10 += 1
        q = _bround10(x * 1000)
        whole, frac = divmod(q, 1000)
        s = str(whole)
        fs = f"{frac:03d}".rstrip("0")
        if fs:
            s += "." + fs
        s += f"e+{xp10:02d}"
    elif x >= 0.99994999999999:
        # dtoa_so4: 4 sig figs in fixed notation
        if x >= 999.94999999999:
            s = str(_bround10(x))
        elif x >= 99.994999999999:
            q = _bround10(x * 10)
            whole, frac = divmod(q, 10)
            s = str(whole) + (f".{frac}" if frac else "")
        elif x >= 9.9994999999999:
            q = _bround10(x * 100)
            whole, frac = divmod(q, 100)
            fs = f"{frac:02d}".rstrip("0")
            s = str(whole) + (f".{fs}" if fs else "")
        else:
            q = _bround10(x * 1000)
            whole, frac = divmod(q, 1000)
            fs = f"{frac:03d}".rstrip("0")
            s = str(whole) + (f".{fs}" if fs else "")
    else:
        prefix = "0."
        if x < 9.9994999999999e-3:
            x *= 100
            prefix += "00"
        if x < 9.9994999999999e-2:
            x *= 10
            prefix += "0"
        q = _bround10(x * 10000)
        s = prefix + f"{q:04d}".rstrip("0")
    if neg:
        s = "-" + s
    return s.rjust(width)


def fw_width(lengths, base: int = 4) -> int:
    """1.9's sequential column-width rule of calc_plink_maxsnp /
    calc_plink_maxfid (plink_misc.c:1771-1835; plink_tpu's
    commands/homozyg.py `_fw_width`): the width starts at `base` and
    jumps to len + 2 whenever an ID is longer than the current width, so it
    depends on the IDs' order."""
    w = base
    for n in lengths:
        if n > w:
            w = n + 2
    return w

"""SFMT19937 pseudorandom generator, bit-exact with the SFMT 1.3.3
variant bundled with PLINK 1.9 (1.9/SFMT.{h,c}).

PLINK 1.9's permutation tests, --dummy, --simulate, --thin etc. draw
from this generator; replicating the stream is required for
byte-identical outputs under a fixed --seed.  This port draws from it for
--ibs-test's permutations and the jackknife of --groupdist /
--regress-distance (plink_tpu/stats/sfmt.py; its uint64 draws are not
needed yet).  The implementation keeps
each 128-bit state word as a Python int; per-lane shifts are emulated
with packed masks (SFMT.c:69-134 rshift128/lshift128/do_recursion).
"""

from __future__ import annotations

N = 156          # SFMT_N  (19937 // 128 + 1)
N32 = N * 4      # SFMT_N32
POS1 = 122
SL1 = 18
SL2 = 1          # bytes
SR1 = 11
SR2 = 1          # bytes
MSK = (0xDFFFFFEF, 0xDDFECB7F, 0xBFFAFFFF, 0xBFFFFFF6)
PARITY = (0x00000001, 0x00000000, 0x00000000, 0x13C9E684)

_M128 = (1 << 128) - 1
_M32 = 0xFFFFFFFF


def _rep(x32):
    return x32 | (x32 << 32) | (x32 << 64) | (x32 << 96)


# per-lane (b >> SR1) & MSK: packed >> then clear cross-lane bits
_SR1_MASK = (_rep(_M32 >> SR1)
             & (MSK[0] | (MSK[1] << 32) | (MSK[2] << 64)
                | (MSK[3] << 96)))
# per-lane (d << SL1): packed << then clear spilled-in bits
_SL1_MASK = _rep((_M32 << SL1) & _M32)


class Sfmt:
    """sfmt_t + genrand_uint32 (SFMT.h:183-192)."""

    __slots__ = ("w", "buf", "idx")

    def __init__(self, seed=None):
        self.w = [0] * N          # 128-bit words
        self.buf = []             # unpacked uint32 block
        self.idx = N32
        if seed is not None:
            self.init_gen_rand(seed)

    # -- initialization ------------------------------------------------
    def _from32(self, p32):
        self.w = [(p32[4 * i] | (p32[4 * i + 1] << 32)
                   | (p32[4 * i + 2] << 64) | (p32[4 * i + 3] << 96))
                  for i in range(N)]

    def _period_certification(self, p32):
        inner = 0
        for i in range(4):
            inner ^= p32[i] & PARITY[i]
        for sh in (16, 8, 4, 2, 1):
            inner ^= inner >> sh
        if inner & 1:
            return
        for i in range(4):
            work = 1
            for _ in range(32):
                if work & PARITY[i]:
                    p32[i] ^= work
                    return
                work = (work << 1) & _M32

    def init_gen_rand(self, seed):
        p32 = [0] * N32
        p32[0] = seed & _M32
        for i in range(1, N32):
            prev = p32[i - 1]
            p32[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & _M32
        self.idx = N32
        self._period_certification(p32)
        self._from32(p32)
        self.buf = []

    def init_by_array(self, init_key):
        size = N32
        lag = 11 if size >= 623 else (7 if size >= 68 else
                                      (5 if size >= 39 else 3))
        mid = (size - lag) // 2
        p32 = [0x8B8B8B8B] * N32
        key_length = len(init_key)
        count = max(key_length + 1, N32)

        def func1(x):
            return ((x ^ (x >> 27)) * 1664525) & _M32

        def func2(x):
            return ((x ^ (x >> 27)) * 1566083941) & _M32

        r = func1(p32[0] ^ p32[mid] ^ p32[N32 - 1])
        p32[mid] = (p32[mid] + r) & _M32
        r = (r + key_length) & _M32
        p32[mid + lag] = (p32[mid + lag] + r) & _M32
        p32[0] = r
        count -= 1
        i = 1
        j = 0
        while j < count and j < key_length:
            r = func1(p32[i] ^ p32[(i + mid) % N32]
                      ^ p32[(i + N32 - 1) % N32])
            p32[(i + mid) % N32] = (p32[(i + mid) % N32] + r) & _M32
            r = (r + init_key[j] + i) & _M32
            p32[(i + mid + lag) % N32] = \
                (p32[(i + mid + lag) % N32] + r) & _M32
            p32[i] = r
            i = (i + 1) % N32
            j += 1
        while j < count:
            r = func1(p32[i] ^ p32[(i + mid) % N32]
                      ^ p32[(i + N32 - 1) % N32])
            p32[(i + mid) % N32] = (p32[(i + mid) % N32] + r) & _M32
            r = (r + i) & _M32
            p32[(i + mid + lag) % N32] = \
                (p32[(i + mid + lag) % N32] + r) & _M32
            p32[i] = r
            i = (i + 1) % N32
            j += 1
        for _ in range(N32):
            r = func2((p32[i] + p32[(i + mid) % N32]
                       + p32[(i + N32 - 1) % N32]) & _M32)
            p32[(i + mid) % N32] ^= r
            r = (r - i) & _M32
            p32[(i + mid + lag) % N32] ^= r
            p32[i] = r
            i = (i + 1) % N32
        self.idx = N32
        self._period_certification(p32)
        self._from32(p32)
        self.buf = []

    # -- generation ----------------------------------------------------
    def _gen_rand_all(self):
        w = self.w
        r1 = w[N - 2]
        r2 = w[N - 1]
        for i in range(N):
            a = w[i]
            b = w[i + POS1] if i + POS1 < N else w[i + POS1 - N]
            x = (a << (SL2 * 8)) & _M128
            y = r1 >> (SR2 * 8)
            r = (a ^ x ^ ((b >> SR1) & _SR1_MASK) ^ y
                 ^ ((r2 << SL1) & _SL1_MASK))
            w[i] = r
            r1 = r2
            r2 = r
        buf = []
        for ww in w:
            buf.append(ww & _M32)
            buf.append((ww >> 32) & _M32)
            buf.append((ww >> 64) & _M32)
            buf.append((ww >> 96) & _M32)
        self.buf = buf

    def genrand_uint32(self):
        if self.idx >= N32:
            self._gen_rand_all()
            self.idx = 0
        r = self.buf[self.idx]
        self.idx += 1
        return r


def sfmt_thread_array(master: Sfmt, thread_ct: int):
    """bigstack_init_sfmtp (1.9/plink_common.c:10860): thread 0 shares
    the master generator; threads 1..T-1 get init_by_array generators
    seeded with 4 sequential draws from the master."""
    arr = [master]
    for _ in range(1, thread_ct):
        keys = [master.genrand_uint32() for _ in range(4)]
        s = Sfmt()
        s.init_by_array(keys)
        arr.append(s)
    return arr

"""Pairwise LD on the device: kernels K11 `ld_band_bits` (the
`--indep-pairwise` decisions), K12 `ld_band_stats` (the six band statistics
of the `--r2`/`--r` tables) and K13 `ld_gram_pair` (the plane Gram of two
variant chunks: the matrix modes and the phased joint counts), all in
`csrc/ld_band.cu`, each with its plain PyTorch version; and the classes
`LdBitsBand`, `LdBand` and `LdJointBand` over them.

Genotypes are scored x in {+1 hom-REF, 0 het, -1 hom-ALT} with
pairwise-complete missing handling (ref ComputeIndepPairwiseR2Components,
2.0/plink2_ld.cc:194-414).  For the pair (i, j = i + d) of a subcontig, over
the masked samples, the six statistics are entries of the 3 x 3 Gram of the
hom-REF (R), hom-ALT (A) and valid (V) planes:
    dot = RR - RA - AR + AA     nm  = VV
    s_i = RV - AV               q_i = RV + AV
    s_j = VR - VA               q_j = VR + VA
and the pair exceeds the r^2 threshold iff cov^2 > r2t * var1 * var2 in f64
(cov = dot nm - s_i s_j, var1 = q_i nm - s_i^2, var2 = q_j nm - s_j^2;
strict >, plink_tpu/ops/ld.py:159-165).  K11 returns only the decision bits
[n, w + 1] and the d = 0 counts (nm1, homref1, homalt1); K12 the six exact
int32 statistics [6, n, w + 1] and the same counts, the f64 arithmetic left
to the host.

plink_tpu forms each chunk's plane Gram with itself and with the next chunk
and gathers the band; K11/K12 count the band directly (AND + popcount over
32-sample bit words), the plain versions follow plink_tpu's chunked Gram.
The wrappers run the plain version for CPU tensors and launch the kernel
for CUDA tensors (or raise).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .planes import unpack_codes

PLAIN_CHUNK = 512  # rows of the plain version's plane Gram (plink_tpu's c)


def ld_inputs_from_numpy(packed: np.ndarray, smask: np.ndarray,
                         device="cpu") -> tuple:
    """plink_tpu's numpy operands (packed uint8 [n, NB] subcontig rows, int8
    sample mask [npad = 4 NB]) as this port's tensors on `device`."""
    return (torch.from_numpy(np.ascontiguousarray(packed, np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(smask, np.int8)).to(device))


def _planes_rav(packed: torch.Tensor, smask: torch.Tensor) -> torch.Tensor:
    """packed [C, NB] -> [3C, npad] int8 planes (R rows | A rows | V rows),
    sample-masked (plink_tpu/ops/ld.py `_planes_rav`)."""
    codes = unpack_codes(packed).to(torch.int8)
    b0 = codes & 1
    b1 = (codes >> 1) & 1
    miss = b0 & b1
    r = (1 - b0) & (1 - b1)
    a = b1 - miss
    v = 1 - miss
    m = smask.to(torch.int8)[None, :]
    return torch.cat([r * m, a * m, v * m], dim=0)


def _mm_dtype(smask: torch.Tensor) -> torch.dtype:
    """Matmul type of the plain versions: float32 products of 0/1 planes
    are exact integers while the contraction stays below 2^24 samples (and
    run ~15x faster than int32 on the CPU), else float64."""
    return torch.float32 if smask.shape[0] < 1 << 24 else torch.float64


def _chunk_bands(packed, smask, width: int):
    """For each PLAIN_CHUNK-row chunk [r0, r1) of the subcontig: the RAV
    plane Gram of its rows against the rows r0 .. r1 + width - 1 (int32),
    and `band(a, b)`, the [r1 - r0, width + 1] band of plane a (rows)
    against plane b (columns): entry [i, d] is the pair (r0 + i, r0 + i + d),
    clamped at the subcontig's end; also the mask of the pairs inside it."""
    n = packed.shape[0]
    dev = packed.device
    mm_dtype = _mm_dtype(smask)
    dd = torch.arange(width + 1, device=dev)[None, :]
    for r0 in range(0, n, PLAIN_CHUNK):
        r1 = min(r0 + PLAIN_CHUNK, n)
        c1 = min(r1 + width, n)
        ca, cb = r1 - r0, c1 - r0
        p3 = _planes_rav(packed[r0:r1], smask).to(mm_dtype)
        q3 = _planes_rav(packed[r0:c1], smask).to(mm_dtype)
        g = (p3 @ q3.t()).to(torch.int32)
        jj = torch.arange(ca, device=dev)[:, None] + dd
        jc = jj.clamp(max=cb - 1)

        def band(a, b, g=g, ca=ca, cb=cb, jc=jc):
            m = g[a * ca : (a + 1) * ca, b * cb : (b + 1) * cb]
            return torch.take_along_dim(m, jc, dim=1)

        yield r0, r1, band, jj < cb


def ld_band_bits_plain(packed, smask, width: int, r2t: float):
    """Plain version of K11: the RAV plane Gram of each PLAIN_CHUNK-row chunk
    against the rows from its start to its end + width (exact float
    products, `_mm_dtype`), the band gathered, then plink_tpu's f64
    decision in its order."""
    n = packed.shape[0]
    dev = packed.device
    ex = torch.zeros((n, width + 1), dtype=torch.uint8, device=dev)
    counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    for r0, r1, band, valid in _chunk_bands(packed, smask, width):
        rr, ra, rv = (band(0, b).double() for b in range(3))
        ar, aa, av = (band(1, b).double() for b in range(3))
        vr, va, vv = (band(2, b).double() for b in range(3))
        dot = rr - ra - ar + aa
        s_i, q_i = rv - av, rv + av
        s_j, q_j = vr - va, vr + va
        cov = dot * vv - s_i * s_j
        var1 = q_i * vv - s_i * s_i
        var2 = q_j * vv - s_j * s_j
        exceeds = (cov * cov > r2t * var1 * var2) & valid
        exceeds[:, 0] = False
        ex[r0:r1] = exceeds.to(torch.uint8)
        counts[:, r0:r1] = torch.stack([vv[:, 0], rv[:, 0], av[:, 0]]).to(torch.int32)
    return ex, counts[0], counts[1], counts[2]


def _check(name: str, packed, smask) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError(f"{name}: packed must be contiguous uint8 [n, NB]")
    if smask.dtype != torch.int8 or smask.dim() != 1 \
            or smask.shape[0] != 4 * packed.shape[1] or not smask.is_contiguous():
        raise ValueError(f"{name}: smask must be contiguous int8 [4 * NB]")
    if smask.device != packed.device:
        raise ValueError(f"{name}: inputs on different devices")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {packed.device}")


def ld_band_bits(packed, smask, width: int, r2t: float):
    """K11: the r^2 > r2t decisions of one subcontig.  packed uint8 [n, NB]
    (rows in subcontig order, samples compacted to the founders and padded
    to npad = 4 NB), smask int8 [npad] -> (exceeds uint8 [n, width + 1],
    entry [i, d] for the pair (i, i + d), 0 for d = 0 and i + d >= n; nm1,
    homref1, homalt1 int32 [n], the valid, hom-REF and hom-ALT counts of each
    variant).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check("ld_band_bits", packed, smask)
    if width < 0:
        raise ValueError("ld_band_bits: width must be >= 0")
    if packed.device.type == "cpu":
        return ld_band_bits_plain(packed, smask, width, r2t)
    dev = packed.device
    n, nb_bytes = packed.shape
    nwords = -(-smask.shape[0] // 32)
    mbits = torch.empty(nwords, dtype=torch.int32, device=dev)
    planes = torch.empty(3 * nwords * max(n, 1), dtype=torch.int32, device=dev)
    ex = torch.empty((n, width + 1), dtype=torch.uint8, device=dev)
    counts = torch.empty((3, n), dtype=torch.int32, device=dev)
    _cuda.launch("ld_band_bits", packed.data_ptr(), nb_bytes, n, smask.data_ptr(),
                 smask.shape[0], width, float(r2t), mbits.data_ptr(),
                 planes.data_ptr(), ex.data_ptr(), counts[0].data_ptr(),
                 counts[1].data_ptr(), counts[2].data_ptr())
    return ex, counts[0], counts[1], counts[2]


def ld_band_stats_plain(packed, smask, width: int):
    """Plain version of K12: the chunked plane Grams of K11's plain version
    (float32 products, exact), the six statistics gathered from the band,
    0 where i + d >= n."""
    n = packed.shape[0]
    dev = packed.device
    stats = torch.zeros((6, n, width + 1), dtype=torch.int32, device=dev)
    counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    for r0, r1, band, valid in _chunk_bands(packed, smask, width):
        rr, ra, rv = (band(0, b) for b in range(3))
        ar, aa, av = (band(1, b) for b in range(3))
        vr, va, vv = (band(2, b) for b in range(3))
        six = torch.stack([rr - ra - ar + aa, vv, rv - av, rv + av, vr - va, vr + va])
        stats[:, r0:r1] = six * valid
        counts[:, r0:r1] = torch.stack([vv[:, 0], rv[:, 0], av[:, 0]])
    return stats, counts[0], counts[1], counts[2]


def ld_band_stats(packed, smask, width: int):
    """K12: the six pair statistics of one subcontig's band.  packed uint8
    [n, NB], smask int8 [npad = 4 NB] as for K11 -> (stats int32 [6, n,
    width + 1]: dot, nm, sum_i, ssq_i, sum_j, ssq_j of the pair (i, i + d),
    d = 0 included, 0 where i + d >= n; nm1, homref1, homalt1 int32 [n]).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check("ld_band_stats", packed, smask)
    if width < 0:
        raise ValueError("ld_band_stats: width must be >= 0")
    if packed.device.type == "cpu":
        return ld_band_stats_plain(packed, smask, width)
    dev = packed.device
    n, nb_bytes = packed.shape
    nwords = -(-smask.shape[0] // 32)
    mbits = torch.empty(nwords, dtype=torch.int32, device=dev)
    planes = torch.empty(3 * nwords * max(n, 1), dtype=torch.int32, device=dev)
    stats = torch.empty((6, n, width + 1), dtype=torch.int32, device=dev)
    counts = torch.empty((3, n), dtype=torch.int32, device=dev)
    _cuda.launch("ld_band_stats", packed.data_ptr(), nb_bytes, n, smask.data_ptr(),
                 smask.shape[0], width, mbits.data_ptr(), planes.data_ptr(),
                 stats.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
                 counts[2].data_ptr())
    return stats, counts[0], counts[1], counts[2]


def ld_gram_pair_plain(pka, pkb, smask):
    """Plain version of K13: one matmul of the two chunks' RAV planes
    (float32 products of 0/1, exact)."""
    dt = _mm_dtype(smask)
    p3 = _planes_rav(pka, smask).to(dt)
    q3 = _planes_rav(pkb, smask).to(dt)
    return (p3 @ q3.t()).to(torch.int32)


def ld_gram_pair(pka, pkb, smask):
    """K13: the [3 Ca, 3 Cb] int32 Gram of the sample-masked R/A/V planes of
    two variant chunks (pka uint8 [Ca, NB], pkb [Cb, NB], smask int8 [4 NB]),
    contracted over samples: block (p, q) holds plane p of chunk a against
    plane q of chunk b (plink_tpu/ops/ld.py `ld_gram_pair`).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    _check("ld_gram_pair", pka, smask)
    _check("ld_gram_pair", pkb, smask)
    if pka.device.type == "cpu":
        return ld_gram_pair_plain(pka, pkb, smask)
    dev = pka.device
    ca, nb_bytes = pka.shape
    cb = pkb.shape[0]
    nwords = -(-smask.shape[0] // 32)
    mbits = torch.empty(nwords, dtype=torch.int32, device=dev)
    pa = torch.empty(3 * nwords * max(ca, 1), dtype=torch.int32, device=dev)
    pb = torch.empty(3 * nwords * max(cb, 1), dtype=torch.int32, device=dev)
    g = torch.empty((3 * ca, 3 * cb), dtype=torch.int32, device=dev)
    _cuda.launch("ld_gram_pair", pka.data_ptr(), ca, pkb.data_ptr(), cb, nb_bytes,
                 smask.data_ptr(), smask.shape[0], mbits.data_ptr(), pa.data_ptr(),
                 pb.data_ptr(), g.data_ptr())
    return g


def pair_stats_from_gram(g: np.ndarray, ca: int, cb: int) -> dict[str, np.ndarray]:
    """Gram [3ca, 3cb] -> the six pair-stat matrices [ca, cb] (int64)
    (plink_tpu/ops/ld.py `pair_stats_from_gram`)."""
    g = np.asarray(g, dtype=np.int64)
    blk = lambda x, y: g[x * ca : (x + 1) * ca, y * cb : (y + 1) * cb]  # noqa: E731
    rr, ra, rv = blk(0, 0), blk(0, 1), blk(0, 2)
    ar, aa, av = blk(1, 0), blk(1, 1), blk(1, 2)
    vr, va, vv = blk(2, 0), blk(2, 1), blk(2, 2)
    return {
        "dot": rr - ra - ar + aa,
        "nm": vv,
        "sum_i": rv - av,
        "ssq_i": rv + av,
        "sum_j": vr - va,
        "ssq_j": vr + va,
    }


def _smask_on(smask: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(smask, np.int8)).to(device)


class LdBitsBand:
    """Banded r^2-exceeds-threshold decisions for one subcontig: entry
    [i, d] is 1 iff cov^2 > r2t * var1 * var2 for the pair (i, i + d)
    (plink_tpu/ops/ld.py `LdBitsBand`), made on the device by K11; also the
    per-variant (nm, homref, homalt) counts.  `packed_rows`: uint8 tensor
    [n, NB] on the run's device; `smask`: int8 [npad] sample mask."""

    def __init__(self, packed_rows: torch.Tensor, smask: np.ndarray, width: int,
                 r2t: float):
        n = packed_rows.shape[0]
        self.n = n
        self.width = min(width, max(n - 1, 0))
        ex, nm1, homref1, homalt1 = ld_band_bits(
            packed_rows, _smask_on(smask, packed_rows.device), self.width, r2t)
        self.exceeds = ex.cpu().numpy()
        self.nm1 = nm1.cpu().numpy().astype(np.int64)
        self.homref1 = homref1.cpu().numpy().astype(np.int64)
        self.homalt1 = homalt1.cpu().numpy().astype(np.int64)

    def r2_exceeds_vec(self, firsts: np.ndarray, second: int):
        """Decision bits of the pairs (f, second) for f in firsts."""
        return self.exceeds[firsts, second - firsts].astype(bool)


class LdBand:
    """Banded pair statistics for one subcontig (plink_tpu/ops/ld.py
    `LdBand`), made on the device by K12: `bands[key]` int64 [n, width + 1],
    entry [i, d] for the pair (i, i + d), d = 0 the variant with itself, 0
    where i + d >= n; also the per-variant (nm, homref, homalt) counts.
    `packed_rows`: uint8 tensor [n, NB] on the run's device; `smask`: int8
    [npad] sample mask."""

    KEYS = ("dot", "nm", "sum_i", "ssq_i", "sum_j", "ssq_j")

    def __init__(self, packed_rows: torch.Tensor, smask: np.ndarray, width: int):
        n = packed_rows.shape[0]
        self.n = n
        self.width = min(width, max(n - 1, 0))
        stats, nm1, homref1, homalt1 = ld_band_stats(
            packed_rows, _smask_on(smask, packed_rows.device), self.width)
        stats = stats.cpu().numpy()
        self.bands = {k: stats[i].astype(np.int64) for i, k in enumerate(self.KEYS)}
        self.nm1 = nm1.cpu().numpy().astype(np.int64)
        self.homref1 = homref1.cpu().numpy().astype(np.int64)
        self.homalt1 = homalt1.cpu().numpy().astype(np.int64)

    def pair(self, key: str, i: int, j: int) -> int:
        return int(self.bands[key][i, j - i])

    def r2_exceeds_vec(self, firsts: np.ndarray, second: int, thresh: float):
        """Vectorized 'cov^2 > thresh * var1 * var2' (strict >) for the
        pairs (f, second), in plink_tpu's f64 order."""
        d = second - firsts
        dot = self.bands["dot"][firsts, d].astype(np.float64)
        nm = self.bands["nm"][firsts, d].astype(np.float64)
        s_i = self.bands["sum_i"][firsts, d].astype(np.float64)
        q_i = self.bands["ssq_i"][firsts, d].astype(np.float64)
        s_j = self.bands["sum_j"][firsts, d].astype(np.float64)
        q_j = self.bands["ssq_j"][firsts, d].astype(np.float64)
        cov = dot * nm - s_i * s_j
        var1 = q_i * nm - s_i * s_i
        var2 = q_j * nm - s_j * s_j
        return cov * cov > thresh * var1 * var2


class LdJointBand:
    """Banded 3 x 3 joint genotype counts of variant pairs (plink_tpu/ops/
    ld.py `LdJointBand`): `bands[key]` int64 [n, width + 1] for the nine
    plane products RR .. VV of the pair (i, i + d), 1 <= d <= width (d = 0
    and pairs past the end are 0).  K13 forms each chunk's Gram with itself
    and with the next chunk, as plink_tpu does (chunk = max(256, width)),
    and the band is gathered on the device.  Used by the phased r (ref:
    Vcor, 2.0/plink2_ld.cc:12054)."""

    RAW = ("RR", "RA", "RV", "AR", "AA", "AV", "VR", "VA", "VV")

    def __init__(self, packed_rows: torch.Tensor, smask: np.ndarray, width: int,
                 chunk: int | None = None):
        n = packed_rows.shape[0]
        dev = packed_rows.device
        self.n = n
        self.width = min(width, max(n - 1, 0))
        c = max(chunk or 256, self.width, 1)
        c = min(c, max(n, 1))
        sm = _smask_on(smask, dev)
        out = torch.zeros((9, n, self.width + 1), dtype=torch.int32, device=dev)
        dd = torch.arange(self.width + 1, device=dev)[None, :]
        for s0 in range(0, n, c):
            s1 = min(s0 + c, n)
            ca = s1 - s0
            pa = packed_rows[s0:s1]
            grams = [(ld_gram_pair(pa, pa, sm), ca)]
            if s1 < n:
                pb = packed_rows[s1 : min(s1 + c, n)]
                grams.append((ld_gram_pair(pa, pb, sm), pb.shape[0]))
            # row il of the chunk against the columns [s0, s0 + ca + cb):
            # the pair (s0 + il, s0 + il + d) is column il + d
            jj = torch.arange(ca, device=dev)[:, None] + dd
            ncol = sum(w for _, w in grams)
            keep = (dd >= 1) & (jj < ncol)
            jc = jj.clamp(max=ncol - 1)
            for k in range(9):
                a, b = divmod(k, 3)
                m = torch.cat([g[a * ca : (a + 1) * ca, b * w : (b + 1) * w]
                               for g, w in grams], dim=1)
                out[k, s0:s1] = torch.take_along_dim(m, jc, dim=1) * keep
        out = out.cpu().numpy()
        self.bands = {k: out[i].astype(np.int64) for i, k in enumerate(self.RAW)}

    def joint_counts(self, firsts: np.ndarray, d: np.ndarray) -> dict:
        """For pairs (firsts, firsts+d): 3x3 counts keyed 'ab' with a,b in
        {0,1,2} = ALT copies of the first/second variant, plus 'nm'."""
        b = {k: self.bands[k][firsts, d] for k in self.RAW}
        out = {}
        # R = 0 copies, H = 1, A = 2 ; H* = V* - R* - A*
        out["00"] = b["RR"]
        out["02"] = b["RA"]
        out["20"] = b["AR"]
        out["22"] = b["AA"]
        out["01"] = b["RV"] - b["RR"] - b["RA"]
        out["21"] = b["AV"] - b["AR"] - b["AA"]
        out["10"] = b["VR"] - b["RR"] - b["AR"]
        out["12"] = b["VA"] - b["RA"] - b["AA"]
        out["nm"] = b["VV"]
        out["11"] = (
            b["VV"] - out["00"] - out["01"] - out["02"] - out["10"]
            - out["12"] - out["20"] - out["21"] - out["22"]
        )
        return out

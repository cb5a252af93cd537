"""--genome: pairwise IBD estimation (PI_HAT), PLINK 1.9 parity.

Behavior reference: calc_genome (1.9/plink_calc.c:4514-5000) and its
method-of-moments IBD estimator (Plink::preCalcGenomeIBD lineage):

- Per-pair IBS0/IBS1/IBS2 counts over mutually-nonmissing autosomal
  markers come from KING's kernel K7 in its counters mode (ops/pairwise.py
  `king_gram`, csrc/king_gram.cu), one launch per lower sample tile,
  instead of 1.9's popcount loops.
- Expected IBS-given-IBD terms e00..e12 are per-marker quantities from
  founder allele freqs with finite-sample corrections
  (plink_calc.c:4846-4866), averaged over usable markers.
- Z0 = IBS0/(e00 n); Z1 = (IBS1 - Z0 e01 n)/(e11 n);
  Z2 = (IBS2 - n(Z0 e02 + Z1 e12))/n, with 1.9's clipping cascade;
  PI_HAT = Z1/2 + Z2.
- PPC/RATIO come from a ppc-gap-thinned scan of informative (het-het or
  opposite-hom) markers per pair (plink_calc.c:1301-1356): expected
  HETHET:IBS0 ratio 2 under the null; PPC = Phi((x/(x+y) - 2/3)/
  sqrt(2/9/(x+y))).  The scan walks the markers once for all pairs at
  a time (`ppc_counts`), which takes the same markers as plink_tpu's
  per-pair walk.

v1 scope: autosomal markers; within-family EZ covers the founder and
parent-offspring cases (full pedigree path-counting not yet ported).
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.pairwise import PackedDevice, iter_lower_tiles, king_gram
from ..ops.planes import _unpack_np
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs


def _f(x: float, w: int, p: int) -> str:
    return f"{x:.{p}f}".rjust(w)


def _norm_cdf(z: float) -> float:
    from math import erfc, sqrt

    return 0.5 * erfc(-z / sqrt(2.0))


def _e_terms(freqs, miss_ct, n_samples, vmask):
    """Averaged expectation terms (plink_calc.c:4846-4866)."""
    e = np.zeros(5)
    ct = 0
    for v in np.flatnonzero(vmask):
        p = freqs[v]
        if not np.isfinite(p):
            continue
        q = 1.0 - p
        na = 2.0 * (n_samples - miss_ct[v])
        if na <= 3 or p <= 0.0 or q <= 0.0:
            continue
        naf2 = na * na / ((na - 1) * (na - 2))
        naf3 = naf2 * na / (na - 3)
        x = p * na
        y = q * na
        p2, q2 = p * p, q * q
        x1 = (x - 1) / x
        x2 = x1 * (x - 2) / x
        y1 = (y - 1) / y
        y2 = y1 * (y - 2) / y
        e[0] += 2 * p2 * q2 * x1 * y1 * naf3
        e[1] += 4 * p * q * naf3 * (p2 * x2 + q2 * y2)
        e[2] += naf3 * (q2 * q2 * y2 * (y - 3) / y + p2 * p2 * x2 * (x - 3) / x
                        + 4 * p2 * q2 * x1 * y1)
        e[3] += 2 * p * q * naf2 * (p * x1 + q * y1)
        e[4] += naf2 * (p2 * p * x2 + q2 * q * y2 + p2 * q * x1 + p * q2 * y1)
        ct += 1
    if ct == 0:
        raise ValueError("--genome: no usable markers.")
    return e / ct  # e00, e01, e02, e11, e12


def _ppc_skip_index(pos, chrom, ppc_gap):
    """skip[m] = first marker index on the same chromosome with
    pos > pos[m] + gap (or the first marker of the next chromosome)."""
    M = len(pos)
    skip = np.empty(M, np.int64)
    j = 0
    for m in range(M):
        if j < m + 1:
            j = m + 1
        while j < M and chrom[j] == chrom[m] and pos[j] <= pos[m] + ppc_gap:
            j += 1
        skip[m] = j
    return skip


def ppc_counts(codes: np.ndarray, skip: np.ndarray):
    """The ppc-gap-thinned informative-marker counts of every sample pair
    (plink_calc.c:1301-1356): walking the markers in order, a pair takes
    marker m when it is informative for the pair (het-het, or opposite
    homs) and m is at or past the pair's next allowed index, which then
    becomes skip[m].  codes uint8 [M, n]; returns (het-het, opposite-hom)
    int64 [n, n] counts, symmetric."""
    n = codes.shape[1]
    het, hom0, hom2 = codes == 1, codes == 0, codes == 2
    nxt = np.zeros((n, n), np.int64)
    x = np.zeros((n, n), np.int64)
    y = np.zeros((n, n), np.int64)
    for m in range(codes.shape[0]):
        hh = np.logical_and.outer(het[m], het[m])
        i0 = np.logical_and.outer(hom0[m], hom2[m])
        i0 |= i0.T
        take = (hh | i0) & (nxt <= m)
        if not take.any():
            continue
        x += hh & take
        y += i0 & take
        nxt[take] = skip[m]
    return x, y


def run_genome(ds: Dataset, cfg, log: RunLogger) -> None:
    vmask = ds.variant_mask & ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    inc = np.flatnonzero(ds.sample_mask)
    n = inc.size
    si = ds.si

    freqs = alt_allele_freqs(ds, founders_only=not cfg.nonfounders, dosage=True)
    cts = ds.geno_counts()
    e00, e01, e02, e11, e12 = _e_terms(freqs, cts[:, 3], n, vmask)

    # IBS counts per pair from K7's counters, one launch per lower tile
    pd = PackedDevice.for_pairs(ds, vmask)
    s = pd.tile
    ibs0 = np.zeros((n, n), np.int64)
    ibs1 = np.zeros((n, n), np.int64)
    nsnp = np.zeros((n, n), np.int64)
    for r0, c0 in iter_lower_tiles(pd.npad, s):
        cnt = king_gram(pd.packed, pd.vmask, r0, c0, s, s, counts=True)
        rmax, cmax = min(r0 + s, n), min(c0 + s, n)
        sl = np.s_[r0:rmax, c0:cmax]
        cut = np.s_[: rmax - r0, : cmax - c0]
        ibs0[sl] = cnt[0].cpu().numpy()[cut]
        ibs1[sl] = (cnt[2] + cnt[3]).cpu().numpy()[cut]
        nsnp[sl] = cnt[5].cpu().numpy()[cut]

    # PPC-gap-thinned informative-marker scan (host), over the included
    # samples and the used markers
    vidx = np.flatnonzero(vmask)
    pos = ds.vi.pos[vidx]
    chrom = ds.vi.chrom[vidx]
    ppc_gap = getattr(cfg, "ppc_gap", None) or 500000
    skip = _ppc_skip_index(pos, chrom, ppc_gap)
    pk = ds.all_packed()
    codes = _unpack_np(pk[vidx])[:, : ds.raw_sample_ct][:, inc]
    ppc_hh, ppc_i0 = ppc_counts(codes, skip)

    rt_founder = ds.founder_mask[inc]
    fid = [str(si.fid[i]) for i in inc]
    iid = [str(si.iid[i]) for i in inc]
    pat = [str(si.pat[i]) if si.pat is not None else "0" for i in inc]
    mat = [str(si.mat[i]) if si.mat is not None else "0" for i in inc]

    pheno = None
    for _nm, pc in si.phenos.items():
        if pc.kind == "cc":
            pheno = pc
            break

    maxfid = max(3, max(len(x) for x in fid)) + 1
    maxiid = max(3, max(len(x) for x in iid)) + 1
    path = cfg.out + ".genome"

    def _hdr(s, w):  # printf %*s semantics: min width, never truncates
        return s.rjust(w) if len(s) < w else s

    with open(path, "w") as f:
        f.write(
            _hdr(" FID1", maxfid) + _hdr(" IID1", maxiid)
            + _hdr(" FID2", maxfid) + _hdr(" IID2", maxiid)
            + " RT    EZ      Z0      Z1      Z2  PI_HAT PHE "
            + "      DST     PPC   RATIO\n"
        )
        for i in range(0, n - 1):
            for j in range(i + 1, n):
                cnt_hh = int(ppc_hh[i, j])
                cnt_i0 = int(ppc_i0[i, j])
                nn = int(nsnp[j, i])
                c_ibs0 = int(ibs0[j, i])
                c_ibs1 = int(ibs1[j, i])
                oo = nn - c_ibs0 - c_ibs1
                if nn == 0 or e00 == 0:
                    continue
                z0 = c_ibs0 / (e00 * nn)
                z1 = (c_ibs1 - z0 * e01 * nn) / (e11 * nn)
                z2 = (oo - nn * (z0 * e02 + z1 * e12)) / nn
                # clipping cascade (plink_calc.c:4385-4415)
                if z0 > 1:
                    z0, z1, z2 = 1.0, 0.0, 0.0
                elif z1 > 1:
                    z0, z1, z2 = 0.0, 1.0, 0.0
                elif z2 > 1:
                    z0, z1, z2 = 0.0, 0.0, 1.0
                elif z0 < 0:
                    sc = 1.0 / (z1 + z2)
                    z1 *= sc
                    z2 *= sc
                    z0 = 0.0
                if z1 < 0:
                    sc = 1.0 / (z0 + z2)
                    z0 *= sc
                    z2 *= sc
                    z1 = 0.0
                if z2 < 0:
                    sc = 1.0 / (z0 + z1)
                    z0 *= sc
                    z1 *= sc
                    z2 = 0.0
                pi_hat = z1 * 0.5 + z2
                # RT / EZ
                if fid[i] == fid[j]:
                    if (not rt_founder[i]) and (not rt_founder[j]) and \
                            pat[i] == pat[j] and mat[i] == mat[j]:
                        rt = "FS"
                    elif (not rt_founder[i]) and (not rt_founder[j]) and (
                            pat[i] == pat[j] or mat[i] == mat[j]):
                        rt = "HS"
                    elif (pat[i] == iid[j] or mat[i] == iid[j]
                          or pat[j] == iid[i] or mat[j] == iid[i]):
                        rt = "PO"
                    else:
                        rt = "OT"
                    ez = 0.5 if rt in ("PO", "FS") else (
                        0.25 if rt == "HS" else 0.0)
                    if rt_founder[i] and rt_founder[j]:
                        ez = 0.0
                    ezs = f"{ez:g}".rjust(5)
                else:
                    rt = "UN"
                    ezs = "   NA"
                row = (
                    " " + fid[i].rjust(maxfid - 1) + " "
                    + iid[i].rjust(maxiid - 1) + " "
                    + fid[j].rjust(maxfid - 1) + " "
                    + iid[j].rjust(maxiid - 1) + " "
                    + rt + " " + ezs + " "
                    + _f(z0, 7, 4) + " " + _f(z1, 7, 4) + " "
                    + _f(z2, 7, 4) + " " + _f(pi_hat, 7, 4)
                )
                if pheno is not None:
                    pi_, pj_ = pheno.nonmiss[inc[i]], pheno.nonmiss[inc[j]]
                    ci_ = pheno.data[inc[i]] == 1
                    cj_ = pheno.data[inc[j]] == 1
                    if ((not pi_) or (not ci_)) and ((not pj_) or (not cj_)):
                        row += "  -1 "
                    elif pi_ and pj_ and ci_ and cj_:
                        row += "   1 "
                    else:
                        row += "   0 "
                else:
                    row += "  NA "
                dst = 1.0 - (c_ibs1 + 2 * c_ibs0) / (2.0 * nn)
                row += _f(dst, 9, 6) + " "
                tot = cnt_hh + cnt_i0
                if tot > 0:
                    z = (cnt_hh / tot - 0.666666) / np.sqrt(0.2222222 / tot)
                    row += _f(_norm_cdf(z), 7, 4) + " "
                else:
                    row += "     NA "
                if cnt_i0:
                    row += _f(cnt_hh / cnt_i0, 7, 4)
                else:
                    row += "     NA"
                f.write(row + "\n")
    log.log(f"--genome: IBD estimates written to {path} .")

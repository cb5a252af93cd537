"""--r2-unphased / --r-unphased / --r2-phased / --r-phased: pairwise LD
correlation tables and matrices.

Port of plink_tpu/commands/vcor.py.  Behavior reference: Vcor
(2.0/plink2_ld.cc:12054).
- unphased r = Pearson correlation of ALT-dosage vectors over the
  both-nonmissing included samples;
- phased r = composite haplotype correlation with the double-het phase
  resolved by the exact ML haplotype cubic (stats/phased_ld.py, the plink
  1.9 --r2 algorithm);
- table mode: one row per pair within --ld-window-kb (default 1000) whose
  r^2 >= --ld-window-r2 (default 0.2); columns
  #CHROM_A POS_A ID_A CHROM_B POS_B ID_B <METRIC> (r: with MAJ_A / MAJ_B);
- matrix modes square / square0 / triangle (text) and bin / bin4, with a
  .vars ID list.

Device work: the table's six band statistics are kernel K12 (ops/ld.py
`LdBand`), the phased joint counts and the matrix blocks kernel K13
(`LdJointBand`, `ld_gram_pair`), over the rows of the device-resident
packed matrix with the included samples compacted on the device.  The f64
arithmetic on the exact counts stays on the host in plink_tpu's order, so
the reports are byte-identical; the unphased table evaluates it for a
block of rows at once (the same element-wise operations) instead of one
row at a time.  Inter-chromosome output is not implemented, as in
plink_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.ld import LdBand, LdJointBand, ld_gram_pair
from ..stats.phased_ld import phased_r2
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs
from .ld import _max_bp_window_span, _subcontig_rows

ROW_BLOCK = 4096  # table rows whose pairs are evaluated at once (unphased)
MATRIX_CHUNK = 512  # plink_tpu's chunk of the matrix modes


def _phased_r_from_joint(
    jc: dict, maj_alt_i: np.ndarray, maj_alt_j: np.ndarray
) -> np.ndarray:
    """Exact ML phased r (major-major orientation) from 3x3 joint counts,
    one `phased_r2` a pair (plink_tpu/commands/vcor.py:27-55)."""
    P = len(maj_alt_i)
    nm = jc["nm"].astype(np.float64)
    nmin1 = np.zeros(P)
    nmin2 = np.zeros(P)
    known = np.zeros(P)
    for a in range(3):
        for b in range(3):
            c = jc[f"{a}{b}"].astype(np.float64)
            amin = np.where(maj_alt_i, 2 - a, a)
            bmin = np.where(maj_alt_j, 2 - b, b)
            nmin1 += amin * c
            nmin2 += bmin * c
            if not (a == 1 and b == 1):
                known += np.minimum(amin, bmin) * c
    u = jc["11"].astype(np.float64)
    out = np.empty(P)
    for p in range(P):
        out[p] = phased_r2(nmin1[p], nmin2[p], known[p], u[p], nm[p])
    return out


def _unphased_r(band: LdBand, firsts: np.ndarray, d: np.ndarray) -> np.ndarray:
    dd = band.bands
    dot = dd["dot"][firsts, d].astype(np.float64)
    nm = dd["nm"][firsts, d].astype(np.float64)
    s_i = dd["sum_i"][firsts, d].astype(np.float64)
    q_i = dd["ssq_i"][firsts, d].astype(np.float64)
    s_j = dd["sum_j"][firsts, d].astype(np.float64)
    q_j = dd["ssq_j"][firsts, d].astype(np.float64)
    cov = dot * nm - s_i * s_j
    v1 = q_i * nm - s_i * s_i
    v2 = q_j * nm - s_j * s_j
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where((v1 > 0) & (v2 > 0), cov / np.sqrt(v1 * v2), np.nan)


def _included_samples(ds: Dataset):
    """The included samples, their padded count and the int8 sample mask
    of the compacted rows."""
    inc_s = np.flatnonzero(ds.sample_mask)
    npad = -(-len(inc_s) // 4) * 4
    smask = np.zeros(npad, np.int8)
    smask[: len(inc_s)] = 1
    return inc_s, npad, smask


def _table_pairs(band: LdBand, bps: np.ndarray, window_bp: int, r0: int, r1: int):
    """(firsts, d) of the table's pairs with first variant in [r0, r1), in
    plink_tpu's row order: i ascending, then d ascending; d <= the band's
    width, i + d inside the subcontig and within window_bp."""
    n = band.n
    i = np.arange(r0, r1)[:, None]
    d = np.arange(1, band.width + 1)[None, :]
    j = i + d
    inside = j < n
    inside &= bps[np.minimum(j, n - 1)] - bps[i] <= window_bp
    ii, kk = np.nonzero(inside)
    return ii + r0, kk + 1


def run_vcor(ds: Dataset, cfg, log: RunLogger) -> None:
    if getattr(cfg, "parallel", None) is not None:
        log.log(
            "Note: --r/--r2 ignores --parallel here; the variant-block "
            "device mesh shards this computation instead (SURVEY P6/P9: "
            "psum over ICI supersedes multi-invocation sharding).")

    phased, squared = cfg.vcor
    args = set(getattr(cfg, "vcor_args", ()))
    shape = None
    for m in ("square", "square0", "triangle"):
        if m in args:
            shape = m
    if shape is not None or args & {"bin", "bin4"}:
        _vcor_matrix(ds, cfg, log, phased, squared, shape or "square",
                     "bin" in args, "bin4" in args)
        return
    window_bp = int(cfg.ld_window_kb * 1000) if cfg.ld_window_kb else 1_000_000
    r2_thresh = cfg.ld_window_r2 if cfg.ld_window_r2 is not None else 0.2
    metric = ("PHASED" if phased else "UNPHASED") + ("_R2" if squared else "_R")

    inc_s, npad, smask = _included_samples(ds)
    # signed-r reports are oriented to the MAJOR alleles and list them
    freqs = np.nan_to_num(alt_allele_freqs(ds, founders_only=True))
    maj_is_alt = freqs > 0.5
    alt1 = ds.vi.alt1()
    maj_allele = np.where(maj_is_alt, alt1, ds.vi.ref)

    path = cfg.out + ".vcor"
    rows_out = []
    ci = ds.vi.chr_info
    for chrom in np.unique(ds.vi.chrom[ds.variant_mask]):
        cidx = np.flatnonzero(ds.variant_mask & (ds.vi.chrom == chrom))
        if cidx.size < 2:
            continue
        bps = ds.vi.pos[cidx].astype(np.int64)
        # max pair distance within the bp window
        width = _max_bp_window_span(bps, window_bp)
        if width < 1:
            continue
        rows = _subcontig_rows(ds, cidx, inc_s, npad)
        band = LdBand(rows, smask, width)
        joint = LdJointBand(rows, smask, width) if phased else None
        del rows
        cname = ci.name(int(chrom))
        for r0 in range(0, len(cidx), ROW_BLOCK):
            firsts, d = _table_pairs(band, bps, window_bp, r0,
                                     min(r0 + ROW_BLOCK, len(cidx)))
            if firsts.size == 0:
                continue
            if phased:
                # phased r comes back already major-major oriented
                r = _phased_r_from_joint(joint.joint_counts(firsts, d),
                                         maj_is_alt[cidx[firsts]],
                                         maj_is_alt[cidx[firsts + d]])
            else:
                # unphased r is REF-oriented; flip to major orientation
                r = _unphased_r(band, firsts, d)
                sgn_i = np.where(maj_is_alt[cidx[firsts]], -1.0, 1.0)
                sgn_j = np.where(maj_is_alt[cidx[firsts + d]], -1.0, 1.0)
                r = r * sgn_i * sgn_j
            r2 = r * r
            for k in np.flatnonzero(r2 >= r2_thresh):
                vi_a, vi_b = cidx[firsts[k]], cidx[firsts[k] + d[k]]
                if squared:
                    rows_out.append(
                        f"{cname}\t{ds.vi.pos[vi_a]}\t{ds.vi.vid[vi_a]}\t"
                        f"{cname}\t{ds.vi.pos[vi_b]}\t{ds.vi.vid[vi_b]}\t"
                        f"{g6(r2[k])}\n"
                    )
                else:
                    rows_out.append(
                        f"{cname}\t{ds.vi.pos[vi_a]}\t{ds.vi.vid[vi_a]}\t"
                        f"{maj_allele[vi_a]}\t"
                        f"{cname}\t{ds.vi.pos[vi_b]}\t{ds.vi.vid[vi_b]}\t"
                        f"{maj_allele[vi_b]}\t{g6(r[k])}\n"
                    )
    with open(path, "w") as f:
        if squared:
            f.write(f"#CHROM_A\tPOS_A\tID_A\tCHROM_B\tPOS_B\tID_B\t{metric}\n")
        else:
            f.write(
                f"#CHROM_A\tPOS_A\tID_A\tMAJ_A\tCHROM_B\tPOS_B\tID_B\tMAJ_B\t"
                f"{metric}\n"
            )
        f.writelines(rows_out)
    flag = ("--r2-" if squared else "--r-") + ("phased" if phased else "unphased")
    log.log(f"{flag}: Results written to {path} .")


def _vcor_matrix(ds: Dataset, cfg, log: RunLogger, phased, squared, shape,
                 bin8, bin4) -> None:
    """Matrix output modes (VcorMatrixThread, 2.0/plink2_ld.cc:9522):
    all-pairs r/r^2 over the included variants, text square/square0/triangle
    or bin/bin4, with a companion .vars ID list.  Unphased r derives from
    K13's plane Gram of each pair of 512-variant chunks; phased r uses the
    per-pair ML haplotype cubic on LdJointBand's counts."""
    inc_s, npad, smask_np = _included_samples(ds)
    sel = np.flatnonzero(ds.variant_mask)
    n = len(sel)
    freqs = np.nan_to_num(alt_allele_freqs(ds, founders_only=True))
    maj_is_alt = freqs > 0.5
    sgn = np.where(maj_is_alt[sel], -1.0, 1.0)

    packed = _subcontig_rows(ds, sel, inc_s, npad)
    smask = torch.from_numpy(smask_np).to(packed.device)
    r = np.empty((n, n))
    chunk = MATRIX_CHUNK
    for a0 in range(0, n, chunk):
        pa = packed[a0 : a0 + chunk]
        for b0 in range(0, a0 + chunk, chunk):
            pb = packed[b0 : b0 + chunk]
            g = ld_gram_pair(pa, pb, smask).cpu().numpy().astype(np.float64)
            ca = min(chunk, n - a0)
            cb = min(chunk, n - b0)
            blk = {}
            for ia, ka in enumerate("RAV"):
                for ib, kb in enumerate("RAV"):
                    blk[ka + kb] = g[ia * ca : (ia + 1) * ca,
                                     ib * cb : (ib + 1) * cb]
            nm = blk["VV"]
            dot = (nm - blk["VR"] + blk["VA"] - blk["RV"] + blk["RR"]
                   - blk["RA"] + blk["AV"] - blk["AR"] + blk["AA"])
            s1 = nm - blk["RV"] + blk["AV"]
            s2 = nm - blk["VR"] + blk["VA"]
            q1 = nm - blk["RV"] + 3.0 * blk["AV"]
            q2 = nm - blk["VR"] + 3.0 * blk["VA"]
            with np.errstate(divide="ignore", invalid="ignore"):
                num = nm * dot - s1 * s2
                den = np.sqrt((nm * q1 - s1 * s1) * (nm * q2 - s2 * s2))
                rv = num / den
            rv = rv * sgn[a0 : a0 + ca, None] * sgn[None, b0 : b0 + cb]
            r[a0 : a0 + ca, b0 : b0 + cb] = rv
            r[b0 : b0 + cb, a0 : a0 + ca] = rv.T

    if phased:
        jb = LdJointBand(packed, smask_np, n - 1)
        for i in range(n):
            d = np.arange(1, n - i)
            if d.size == 0:
                continue
            jc = jb.joint_counts(np.full(d.size, i), d)
            rr = _phased_r_from_joint(
                jc, np.full(d.size, maj_is_alt[sel[i]]),
                maj_is_alt[sel[i + d]],
            )
            r[i, i + d] = rr
            r[i + d, i] = rr
    del packed
    np.fill_diagonal(r, 1.0)
    vals = r * r if squared else r

    base = cfg.out + ("." + ("phased" if phased else "unphased")
                      + (".vcor2" if squared else ".vcor1"))
    if bin8 or bin4:
        path = base + ".bin"
        (vals.astype(np.float32) if bin4 else vals.astype(np.float64)).tofile(path)
    else:
        path = base
        with open(path, "w") as f:
            for i in range(n):
                if shape == "triangle":
                    row = vals[i, : i + 1]
                elif shape == "square0":
                    row = np.r_[vals[i, : i + 1], np.zeros(n - i - 1)]
                else:
                    row = vals[i]
                f.write("\t".join(g6(x) for x in row) + "\n")
    with open(base + ".vars", "w") as f:
        for v in sel:
            f.write(str(ds.vi.vid[v]) + "\n")
    flag = ("--r2-" if squared else "--r-") + ("phased" if phased else "unphased")
    log.log(f"{flag}: Matrix written to {path} .")


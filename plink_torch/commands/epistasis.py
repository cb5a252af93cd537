"""--fast-epistasis: pairwise SNP-SNP interaction scan, PLINK 1.9 parity
(plink_tpu/commands/epistasis.py).

Behavior reference: epistasis_report / fast_epi_thread / fepi_counts_*
(1.9/plink_ld.c:3161-4150, 9374-10420) and flag parsing
(1.9/plink.c:6807-6860, 7175-7191).

1.9 splits each variant into three genotype bitplanes and walks pair blocks
with POPCNT loops (two_locus_count_table).  Here kernel K24
(ops/epistasis.py, csrc/epi_counts.cu) packs each group's split planes of
the kept variants once, from the device-resident packed matrix, and counts
every pair's full 3x3 joint table of a row block against all kept variants
with AND + popcount; the monomorphic screen reads the cases' and controls'
genotype counts from K1.  The scalar statistics (CASSI Ueki-adjusted
log-OR, CASSI joint-effects, BOOST KL screening) are evaluated vectorized
in float64 on the host in the reference's exact expression order, so
.epi.cc / .epi.co output is byte-identical to plink_tpu's.

Stats (all credited by the reference to Howey's CASSI and BOOSTx64):
- default/no-ueki: allele-collapsed 2x2 log-odds-ratio difference
  between cases and controls, z^2 = (lnOR_case - lnOR_ctrl)^2 /
  (var_case + var_ctrl); Ueki-adjustment adds 4.5/0.5 pseudo-counts
  when a cell is empty.
- joint-effects: the CASSI JointEffects statistic (4x4 inverse-variance
  weighting of log interaction contrasts).
- boost: KL-divergence screen against the Kirkwood superposition
  approximation, refined by iterative proportional fitting; df encoded
  in the low bits of the stored chi-square exactly like the reference.
- case-only: cases-only 3x3 table, pairs on the same chromosome closer
  than --gap excluded.
"""

from __future__ import annotations

import math

import numpy as np

from ..cli import FlagError
from ..dataset import Dataset
from ..ops.epistasis import joint_tables, split_planes
from ..stats.distributions import chisq_logsf, chisq_sf
from ..utils.chrom import MT_CODE, X_CODE, Y_CODE
from ..utils.fmt import dtoa_g, dtoa_g_wxp4, fw_width
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs
from .cluster import _ltqnorm
from .sets import define_sets

SMALL_EPSILON = 0.00000000000005684341886080801486968994140625


def _normdist(zz: float) -> float:
    """1.9 normdist (plink_common.c:10412): Abramowitz-Stegun 26.2.17."""
    sqrt2pi = 2.50662827463
    t0 = 1 / (1 + 0.2316419 * abs(zz))
    z1 = math.exp(-0.5 * zz * zz) / sqrt2pi
    p0 = z1 * t0 * (0.31938153 + t0 * (-0.356563782 + t0 * (
        1.781477937 + t0 * (-1.821255978 + 1.330274429 * t0))))
    return 1 - p0 if zz >= 0 else p0


def _inverse_chiprob(q: float, df: int) -> float:
    """chi-square quantile via bisection on the survival function
    (reference uses dcdflib's cdfchi; 1e-14 relative agreement)."""
    if q >= 1.0:
        return 0.0
    target = math.log(q)
    lo, hi = 0.0, 1.0
    while chisq_logsf(hi, df) > target:
        hi *= 2
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid == lo or mid == hi:
            break
        if chisq_logsf(mid, df) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class EpiParams:
    def __init__(self, cfg, fast_mods):
        self.boost = False
        self.joint = False
        self.no_ueki = False
        self.case_only = False
        self.nop = False
        self.set_by_set = False
        self.set_by_all = False
        for m in fast_mods:
            if m == "boost":
                if self.no_ueki or self.joint:
                    raise FlagError(
                        "--fast-epistasis 'boost' modifier cannot be used "
                        "with 'no-ueki'/'joint-effects'.")
                if self.case_only:
                    raise FlagError(
                        "--fast-epistasis boost does not have a case-only "
                        "mode.")
                self.boost = True
            elif m == "joint-effects":
                if self.no_ueki or self.boost:
                    raise FlagError(
                        "--fast-epistasis 'joint-effects' modifier cannot "
                        "be used with 'no-ueki'/'boost'.")
                self.joint = True
            elif m == "no-ueki":
                if self.boost or self.joint:
                    raise FlagError(
                        "--fast-epistasis 'no-ueki' modifier cannot be "
                        "used with 'boost'/'joint-effects'.")
                self.no_ueki = True
            elif m == "case-only":
                if self.boost:
                    raise FlagError(
                        "--fast-epistasis boost does not have a case-only "
                        "mode.")
                self.case_only = True
            elif m == "nop":
                self.nop = True
            elif m == "set-by-set":
                self.set_by_set = True
            elif m == "set-by-all":
                self.set_by_all = True
            else:
                raise FlagError(
                    f"Invalid --fast-epistasis modifier '{m}'.")
        self.epi1 = cfg.epi1
        self.epi2 = cfg.epi2 if cfg.epi2 is not None else 0.01
        self.cellmin = (cfg.je_cellmin if cfg.je_cellmin is not None
                        else 5)
        gap_kb = cfg.epi_gap if cfg.epi_gap is not None else 1000.0
        self.case_only_gap = min(
            int(gap_kb * 1000 * (1 + SMALL_EPSILON)), 2147483646)


def _screen_markers(ds: Dataset, case_cts, ctrl_cts, keep, hp):
    """Drop non-autosomal-diploid and monomorphic sites
    (epistasis_report, 1.9/plink_ld.c:9540-9612) by the cases' and
    controls' genotype counts [V, 4] (hom-REF, het, hom-ALT, missing)."""
    vi = ds.vi
    haploid = np.isin(vi.chrom, (X_CODE, Y_CODE, MT_CODE))
    keep = keep & ~haploid
    idx = np.flatnonzero(keep)
    case_c, ctrl_c = case_cts[idx], ctrl_cts[idx]
    cellminx3 = hp.cellmin * 3 if hp.joint else 0
    groups = [case_c] + ([] if hp.case_only else [ctrl_c])
    if hp.no_ueki:
        poly = np.ones(idx.size, bool)
        for c in groups:
            n0, n1, n2 = c[:, 0], c[:, 1], c[:, 2]
            # monomorphic: only one allele observed (all-het is fine)
            poly &= ~(((n2 + n1) == 0) | ((n0 + n1) == 0))
    elif cellminx3:
        # --je-cellmin: every genotype class must reach 3*cellmin in
        # cases and (unless case-only) controls (1.9/plink_ld.c:9594-9608)
        poly = np.ones(idx.size, bool)
        for c in groups:
            poly &= (c[:, :3] >= cellminx3).all(axis=1)
    else:
        c = case_c + ctrl_c
        n0, n1, n2 = c[:, 0], c[:, 1], c[:, 2]
        if hp.boost:
            # less_than_two_genotypes: <2 genotype classes present
            poly = ((n0 > 0).astype(int) + (n1 > 0) + (n2 > 0)) >= 2
        else:
            poly = ~(((n2 + n1) == 0) | ((n0 + n1) == 0))
    keep2 = np.zeros_like(keep)
    keep2[idx[poly]] = True
    return keep2


def best_pair_update(best_chisq, best_id, rows_idx, pi, pj, zbest, triangular):
    """The per-marker best partner of one row block (plink_tpu's per-pair
    loop, epistasis.py:705-714, vectorized).  The loop visits a marker's
    candidates in ascending partner order (as a column of the rows before
    it, then its own columns) and keeps a strictly larger value, so the
    block's column-side maxima go first (the first row reaching each) and
    its row-side maxima after them (the first column)."""
    z = np.full((len(rows_idx), best_chisq.size), -np.inf)
    z[pi, pj] = zbest
    if triangular:
        top, arg = z.max(axis=0), z.argmax(axis=0)
        upd = top > best_chisq
        best_chisq[upd] = top[upd]
        best_id[upd] = rows_idx[arg[upd]]
    top, arg = z.max(axis=1), z.argmax(axis=1)
    upd = top > best_chisq[rows_idx]
    best_chisq[rows_idx[upd]] = top[upd]
    best_id[rows_idx[upd]] = arg[upd]


def _ueki_stats(n, no_ueki):
    """fepi_counts_to_stats (1.9/plink_ld.c:3449), vectorized.
    n: [..., 9] float64 cell counts. Returns (log_or, var)."""
    c11 = 4 * n[..., 0] + 2 * (n[..., 1] + n[..., 3]) + n[..., 4]
    c12 = 4 * n[..., 2] + 2 * (n[..., 1] + n[..., 5]) + n[..., 4]
    c21 = 4 * n[..., 6] + 2 * (n[..., 3] + n[..., 7]) + n[..., 4]
    c22 = 4 * n[..., 8] + 2 * (n[..., 5] + n[..., 7]) + n[..., 4]
    with np.errstate(divide="ignore", invalid="ignore"):
        if no_ueki:
            rc11, rc12 = 1.0 / c11, 1.0 / c12
            rc21, rc22 = 1.0 / c21, 1.0 / c22
            return np.log(c11 * c22 * rc12 * rc21), rc11 + rc12 + rc21 + rc22
        no_adj = np.all(n != 0, axis=-1)
        adj = np.where(no_adj, 0.0, 4.5)
        c11 = c11 + adj
        c12 = c12 + adj
        c21 = c21 + adj
        c22 = c22 + adj
        rc11, rc12 = 1.0 / c11, 1.0 / c12
        rc21, rc22 = 1.0 / c21, 1.0 / c22
        lor = np.log(c11 * c22 * rc12 * rc21)
        b2 = rc11 - rc12
        b3 = rc11 - rc21
        b5 = rc11 - rc12 - rc21 + rc22
        b6 = rc22 - rc12
        b8 = rc22 - rc21
        hadj = np.where(no_adj, 0.0, 0.5)
        var = 4 * (4 * (rc11 * rc11 * (n[..., 0] + hadj)
                        + rc12 * rc12 * (n[..., 2] + hadj)
                        + rc21 * rc21 * (n[..., 6] + hadj)
                        + rc22 * rc22 * (n[..., 8] + hadj))
                   + b2 * b2 * (n[..., 1] + hadj)
                   + b3 * b3 * (n[..., 3] + hadj)
                   + b6 * b6 * (n[..., 5] + hadj)
                   + b8 * b8 * (n[..., 7] + hadj)) \
            + b5 * b5 * (n[..., 4] + hadj)
        return lor, var


def _joint_effects_stats(groups):
    """fepi_counts_to_joint_effects_stats (1.9/plink_ld.c:3161),
    vectorized.  groups: list of [N, 9] int64 tables (cases[, ctrls]).
    Returns (diff, var_case, var_ctrl)."""
    g_ct = len(groups)
    n = groups[0].shape[0]
    allpos = np.ones(n, bool)
    for g in groups:
        allpos &= np.all(g != 0, axis=1)
    dc = []
    for g in groups:
        d = np.where(allpos[:, None], g.astype(np.float64),
                     g.astype(np.float64) + 0.5)
        # the 1%-cell redistribution works off the RAW total (dxx in the
        # reference accumulates to sum(counts) in both branches), with a
        # +4.5 rebate in the 0.5-adjusted branch (1.9/plink_ld.c:3253-3291)
        raw = g.sum(1).astype(np.float64)
        last = d[:, 8]
        small = last * 100 < raw
        adj = np.where(allpos, 0.0, 4.5)
        fac = np.where(small, raw / (1.01 * raw - last + adj), 1.0)
        d = d * fac[:, None]
        d[:, 8] = np.where(small, 0.01 * fac * raw, d[:, 8])
        dc.append(d)
    inv = [1.0 / d for d in dc]
    ivv = []
    for d, iv in zip(dc, inv):
        dxx = d[:, 8]
        ivv.append(np.stack([
            dxx * d[:, 0] * iv[:, 2] * iv[:, 6],
            dxx * d[:, 1] * iv[:, 2] * iv[:, 7],
            dxx * d[:, 3] * iv[:, 5] * iv[:, 6],
            dxx * d[:, 4] * iv[:, 5] * iv[:, 7],
        ], axis=1))
    use_reg = ivv[0][:, 3] > 0.5
    if g_ct == 2:
        use_reg = use_reg & (ivv[1][:, 3] > 0.5)
    tot_inv_v = []
    lam = []
    for gi, (d, iv) in enumerate(zip(dc, inv)):
        i22, i21, i12, i11 = (ivv[gi][:, k] for k in range(4))
        s22 = np.sqrt(i22)
        xi0 = np.where(use_reg, 0.5, s22 / (2 * s22 + 2))
        xi1 = np.where(use_reg, 1.0, i21 / (i21 + 1))
        xi2 = np.where(use_reg, 1.0, i12 / (i12 + 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            xi3 = np.where(use_reg, 2 * i11 / (2 * i11 - 1), 1.0)
        q = iv  # invq00 = q[:,8], invq01 = q[:,7], ...
        m = np.empty((n, 4, 4))
        dxx = q[:, 8]
        m[:, 0, 0] = (q[:, 0] + q[:, 2] + q[:, 6] + dxx) * xi0 * xi0
        m[:, 0, 1] = (q[:, 2] + dxx) * xi0 * xi1
        m[:, 0, 2] = (q[:, 6] + dxx) * xi0 * xi2
        m[:, 0, 3] = dxx * xi0 * xi3
        m[:, 1, 1] = (q[:, 1] + q[:, 2] + q[:, 7] + dxx) * xi1 * xi1
        m[:, 1, 2] = dxx * xi1 * xi2
        m[:, 1, 3] = (q[:, 7] + dxx) * xi1 * xi3
        m[:, 2, 2] = (q[:, 3] + q[:, 5] + q[:, 6] + dxx) * xi2 * xi2
        m[:, 2, 3] = (q[:, 5] + dxx) * xi2 * xi3
        m[:, 3, 3] = (q[:, 4] + q[:, 5] + q[:, 7] + dxx) * xi3 * xi3
        m[:, 1, 0] = m[:, 0, 1]
        m[:, 2, 0] = m[:, 0, 2]
        m[:, 2, 1] = m[:, 1, 2]
        m[:, 3, 0] = m[:, 0, 3]
        m[:, 3, 1] = m[:, 1, 3]
        m[:, 3, 2] = m[:, 2, 3]
        minv = np.full_like(m, np.nan)
        ok = np.isfinite(m).all(axis=(1, 2))
        if ok.any():
            try:
                minv[ok] = np.linalg.inv(m[ok])
            except np.linalg.LinAlgError:
                for i in np.flatnonzero(ok):
                    try:
                        minv[i] = np.linalg.inv(m[i])
                    except np.linalg.LinAlgError:
                        pass
        rt = minv.sum(axis=2)
        tot_inv_v.append(rt.sum(axis=1))
        with np.errstate(divide="ignore", invalid="ignore"):
            lam_reg = (rt[:, 0] * np.log(i22) * 0.5
                       + rt[:, 1] * np.log(i21)
                       + rt[:, 2] * np.log(i12)
                       + rt[:, 3] * np.log(2 * i11 - 1))
            lam_alt = (rt[:, 0] * np.log((s22 + 1) * 0.5)
                       + rt[:, 1] * np.log((i21 + 1) * 0.5)
                       + rt[:, 2] * np.log((i12 + 1) * 0.5)
                       + rt[:, 3] * np.log(i11))
        lam.append(np.where(use_reg, lam_reg, lam_alt))
    if g_ct == 1:
        return lam[0], tot_inv_v[0], np.zeros(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        vx = 1.0 / tot_inv_v[0]
        vy = 1.0 / tot_inv_v[1]
        return lam[0] * vx - lam[1] * vy, vx, vy


def _boost_screen(counts):
    """First-pass BOOST KL screen (fepi_counts_to_boost_chisq pre-loop),
    vectorized.  counts: [N, 18] int64.  Returns (screen, df_adj, fail)."""
    n = counts.shape[0]
    ca = counts[:, :9].astype(np.float64)
    co = counts[:, 9:].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        # p_bc: P(g2 | group)
        case_m2 = ca.reshape(n, 3, 3).sum(axis=1)  # case g2 margins
        ctrl_m2 = co.reshape(n, 3, 3).sum(axis=1)
        p_bc = np.concatenate([
            case_m2 * (1.0 / case_m2.sum(1))[:, None],
            ctrl_m2 * (1.0 / ctrl_m2.sum(1))[:, None]], axis=1)  # [N,6]
        # p_ca: P(group | g1), df fail when >=2 empty g1 margins
        case_m1 = ca.reshape(n, 3, 3).sum(axis=2)
        ctrl_m1 = co.reshape(n, 3, 3).sum(axis=2)
        tot_m1 = case_m1 + ctrl_m1
        df_ca = (tot_m1 == 0).sum(axis=1)
        r1 = np.where(tot_m1 == 0, 0.0, 1.0 / tot_m1)
        p_ca_case = case_m1 * r1
        p_ca_ctrl = ctrl_m1 * r1
        fail = df_ca > 1
        # mu_xx: P(g1 | g2) from combined margins; df for empty g2 cols
        tot = ca + co
        tot3 = tot.reshape(n, 3, 3)
        colsum = tot3.sum(axis=1)  # [N, 3] per g2
        df_g2 = (colsum == 0).sum(axis=1)
        fail |= df_g2 > 1
        rcol = np.where(colsum == 0, 0.0, 1.0 / colsum)
        mu_g1_g2 = tot3 * rcol[:, None, :]  # P(g1|g2) [N, g1, g2]
        ssum = tot.sum(1)
        df_adj = df_ca + df_g2
        # mu_cell[group, g1, g2] = P(g1|g2) * P(g2|group) * P(group|g1)
        pb = p_bc.reshape(n, 2, 3)  # [N, group, g2]
        pcs = np.stack([p_ca_case, p_ca_ctrl], axis=1)  # [N, group, g1]
        mu = (mu_g1_g2[:, None, :, :] * pb[:, :, None, :]
              * pcs[:, :, :, None])  # [N, group, g1, g2]
        tau = mu.reshape(n, 18).sum(1)
        cc = counts.reshape(n, 2, 3, 3).astype(np.float64)
        mu_flat = mu
        term = np.where(
            cc > 0,
            np.where(mu_flat != 0.0,
                     -cc * np.log(np.where(cc > 0, mu_flat / np.where(
                         cc > 0, cc, 1.0), 1.0)),
                     cc * np.log(np.where(cc > 0, cc, 1.0))),
            0.0)
        im = term.reshape(n, 18).sum(1)
        screen = 2 * (im + ssum * np.log(tau * (1.0 / ssum)))
    return screen, df_adj, fail, p_bc, np.stack(
        [p_ca_case, p_ca_ctrl], axis=2).reshape(n, 6)


def _boost_full(counts18):
    """Iterative proportional fit + KL statistic (the refinement loop in
    fepi_counts_to_boost_chisq), one pair."""
    counts = counts18.astype(np.float64)
    ssum = counts.sum()
    sum_recip = 1.0 / ssum
    mu = np.ones(18)
    c = counts.reshape(2, 3, 3)  # [group, g1, g2]
    # mu layout mirrors the reference's flat [g1*6 + g2*2 + group]
    m = np.ones((3, 3, 2))
    while True:
        m0 = m.copy()
        # fit [g1, g2] margins (case+ctrl)
        pair = m.sum(axis=2)
        tgt = c.sum(axis=0)
        fac = np.where(pair != 0.0, tgt / np.where(pair != 0, pair, 1), 0.0)
        m = m * fac[:, :, None]
        # fit [g1, group] margins
        pair = m.sum(axis=1)  # [g1, group]
        tgt = c.sum(axis=2).T  # [g1, group]
        fac = np.where(pair != 0.0, tgt / np.where(pair != 0, pair, 1), 0.0)
        m = m * fac[:, None, :]
        # fit [g2, group] margins
        pair = m.sum(axis=0)  # [g2, group]
        tgt = c.sum(axis=1).T  # [g2, group]
        fac = np.where(pair != 0.0, tgt / np.where(pair != 0, pair, 1), 0.0)
        m = m * fac[None, :, :]
        if np.abs(m - m0).sum() <= 0.001:
            break
    tau = 0.0
    im = 0.0
    for grp in range(2):
        for g1 in range(3):
            for g2 in range(3):
                dxx = c[grp, g1, g2] * sum_recip
                dyy = m[g1, g2, grp] * sum_recip
                if dxx != 0.0:
                    if dyy != 0.0:
                        im += dxx * math.log(dxx / dyy)
                    else:
                        im += dxx * math.log(dxx)
                tau += dyy
    return (im + math.log(tau)) * (ssum * 2)


def run_fast_epistasis(ds: Dataset, cfg, log: RunLogger) -> None:
    hp = EpiParams(cfg, cfg.fast_epistasis or ())
    vi, si = ds.vi, ds.si
    pc = next(iter(si.phenos.values()), None)
    if pc is None or pc.kind != "cc":
        raise FlagError(
            "--fast-epistasis requires a case/control phenotype.")
    nonmiss = pc.nonmiss & ds.sample_mask
    case = nonmiss & (pc.data == 1)
    ctrl = nonmiss & (pc.data == 0)
    case_ct, ctrl_ct = int(case.sum()), int(ctrl.sum())
    if case_ct < 2 or ((not hp.case_only) and ctrl_ct < 2):
        raise FlagError(
            "--fast-epistasis requires at least two cases"
            + ("" if hp.case_only else " and two controls") + ".")
    if hp.joint and hp.cellmin:
        need = hp.cellmin * 9
        if case_ct < need or ((not hp.case_only) and ctrl_ct < need):
            raise FlagError(
                f"Too few cases or controls for --je-cellmin "
                f"{hp.cellmin}.")

    # set-by-set / set-by-all restriction (epistasis_report,
    # 1.9/plink_ld.c:9478-9533): one set -> triangular within the set;
    # two sets or set-by-all -> non-triangular row x column grid with
    # self-pairs skipped and row-side-only tallies
    set1_raw = set2_raw = None
    triangular = True
    if hp.set_by_set or hp.set_by_all:
        sinfo = define_sets(ds, cfg, log)
        nset = 0 if sinfo is None else sinfo.ct
        if not nset:
            raise FlagError(
                "--fast-epistasis set-by-"
                f"{'set' if hp.set_by_set else 'all'} requires a variant "
                "set to be loaded.")
        if hp.set_by_all and nset > 1:
            raise FlagError(
                "--{fast-}epistasis set-by-all requires exactly one set.  "
                "(--set-names or\n--set-collapse-all may be handy here.")
        if hp.set_by_set and nset > 2:
            raise FlagError(
                "--{fast-}epistasis set-by-set requires exactly one or two "
                "sets.\n(--set-names or --set-collapse-all may be handy "
                "here.)")
        fidx = np.flatnonzero(ds.variant_mask)
        set1_raw = np.zeros(ds.raw_variant_ct, bool)
        set1_raw[fidx[sinfo.setdefs[0]]] = True
        if hp.set_by_set and nset == 2:
            set2_raw = np.zeros(ds.raw_variant_ct, bool)
            set2_raw[fidx[sinfo.setdefs[1]]] = True
            triangular = False
        elif hp.set_by_all:
            triangular = False

    # the screen's genotype counts: one K1 pass over [case, ctrl]
    case_cts, ctrl_cts = ds.counts([case, ctrl])
    base_mask = ds.variant_mask.copy()
    if triangular and set1_raw is not None:
        base_mask &= set1_raw
    keep = _screen_markers(ds, case_cts, ctrl_cts, base_mask, hp)
    vidx = np.flatnonzero(keep)
    m_ct = vidx.size
    if triangular and m_ct < 2:
        raise FlagError(
            "--{fast-}epistasis requires 2+ autosomal diploid loci not "
            "monomorphic in either cases or controls.")
    n_skipped = int(base_mask.sum()) - m_ct
    if n_skipped:
        if hp.joint and hp.cellmin:
            log.log(f"--fast-epistasis: Skipping {n_skipped} site"
                    f"{'' if n_skipped == 1 else 's'} due to "
                    f"--je-cellmin setting.")
        else:
            log.log(f"--fast-epistasis: Skipping {n_skipped} "
                    f"monomorphic/non-autosomal site"
                    f"{'' if n_skipped == 1 else 's'}.")

    # row/column universes over the keep survivors
    if triangular:
        row_sel = np.arange(m_ct)
        col_mask_u = np.ones(m_ct, bool)
    else:
        row_sel = np.flatnonzero(set1_raw[vidx])
        if set2_raw is not None:
            col_mask_u = set2_raw[vidx]
        else:
            col_mask_u = np.ones(m_ct, bool)
        if row_sel.size == 0 or int(col_mask_u.sum()) == 0:
            raise FlagError(
                "Each --{fast-}epistasis set must contain at least one "
                "autosomal diploid\nlocus not monomorphic in either cases "
                "or controls.")
    m2_ct = int(col_mask_u.sum())

    chrom = vi.chrom[vidx]
    pos = vi.pos[vidx].astype(np.int64)

    # split genotype planes (load_and_split3, 1.9/plink_ld.c:2795), plane
    # order [hom A1, het, hom A2] with per-marker do_reverse so A1 is the
    # minor allele (1.9's marker_reverse convention), one set a group, made
    # once from the device-resident matrix (K24's packing pass)
    a1_is_alt = ~(alt_allele_freqs(ds, founders_only=True, dosage=True) > 0.5)[vidx]
    groups = [np.flatnonzero(case)]
    if not hp.case_only:
        groups.append(np.flatnonzero(ctrl))
    planes = split_planes(ds.device_all_packed(), vidx, a1_is_alt, groups)

    # alpha thresholds
    if hp.boost:
        p1 = hp.epi1 if hp.epi1 else 0.000005
        alpha1 = [_inverse_chiprob(p1, d) for d in (4, 2, 1)]
        a2_0 = _inverse_chiprob(hp.epi2, 4)
        if alpha1[0] == a2_0:
            alpha2 = [alpha1[k] * (1 + SMALL_EPSILON) for k in range(3)]
        else:
            alpha2 = [a2_0] + [_inverse_chiprob(hp.epi2, d) for d in (2, 1)]
    else:
        dxx = hp.epi1 * 0.5 if hp.epi1 else 0.00005
        z = _ltqnorm(dxx)
        alpha1 = [z * z]
        z = _ltqnorm(hp.epi2 / 2)
        alpha2 = [z * z]

    # case-only --gap exclusion bounds: for row i, columns resume at the
    # first same-chrom index with pos >= pos_i + gap (or next chromosome)
    if hp.case_only:
        resume = np.empty(m_ct, np.int64)
        for i in range(m_ct):
            j = i + 1
            lim = pos[i] + hp.case_only_gap
            while j < m_ct and chrom[j] == chrom[i] and pos[j] < lim:
                j += 1
            resume[i] = j
    else:
        resume = np.arange(1, m_ct + 1)

    n_sig = np.zeros(m_ct, np.int64)
    fails = np.zeros(m_ct, np.int64)
    gap_cts = np.zeros(m_ct, np.int64)
    if hp.case_only:
        for i in range(m_ct):
            gap_cts[i] += resume[i] - i - 1
            gap_cts[i + 1: resume[i]] += 1
    best_chisq = np.zeros(m_ct)
    best_id = np.zeros(m_ct, np.int64)

    maxsnp = fw_width(
        len(str(vi.vid[i])) for i in np.flatnonzero(ds.variant_mask))
    ci = vi.chr_info
    out_path = cfg.out + (".epi.co" if hp.case_only else ".epi.cc")
    with open(out_path, "w") as fh:
        hdr = ("CHR1 " + "SNP1".rjust(maxsnp) + " CHR2 "
               + "SNP2".rjust(maxsnp) + "         STAT ")
        if hp.boost:
            hdr += "  DF "
        if not hp.nop:
            hdr += "           P "
        fh.write(hdr + "\n")

        B = 256 if not hp.boost else 96
        min_p = 0.0
        n_rows_tot = row_sel.size
        for r0 in range(0, n_rows_tot, B):
            r1 = min(r0 + B, n_rows_tot)
            nb = r1 - r0
            rows_idx = row_sel[r0:r1]
            # K24: the block's joint tables against every kept variant
            tabs = joint_tables(planes, rows_idx)
            # pair mask: triangular j > i (case-only gap applied), or the
            # column universe minus self in set mode
            mask = np.zeros((nb, m_ct), bool)
            if triangular:
                for k, i in enumerate(rows_idx):
                    mask[k, resume[i]:] = True
            else:
                for k, i in enumerate(rows_idx):
                    mask[k] = col_mask_u
                    if col_mask_u[i]:
                        mask[k, i] = False
                        gap_cts[i] += 1
            pi, pj = np.nonzero(mask)
            if pi.size == 0:
                continue
            lo = int(pj.min())
            tabs = tabs[:, :, lo:].cpu().numpy()
            cts = [t[pi, pj - lo].astype(np.int64) for t in tabs]  # [N, 9] per group
            n_pairs = pi.size
            gi_idx = rows_idx[pi]
            if hp.boost:
                c18 = np.concatenate(cts, axis=1)
                screen, df_adj, failv, _, _ = _boost_screen(c18)
                zsq = screen.copy()
                stored = np.full(n_pairs, np.nan)
                has_store = np.zeros(n_pairs, bool)
                a1 = np.array(alpha1)[np.minimum(df_adj, 2)]
                a2 = np.array(alpha2)[np.minimum(df_adj, 2)]
                refine = (~failv) & (screen > a1)
                for k in np.flatnonzero(refine):
                    full = _boost_full(c18[k])
                    # df encoded in the stored double's low 2 bits
                    b = bytearray(np.float64(full).tobytes())
                    iv = int.from_bytes(b, "little")
                    iv = (iv & ~3) | int(min(df_adj[k], 3))
                    stored[k] = np.frombuffer(
                        iv.to_bytes(8, "little"), np.float64)[0]
                    has_store[k] = True
                    zsq[k] = max(full, a1[k])
                ok = ~failv & np.isfinite(zsq)
                sig = ok & (zsq >= a2)
            else:
                if hp.joint:
                    lor, var, cvar = _joint_effects_stats(cts)
                    # empty-cell pairs produce var == 0 / nan here; they are
                    # masked by the isfinite() check below, so silence the
                    # divide warnings rather than let them leak per-block
                    with np.errstate(divide="ignore", invalid="ignore"):
                        zsq = lor * lor / (var + cvar)
                    if hp.cellmin:
                        # per-pair cell minimum (1.9/plink_ld.c:3955-3963)
                        cellok = np.all(cts[0] >= hp.cellmin, axis=1)
                        if not hp.case_only:
                            cellok &= np.all(cts[1] >= hp.cellmin, axis=1)
                        zsq = np.where(cellok, zsq, np.nan)
                else:
                    ca = cts[0].astype(np.float64)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        lor, var = _ueki_stats(ca, hp.no_ueki)
                        if not hp.case_only:
                            lor2, var2 = _ueki_stats(
                                cts[1].astype(np.float64), hp.no_ueki)
                            lor = lor - lor2
                            var = var + var2
                        zsq = lor * lor / var
                ok = np.isfinite(zsq)
                sig = ok & (zsq >= alpha2[0])
                has_store = ok & (zsq >= alpha1[0])
                stored = zsq
            # aggregate per-marker tallies (both orientations when
            # triangular; row side only in set mode -- the reference's
            # column-side accumulation is gated on is_triangular,
            # 1.9/plink_ld.c:8763)
            n_sig += np.bincount(gi_idx[sig], minlength=m_ct)
            fails += np.bincount(gi_idx[~ok], minlength=m_ct)
            if triangular:
                n_sig += np.bincount(pj[sig], minlength=m_ct)
                fails += np.bincount(pj[~ok], minlength=m_ct)
            best_pair_update(best_chisq, best_id, rows_idx, pi, pj,
                             np.where(ok, zsq, 0.0), triangular)
            # emit rows in (i, j) order
            emit = np.flatnonzero(has_store)
            for k in emit:
                i, jx = gi_idx[k], pj[k]
                u1, u2 = int(vidx[i]), int(vidx[jx])
                line = (ci.name19(int(chrom[i])).rjust(4) + " "
                        + str(vi.vid[u1]).rjust(maxsnp) + " "
                        + ci.name19(int(chrom[jx])).rjust(4) + " "
                        + str(vi.vid[u2]).rjust(maxsnp) + " ")
                if hp.boost:
                    v = stored[k]
                    b = int.from_bytes(np.float64(v).tobytes(), "little")
                    df = 4 >> (b & 3)
                    v2 = np.frombuffer(
                        (b & ~3).to_bytes(8, "little"), np.float64)[0]
                    line += dtoa_g(float(v2)).rjust(12) + "     " \
                        + str(df) + " "
                    if not hp.nop:
                        p = float(chisq_sf(float(v2), df))
                        line += dtoa_g_wxp4(max(p, min_p), 12) + " "
                elif not hp.no_ueki:
                    line += dtoa_g(float(stored[k])).rjust(12) + " "
                    if not hp.nop:
                        p = _normdist(-math.sqrt(float(stored[k]))) * 2
                        line += dtoa_g_wxp4(max(p, min_p), 12) + " "
                else:
                    line += dtoa_g_wxp4(float(stored[k]), 12) + " "
                    if not hp.nop:
                        p = _normdist(-math.sqrt(float(stored[k]))) * 2
                        line += dtoa_g_wxp4(max(p, min_p), 12) + " "
                fh.write(line + "\n")

    write_epi_summary(out_path, vi, ci, chrom, vidx, maxsnp, n_sig,
                      fails, gap_cts, best_chisq, best_id, m_ct, log,
                      row_sel=None if triangular else row_sel,
                      m2_ct=m2_ct)


def write_epi_summary(out_path, vi, ci, chrom, vidx, maxsnp, n_sig,
                      fails, gap_cts, best_chisq, best_id, m_ct,
                      log, row_sel=None, m2_ct=None) -> None:
    """Shared .summary writer (epistasis_report,
    1.9/plink_ld.c:10300-10420).  With row_sel (set mode), only the set1
    rows are listed, N_TOT = column count - thrown, and the valid-test
    total is not halved."""
    sum_path = out_path + ".summary"
    rows_iter = range(m_ct) if row_sel is None else [int(r) for r in row_sel]
    if m2_ct is None:
        m2_ct = m_ct
    with open(sum_path, "w") as fo:
        fo.write(" CHR " + "SNP".rjust(maxsnp)
                 + "        N_SIG        N_TOT         PROP   BEST_CHISQ"
                 " BEST_CHR " + "BEST_SNP".rjust(maxsnp) + " \n")
        thrown = 0
        for i in rows_iter:
            bad = int(fails[i] + gap_cts[i])
            thrown += bad
            n_tot = (m_ct - 1 - bad) if row_sel is None \
                else (m2_ct - bad)
            u = int(vidx[i])
            line = (ci.name19(int(chrom[i])).rjust(4) + " "
                    + str(vi.vid[u]).rjust(maxsnp) + "   "
                    + str(int(n_sig[i])).rjust(10) + "   "
                    + str(n_tot).rjust(10) + " "
                    + dtoa_g_wxp4(n_sig[i] / n_tot if n_tot else np.nan, 12) + " ")
            if n_tot:
                u2 = int(vidx[best_id[i]])
                line += (dtoa_g_wxp4(float(best_chisq[i]), 12) + " "
                         + ci.name19(int(chrom[best_id[i]])).rjust(4) + " "
                         + str(vi.vid[u2]).rjust(maxsnp))
            else:
                # memcpya("          NA   NA") + (maxsnp-1) spaces + NA
                # (1.9/plink_ld.c:10380-10383)
                line += "          NA   NA" + " " * (maxsnp - 1) + "NA"
            fo.write(line + " \n")
    if row_sel is None:
        total = (m_ct * (m_ct - 1)) // 2
        valid = total - thrown // 2
    else:
        valid = len(rows_iter) * m2_ct - thrown
    log.log(f"{valid} valid test{'' if valid == 1 else 's'} performed, "
            f"summary written to {sum_path} .")

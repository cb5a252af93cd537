"""--ibs-test: case/control IBS permutation test.

Behavior reference: ibs_test_calc / ibs_test_range / fill_psbuf /
ibs_test_process_perms (1.9/plink_calc.c:762-2970) and
generate_perm1_interleaved (1.9/plink_common.c:10444).

Distances are the calc_distance weighted-missing rescaled allele-count
values (our run_distance engine); IBS(i,j) = 1 - dist * 0.5/marker_ct.
The permutation loop replicates the reference's exact float op order:
per row, 64-column blocks, 8-column sub-blocks with the 256-entry
partial-sum walk, so the reported means/SDs and empirical p-values are
byte-identical for a fixed --seed (single-thread compute partitioning;
permutation generation always consumes the master SFMT stream).
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..stats.perm19 import generate_cc_perm, master_sfmt
from ..utils.logging import RunLogger


def _fill_psbuf(dvals, case_cols, ssq_io):
    """fill_psbuf for one block (<=64 cols): returns (block_tot,
    psbuf[8][256]).  dvals: IBS values per column; case_cols: original
    case status per column (for the ssq update)."""
    block_size = dvals.size
    psbuf = np.zeros((8, 256))
    tot = 0.0
    ssq = [0.0, 0.0]
    col = 0
    sb = 0
    while col < block_size:
        sbs = min(8, block_size - col)
        increment = [0.0] * 8
        subtot = 0.0
        for j in range(sbs):
            dxx = dvals[col + j]
            increment[j] = subtot - dxx
            subtot += dxx
            ssq[1 if case_cols[col + j] else 0] += dxx * dxx
        tot += subtot
        for j in range(sbs, 8):
            increment[j] = subtot
        row = psbuf[sb]
        dxx = subtot
        row[0] = dxx
        ulii = 0
        while ulii < 255:
            ulii += 1
            dxx += increment[(ulii & -ulii).bit_length() - 1]
            row[ulii] = dxx
        col += sbs
        sb += 1
    ssq_io[0] += ssq[0]
    ssq_io[1] += ssq[1]
    return tot, psbuf


def run_ibs_test(ds: Dataset, cfg, log: RunLogger) -> None:
    from .distance import _pair_counts

    perm_ct = (cfg.ibs_test if cfg.ibs_test else 100000) + 1
    si = ds.si
    pc = next(iter(si.phenos.values()), None)
    if pc is None or pc.kind != "cc":
        raise ValueError(
            "--ibs-test and --groupdist calculations require a "
            "case/control phenotype.")
    auto = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    vmask = ds.variant_mask & auto
    n_excl = int((ds.variant_mask & ~auto).sum())
    if n_excl:
        log.log(
            f"Excluding {n_excl} variant"
            f"{'s' if n_excl != 1 else ''} on non-autosomes from "
            "distance matrix calc.")
    idist, _nsnp, scale, marker_ct, inc = _pair_counts(
        ds, vmask, True, cfg.nonfounders)
    dist = idist * scale
    hmr = 0.5 / marker_ct

    nraw = ds.raw_sample_ct
    nm_mask = (pc.nonmiss & ds.sample_mask)[:nraw]
    case_mask = nm_mask & (pc.data[:nraw] == 1)
    # collapsed (included-sample) order
    nm_c = nm_mask[inc]
    case_c = case_mask[inc]
    nm_pos = np.flatnonzero(nm_c)          # collapsed idx per nm idx
    n_nm = nm_pos.size
    case_nm = case_c[nm_pos]
    case_ct = int(case_nm.sum())
    ctrl_ct = n_nm - case_ct
    if ctrl_ct < 2:
        log.log("Warning: Skipping --ibs-test due to too few controls "
                "(minimum 2).")
        return
    if case_ct < 2:
        log.log("Warning: Skipping --ibs-test due to too few cases "
                "(minimum 2).")
        return

    master = master_sfmt(cfg)
    perms = np.zeros((perm_ct, n_nm), bool)
    perms[0] = case_nm
    for p in range(1, perm_ct):
        perms[p] = generate_cc_perm(n_nm, case_ct, master)

    # IBS submatrix over nm samples, nm-index order
    sub = 1.0 - dist[np.ix_(nm_pos, nm_pos)] * hmr

    res0 = np.zeros(perm_ct)      # ctrl_ctrl sums per perm
    res1 = np.zeros(perm_ct)      # ctrl_case sums per perm
    dist_tot = 0.0
    ssq = [0.0, 0.0, 0.0]
    permsT = perms.T.copy()       # [n_nm, perm_ct]
    for row in range(1, n_nm):
        row_case = bool(case_nm[row])
        rowbits = permsT[row]     # bool per perm
        col = 0
        while col < row:
            bs = min(64, row - col)
            off = 1 if row_case else 0
            st = [0.0, 0.0]
            block_tot, psbuf = _fill_psbuf(
                sub[row, col:col + bs], case_nm[col:col + bs], st)
            ssq[off] += st[0]
            ssq[off + 1] += st[1]
            dist_tot += block_tot
            sub_ct = (bs + 7) // 8
            cols = perms[:, col:col + bs]    # [perm_ct, bs]
            dxx = None
            for k in range(sub_ct):
                byts = np.zeros(perm_ct, np.int64)
                w = min(8, bs - 8 * k)
                for b in range(w):
                    byts |= cols[:, 8 * k + b].astype(np.int64) << b
                v = psbuf[k][byts]
                dxx = v if dxx is None else dxx + v
            ctrlrows = ~rowbits
            res0[ctrlrows] += dxx[ctrlrows]
            res1[ctrlrows] += block_tot - dxx[ctrlrows]
            res1[rowbits] += dxx[rowbits]
            col += bs

    ctrl_ctrl_ct = (ctrl_ct * (ctrl_ct - 1)) / 2
    ctrl_case_ct = ctrl_ct * case_ct
    case_case_ct = (case_ct * (case_ct - 1)) / 2
    ctrl_ctrl_ssq, ctrl_case_ssq, case_case_ssq = ssq
    ctrl_ctrl_tot = res0[0]
    ctrl_case_tot = res1[0]
    case_case_tot = dist_tot - ctrl_ctrl_tot - ctrl_case_tot
    tot_mean = dist_tot / (ctrl_ctrl_ct + ctrl_case_ct + case_case_ct)
    ingroups_mean = (ctrl_ctrl_tot + case_case_tot) \
        / (ctrl_ctrl_ct + case_case_ct)
    ctrl_ctrl_mean = ctrl_ctrl_tot / ctrl_ctrl_ct
    ctrl_case_mean = ctrl_case_tot / ctrl_case_ct
    case_case_mean = case_case_tot / case_case_ct
    ctrl_ctrl_var = ctrl_ctrl_ssq - ctrl_ctrl_tot * ctrl_ctrl_mean
    ctrl_case_var = ctrl_case_ssq - ctrl_case_tot * ctrl_case_mean
    case_case_var = case_case_ssq - case_case_tot * case_case_mean
    total_ssq = ctrl_ctrl_var + ctrl_case_var + case_case_var
    between_ssq = (ctrl_case_ct * (ctrl_case_mean - tot_mean)
                   * (ctrl_case_mean - tot_mean)
                   + (ctrl_ctrl_ct + case_case_ct)
                   * (ingroups_mean - tot_mean)
                   * (ingroups_mean - tot_mean))
    d_cc_ll = case_case_tot - ctrl_ctrl_tot
    d_cc_lc = case_case_tot - ctrl_case_tot
    d_ll_lc = ctrl_ctrl_tot - ctrl_case_tot
    pt = [0] * 6
    for p in range(1, perm_ct):
        ll1 = res0[p]
        lc1 = res1[p]
        cc1 = dist_tot - ll1 - lc1
        pt[0] += 1 if lc1 < ctrl_case_tot else 0
        pt[1] += 1 if cc1 - ll1 < d_cc_ll else 0
        pt[2] += 1 if cc1 < case_case_tot else 0
        pt[3] += 1 if ll1 < ctrl_ctrl_tot else 0
        pt[4] += 1 if cc1 - lc1 < d_cc_lc else 0
        pt[5] += 1 if ll1 - lc1 < d_ll_lc else 0

    import math

    pcr = 1.0 / perm_ct
    log.log("--ibs-test results:")
    log.log(f"  Between-group IBS (mean, SD)   = {ctrl_case_mean:g}, "
            f"{math.sqrt(ctrl_case_var / (ctrl_case_ct - 1)):g}")
    log.log(f"  In-group (case) IBS (mean, SD) = {case_case_mean:g}, "
            f"{math.sqrt(case_case_var / (case_case_ct - 1)):g}")
    log.log(f"  In-group (ctrl) IBS (mean, SD) = {ctrl_ctrl_mean:g}, "
            f"{math.sqrt(ctrl_ctrl_var / (ctrl_ctrl_ct - 1)):g}")
    log.log(f"  Approximate proportion of variance between group = "
            f"{between_ssq / total_ssq:g}")
    if not log.silent:
        # stdout-only in the reference (fputs, not LOGPRINTF)
        print("  IBS group-difference empirical p-values:")
    log.log(f"     T1: Case/control less similar                p = "
            f"{pt[0] * pcr:g}")
    log.log(f"     T2: Case/control more similar                p = "
            f"{(perm_ct - pt[0]) * pcr:g}\n")
    log.log(f"     T3: Case/case less similar than ctrl/ctrl    p = "
            f"{pt[1] * pcr:g}")
    log.log(f"     T4: Case/case more similar than ctrl/ctrl    p = "
            f"{(perm_ct - pt[1]) * pcr:g}\n")
    log.log(f"     T5: Case/case less similar                   p = "
            f"{pt[2] * pcr:g}")
    log.log(f"     T6: Case/case more similar                   p = "
            f"{(perm_ct - pt[2]) * pcr:g}\n")
    log.log(f"     T7: Control/control less similar             p = "
            f"{pt[3] * pcr:g}")
    log.log(f"     T8: Control/control more similar             p = "
            f"{(perm_ct - pt[3]) * pcr:g}\n")
    log.log(f"     T9: Case/case less similar than case/ctrl    p = "
            f"{pt[4] * pcr:g}")
    log.log(f"    T10: Case/case more similar than case/ctrl    p = "
            f"{(perm_ct - pt[4]) * pcr:g}\n")
    log.log(f"    T11: Ctrl/ctrl less similar than case/ctrl    p = "
            f"{pt[5] * pcr:g}")
    log.log(f"    T12: Ctrl/ctrl more similar than case/ctrl    p = "
            f"{(perm_ct - pt[5]) * pcr:g}")

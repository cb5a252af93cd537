"""--groupdist: case/control distance group comparison with delete-d
jackknife.

Behavior reference: groupdist_calc / groupdist_jack / pick_d /
pick_d_small / small_remap (1.9/plink_calc.c:1743-2005,2935-3135),
set_default_jackknife_d (:1998), destructive_get_dmedian
(plink_common.c:5021).  Distances are the calc_distance
weighted-missing values.  Log output is identical to 1.9 for a fixed
--seed (per-thread jackknife iteration split replicated).
"""

from __future__ import annotations

import math

import numpy as np

from ..dataset import Dataset
from ..stats.perm19 import master_sfmt
from ..stats.sfmt import sfmt_thread_array
from ..utils.logging import RunLogger


def _pick_d(ct, dd, sfmt):
    """pick_d: rejection-sampled distinct draws (1.9/plink_calc.c:1809);
    rejects urand < 2^32 % ct, then urand % ct."""
    ukk = (1 << 32) % ct
    chosen = np.zeros(ct, bool)
    for _ in range(dd):
        while True:
            while True:
                ujj = sfmt.genrand_uint32()
                if ujj >= ukk:
                    break
            ujj %= ct
            if not chosen[ujj]:
                break
        chosen[ujj] = True
    return np.flatnonzero(chosen)          # ascending, = pick_d_small


def _dmedian(pool):
    n = pool.size
    if not n:
        return 0.0
    s = np.sort(pool)
    if n % 2:
        return float(s[n // 2])
    return (float(s[n // 2 - 1]) + float(s[n // 2])) * 0.5


def run_regress_distance(ds: Dataset, cfg, log: RunLogger) -> None:
    """--regress-distance: regress genomic distance on average pair
    phenotype (both directions) with delete-d jackknife s.e.

    Behavior reference: regress_distance / regress_jack /
    regress_jack_thread (1.9/plink_calc.c:2015-2175),
    print_pheno_stdev (:1985)."""
    from .distance import _pair_counts

    iters, dd = cfg.regress_distance
    si = ds.si
    pc = next(iter(si.phenos.values()), None)
    nraw = ds.raw_sample_ct
    inc_mask = ds.sample_mask[:nraw]
    if pc is None or not bool(pc.nonmiss[:nraw][inc_mask].all()):
        raise ValueError(
            "--regress-distance requires phenotype data for all "
            "samples.  (--prune should help.)")
    auto = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    vmask = ds.variant_mask & auto
    n_excl = int((ds.variant_mask & ~auto).sum())
    if n_excl:
        log.log(
            f"Excluding {n_excl} variant"
            f"{'s' if n_excl != 1 else ''} on non-autosomes from "
            "distance matrix calc.")
    idist, _nsnp, scale, _mct, inc = _pair_counts(
        ds, vmask, True, cfg.nonfounders)
    dist = idist * scale
    if pc.kind == "cc":
        # pheno_d for a cc pheno: 1.9 uses the 1/2 coding as doubles
        pheno = np.where(pc.data[:nraw][inc] == 1, 2.0, 1.0)
    else:
        pheno = pc.data[:nraw][inc].astype(np.float64)
    n = inc.size
    tx = txx = 0.0
    for v in pheno:
        tx += float(v)
        txx += float(v) * float(v)
    log.log(f"Phenotype stdev: "
            f"{math.sqrt((txx - tx * tx / n) / (n - 1)):g}")

    # global + per-row partial sums, reference pair order
    precomp = np.zeros((n, 5))
    xy = x = y = xx = yy = 0.0
    for i in range(1, n):
        dzz = float(pheno[i])
        row = precomp[i]
        for j in range(i):
            dxx = (dzz + float(pheno[j])) * 0.5
            dyy = float(dist[i, j])
            dww = dxx * dyy
            dvv = dxx * dxx
            duu = dyy * dyy
            xy += dww
            row[0] += dww
            precomp[j, 0] += dww
            x += dxx
            row[1] += dxx
            precomp[j, 1] += dxx
            y += dyy
            row[2] += dyy
            precomp[j, 2] += dyy
            xx += dvv
            row[3] += dvv
            precomp[j, 3] += dvv
            yy += duu
            row[4] += duu
            precomp[j, 4] += duu
    npairs = float(n * (n - 1) // 2)
    log.log("Regression slope (y = genomic distance, x = avg "
            "phenotype): "
            f"{(xy - x * y / npairs) / (xx - x * x / npairs):g}")
    log.log("Regression slope (y = avg phenotype, x = genomic "
            "distance): "
            f"{(xy - x * y / npairs) / (yy - y * y / npairs):g}")

    thread_ct = cfg.threads or 1
    jack_iters = (iters + thread_ct - 1) // thread_ct
    if not dd:
        dd = int(math.pow(n, 0.600000000001))
        log.log(f"Setting d={dd} for jackknife.")
    master = master_sfmt(cfg)
    sfmts = sfmt_thread_array(master, thread_ct)
    tots = np.zeros(4)
    for tidx in range(thread_ct):
        sf = sfmts[tidx]
        s1 = s1q = s2 = s2q = 0.0
        for _ in range(jack_iters):
            sel = _pick_d(n, dd, sf)
            nxy = nx = ny = nxx = nyy = 0.0
            for s in sel:
                p = precomp[int(s)]
                nxy += p[0]
                nx += p[1]
                ny += p[2]
                nxx += p[3]
                nyy += p[4]
            for ii in range(1, dd):
                j = int(sel[ii])
                pj = float(pheno[j])
                for kk in range(ii):
                    k = int(sel[kk])
                    dxx = (pj + float(pheno[k])) * 0.5
                    dyy = float(dist[j, k])
                    nxy -= dxx * dyy
                    nx -= dxx
                    ny -= dyy
                    nxx -= dxx * dxx
                    nyy -= dyy * dyy
            rem = float(n - dd)
            denom_n = rem * (rem - 1.0) * 0.5
            ry = y - ny
            ret2 = ((xy - nxy) - ry * (x - nx) / denom_n) \
                / ((yy - nyy) - ry * ry / denom_n)
            rx = x - nx
            ret1 = ((xy - nxy) - rx * (y - ny) / denom_n) \
                / ((xx - nxx) - rx * rx / denom_n)
            s1 += ret1
            s1q += ret1 * ret1
            s2 += ret2
            s2q += ret2 * ret2
        if tidx == 0:
            tots[:] = (s1, s1q, s2, s2q)
        else:
            tots[0] += s1
            tots[1] += s1q
            tots[2] += s2
            tots[3] += s2q
    riters = jack_iters * thread_ct
    semul = (n - dd) / float(dd)
    log.log(f"Jackknife s.e.: "
            f"{math.sqrt(semul * (tots[1] - tots[0] * tots[0] / riters) / (riters - 1)):g}")
    log.log(f"Jackknife s.e. (y = avg phenotype): "
            f"{math.sqrt(semul * (tots[3] - tots[2] * tots[2] / riters) / (riters - 1)):g}")


def run_groupdist(ds: Dataset, cfg, log: RunLogger) -> None:
    from .distance import _pair_counts

    iters, dd = cfg.groupdist
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
    idist, _nsnp, scale, _marker_ct, inc = _pair_counts(
        ds, vmask, True, cfg.nonfounders)
    dist = idist * scale

    nraw = ds.raw_sample_ct
    nm_mask = (pc.nonmiss & ds.sample_mask)[:nraw]
    case_mask = nm_mask & (pc.data[:nraw] == 1)
    nm_c = nm_mask[inc]          # over collapsed samples
    case_c = case_mask[inc]
    n_coll = inc.size
    nm_pos = np.flatnonzero(nm_c)
    case_ct = int(case_c.sum())
    ctrl_ct = nm_pos.size - case_ct
    if ctrl_ct < 2:
        log.log("Warning: Skipping --groupdist due to too few "
                "controls (minimum 2).")
        return
    if case_ct < 2:
        log.log("Warning: Skipping --groupdist due to too few cases "
                "(minimum 2).")
        return
    if not dd:
        dd = int(math.pow(case_ct + ctrl_ct, 0.600000000001))
        log.log(f"Setting d={dd} for jackknife.")

    # pools + sequential totals, reference order (row-major pairs)
    tot_aa = tot_au = tot_uu = 0.0
    ssq_aa = ssq_au = ssq_uu = 0.0
    aa_pool, au_pool, uu_pool = [], [], []
    nm_list = [int(x) for x in nm_pos]
    case_l = case_c
    for i in nm_list:
        for j in nm_list:
            if j >= i:
                break
            dxx = float(dist[i, j])
            if case_l[i]:
                if case_l[j]:
                    aa_pool.append(dxx)
                    tot_aa += dxx
                    ssq_aa += dxx * dxx
                else:
                    au_pool.append(dxx)
                    tot_au += dxx
                    ssq_au += dxx * dxx
            elif case_l[j]:
                au_pool.append(dxx)
                tot_au += dxx
                ssq_au += dxx * dxx
            else:
                uu_pool.append(dxx)
                tot_uu += dxx
                ssq_uu += dxx * dxx
    uu_med = _dmedian(np.array(uu_pool))
    au_med = _dmedian(np.array(au_pool))
    aa_med = _dmedian(np.array(aa_pool))
    log.log("Case/control distance analysis:")
    dww = (case_ct * (case_ct - 1)) / 2
    aa_mean = tot_aa / dww
    aa_sd = math.sqrt((ssq_aa / dww - aa_mean * aa_mean) / (dww - 1.0))
    dww = float(case_ct * ctrl_ct)
    au_mean = tot_au / dww
    au_sd = math.sqrt((ssq_au / dww - au_mean * au_mean) / (dww - 1.0))
    dww = (ctrl_ct * (ctrl_ct - 1)) / 2
    uu_mean = tot_uu / dww
    uu_sd = math.sqrt((ssq_uu / dww - uu_mean * uu_mean) / (dww - 1.0))
    log.log(f"  Mean (sd), median dists between 2x affected     : "
            f"{aa_mean:g} ({aa_sd:g}), {aa_med:g}")
    log.log(f"  Mean (sd), median dists between aff. and unaff. : "
            f"{au_mean:g} ({au_sd:g}), {au_med:g}")
    log.log(f"  Mean (sd), median dists between 2x unaffected   : "
            f"{uu_mean:g} ({uu_sd:g}), {uu_med:g}\n")
    if 2 * dd >= case_ct + ctrl_ct:
        log.log("Delete-d jackknife skipped because d is too large.")
        return

    # precomp[i] = [uu, au, aa] partial sums, collapsed-sample indexed
    precomp = np.zeros((n_coll, 3))
    for i in nm_list:
        dyy = 0.0
        dzz = 0.0
        is_case = 1 if case_l[i] else 0
        for j in nm_list:
            if j >= i:
                break
            dxx = float(dist[i, j])
            if case_l[j]:
                precomp[j, is_case + 1] += dxx
                dzz += dxx
            else:
                precomp[j, is_case] += dxx
                dyy += dxx
        precomp[i, is_case] += dyy
        precomp[i, is_case + 1] += dzz

    thread_ct = cfg.threads or 1
    master = master_sfmt(cfg)
    sfmts = sfmt_thread_array(master, thread_ct)
    jack_iters = (iters + thread_ct - 1) // thread_ct
    nm_ct = case_ct + ctrl_ct
    needs_remap = nm_ct < n_coll
    nm_pos_arr = nm_pos
    results = np.zeros(9)
    for tidx in range(thread_ct):
        sf = sfmts[tidx]
        res = [0.0] * 9
        for _ in range(jack_iters):
            picks = _pick_d(nm_ct, dd, sf)
            sel = nm_pos_arr[picks] if needs_remap else picks
            neg_uu = neg_au = neg_aa = 0.0
            for s in sel:
                p = precomp[int(s)]
                neg_uu += p[0]
                neg_au += p[1]
                neg_aa += p[2]
            neg_a = neg_u = 0
            for ii in range(sel.size):
                i = int(sel[ii])
                if case_l[i]:
                    neg_a += 1
                    for jj in range(ii):
                        j = int(sel[jj])
                        if case_l[j]:
                            neg_aa -= dist[i, j]
                        else:
                            neg_au -= dist[i, j]
                else:
                    neg_u += 1
                    for jj in range(ii):
                        j = int(sel[jj])
                        if case_l[j]:
                            neg_au -= dist[i, j]
                        else:
                            neg_uu -= dist[i, j]
            r0 = (tot_aa - neg_aa) / float(
                ((case_ct - neg_a) * (case_ct - neg_a - 1)) // 2)
            r1 = (tot_au - neg_au) / float(
                (case_ct - neg_a) * (ctrl_ct - neg_u))
            r2 = (tot_uu - neg_uu) / float(
                ((ctrl_ct - neg_u) * (ctrl_ct - neg_u - 1)) // 2)
            res[0] += r0
            res[1] += r1
            res[2] += r2
            res[3] += r0 * r0
            res[4] += r1 * r1
            res[5] += r2 * r2
            res[6] += r0 * r1
            res[7] += r0 * r2
            res[8] += r1 * r2
        if tidx == 0:
            results[:] = res
        else:
            for k in range(9):
                results[k] += res[k]
    dxx = 1.0 / float(jack_iters * thread_ct)
    results *= dxx
    se_mult = (nm_ct - dd) / float(dd)
    d1 = results[0] - results[1]
    log.log(f"  AA mean - AU mean avg difference (s.e.): {d1:g} "
            f"({math.sqrt(se_mult * (results[3] + results[4] - 2 * results[6] - d1 * d1)):g})")
    d2 = results[0] - results[2]
    log.log(f"  AA mean - UU mean avg difference (s.e.): {d2:g} "
            f"({math.sqrt(se_mult * (results[3] + results[5] - 2 * results[7] - d2 * d2)):g})")
    d3 = results[1] - results[2]
    log.log(f"  AU mean - UU mean avg difference (s.e.): {d3:g} "
            f"({math.sqrt(se_mult * (results[4] + results[5] - 2 * results[8] - d3 * d3)):g})")

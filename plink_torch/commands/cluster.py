"""--cluster / --neighbour / --mds-plot: PLINK 1.9 IBS-based clustering,
outlier detection, and multidimensional scaling.

Behavior reference: calc_cluster_neighbor (1.9/plink_calc.c:8258-9290),
cluster_main / cluster_group_avg_main + heap helpers
(1.9/plink_cluster.c:1973-2654), write_cluster_solution (:2732-2918),
mds_plot / mds_plot_eigendecomp (:2920-3525).

- Pairwise IBS similarity = 1 - (2*IBS0 + IBS1) / (2 * joint-nonmissing),
  over autosomal markers; 'missing' mode uses the IBM (identity-by-missing)
  matrix 1 - (miss_i + miss_j - 2*jointmiss)/M instead.  Both come from the
  same counters as KING (kernel K7, ops/pairwise.py `king_gram`, one
  launch per lower sample tile) — exact integer counts, so the f64 ratios
  match the reference bit-for-bit.
- Complete-linkage agglomeration processes pairs most-similar-first from a
  stable sort (ties keep triangle order, matching glibc mergesort qsort);
  group-avg mode is a faithful port of the reference's binary heap.
- Constraints: --K, --mc, --mcc, --cc, --ibm, --ppc (PPC test from the
  same ppc-gap-thinned informative-pair scan as --genome).
- --mds-plot: classical MDS of the squared (1-IBS) matrix, double-centered
  * -0.5; default algorithm takes the SVD (dgesdd in the reference), the
  'eigendecomp' modifier the top-k eigenpairs (dsyevr).  C1 corresponds to
  the largest eigenvalue in both.
"""

from __future__ import annotations

import math

import numpy as np

from ..dataset import Dataset
from ..ops.planes import _unpack_np
from ..utils.fmt import dtoa_g, dtoa_g_wxp4
from ..utils.logging import RunLogger
from .distance import _pair_counts
from .genome import _ppc_skip_index, ppc_counts


def _fw(s: str, w: int) -> str:
    return s.rjust(w) if len(s) < w else s


def _ltqnorm(p: float) -> float:
    """Lower-tail inverse normal CDF (Acklam's rational approximation, as
    used by the reference's ltqnorm; plink_stats.c)."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                  * q + c[5])
                 / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = p - 0.5
    r = q * q
    return ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
             * r + a[5]) * q
            / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
               * r + 1))


def _tri(small: int, large: int) -> int:
    return (large * (large - 1)) // 2 + small


def _ppc_fail_matrix(ds: Dataset, vmask, inc, min_ppc: float, ppc_gap: int):
    """PPC-test failure matrix via the same thinned informative-pair scan
    as --genome (calc_cluster_neighbor :8440-8464)."""
    vidx = np.flatnonzero(vmask)
    pk = ds.all_packed()
    codes = _unpack_np(pk[vidx])[:, : ds.raw_sample_ct][:, inc]
    pos = ds.vi.pos[vidx]
    chrom = ds.vi.chrom[vidx]
    skip = _ppc_skip_index(pos, chrom, ppc_gap)
    min_zx = _ltqnorm(min_ppc) * math.sqrt(0.2222222)
    x, y = ppc_counts(codes, skip)
    tot = x + y
    with np.errstate(divide="ignore", invalid="ignore"):
        dxx1 = 1.0 / tot
        fail = (tot > 0) & ((x * dxx1 - 0.666666) / np.sqrt(dxx1) < min_zx)
    np.fill_diagonal(fail, False)
    return fail


def _heap_down(pos, hs, hv, vc, ci):
    cur_val = hv[pos]
    cur_c = vc[pos]
    child = pos * 2
    while child < hs:
        tv = hv[child]
        if hv[child + 1] > tv:
            child += 1
            tv = hv[child]
        if cur_val >= tv:
            break
        tc = vc[child]
        hv[pos] = tv
        vc[pos] = tc
        ci[_tri(tc & 65535, tc >> 16)] = pos
        pos = child
        child *= 2
    hv[pos] = cur_val
    vc[pos] = cur_c
    ci[_tri(cur_c & 65535, cur_c >> 16)] = pos


def _heap_up_then_down(orig, hs, hv, vc, ci):
    pos = orig
    cur_val = hv[orig]
    cur_c = vc[orig]
    parent = orig // 2
    while parent:
        tv = hv[parent]
        if cur_val < tv:
            break
        tc = vc[parent]
        hv[pos] = tv
        vc[pos] = tc
        ci[_tri(tc & 65535, tc >> 16)] = pos
        pos = parent
        parent //= 2
    if pos != orig:
        hv[pos] = cur_val
        vc[pos] = cur_c
        ci[_tri(cur_c & 65535, cur_c >> 16)] = pos
    _heap_down(pos, hs, hv, vc, ci)


def _heap_remove(pos, hs_box, hv, vc, ci):
    hs = hs_box[0] - 1
    last_val = hv[hs]
    last_c = vc[pos]
    ci[_tri(last_c & 65535, last_c >> 16)] = 0
    last_c = vc[hs]
    hv[hs] = 0.0
    hv[pos] = last_val
    vc[pos] = last_c
    ci[_tri(last_c & 65535, last_c >> 16)] = pos
    hs_box[0] = hs
    _heap_up_then_down(pos, hs, hv, vc, ci)


def _heap_merge_two(ca, cm, dsa, dsm, dsr, hs_box, hv, vc, ci):
    hp = ci[ca]
    cur = dsa * hv[hp]
    _heap_remove(hp, hs_box, hv, vc, ci)
    hp = ci[cm]
    hv[hp] = (dsm * hv[hp] + cur) * dsr
    _heap_up_then_down(hp, hs_box[0], hv, vc, ci)


def _heap_merge_two_cc(ca, cm, dsa, dsm, dsr, hs_box, hv, vc, ci):
    hp = ci[ca]
    hp2 = ci[cm]
    cur = (dsa * hv[hp] + dsm * hv[hp2]) * dsr
    if hp >= hs_box[0]:
        if hp2 >= hs_box[0]:
            tc = vc[hp2]
            hp2 = hs_box[0]
            hs_box[0] += 1
            vc[hp2] = tc
            ci[_tri(tc & 65535, tc >> 16)] = hp2
    elif hp2 >= hs_box[0]:
        tc = vc[hp2]
        hp2 = hp
        vc[hp] = tc
        ci[_tri(tc & 65535, tc >> 16)] = hp
    else:
        _heap_remove(hp, hs_box, hv, vc, ci)
    hv[hp2] = cur
    _heap_up_then_down(hp2, hs_box[0], hv, vc, ci)


class _ClusterParams:
    def __init__(self, cfg, n, case_ct, ctrl_ct):
        mods = [m.lower() for m in (cfg.cluster or ())]
        known = {"cc", "group-avg", "missing", "only2", "old-tiebreaks"}
        for m in mods:
            if m not in known:
                raise ValueError(f"Invalid --cluster parameter '{m}'.")
        self.cc = "cc" in mods
        self.group_avg = "group-avg" in mods
        self.missing = "missing" in mods
        self.only2 = "only2" in mods
        self.old_tiebreaks = "old-tiebreaks" in mods
        if self.group_avg and self.old_tiebreaks:
            raise ValueError(
                "--cluster 'group-avg' and 'old-tiebreaks' cannot be used "
                "together."
            )
        self.min_ct = cfg.cluster_k or 1
        self.max_size = cfg.cluster_mc if cfg.cluster_mc else 0xFFFFFFFF
        if cfg.cluster_mcc:
            self.max_cases, self.max_ctrls = cfg.cluster_mcc
        else:
            self.max_cases = self.max_ctrls = 0xFFFFFFFF
        self.ppc = cfg.cluster_ppc or 0.0
        self.min_ibm = cfg.cluster_ibm or 0.0
        self.report_pheno = self.cc or self.max_ctrls != 0xFFFFFFFF


def _merge_loop(C, vals_sorted, pairs_sorted, prevented, cp, sizes,
                case_cts, case_ct, ctrl_ct, sample_ct, ties):
    """Port of cluster_main (plink_cluster.c:1973-2294): non-group-avg
    complete-linkage merge loop on the presorted most-similar-first list."""
    remap = list(range(C))
    merge_seq = []
    max_merge = C - cp.min_ct
    size_restr = cp.max_size < sample_ct
    case_restr = case_ct is not None and cp.max_cases < case_ct
    ctrl_restr = ctrl_ct is not None and cp.max_ctrls < ctrl_ct
    sccr = size_restr or case_restr or ctrl_restr
    list_size = len(pairs_sorted)
    cluster_index = {}
    for pos, code in enumerate(pairs_sorted):
        cluster_index[_tri(code & 65535, code >> 16)] = pos
    entries = list(pairs_sorted)
    case_ctrl_only = 0
    if cp.cc:
        for c in range(C):
            u = case_cts[c]
            if (not u) or u == sizes[c]:
                case_ctrl_only += 1
    si = 0
    # tie-group end pointer (old-tiebreaks): entries [si, tie_end) share a
    # value with entries[si]
    if cp.old_tiebreaks:
        tie_end = 0
    else:
        tie_end = list_size

    merge_ct = 0
    while merge_ct < max_merge:
        # find next merge
        found = False
        while True:
            if si == tie_end:
                if si == list_size:
                    return merge_seq, remap
                t = si
                while t < list_size - 1 and ties[t]:
                    t += 1
                tie_end = t + 1
            uii = entries[si]
            si += 1
            if uii == 0xFFFFFFFF:
                continue
            large = remap[uii >> 16]
            small = remap[uii & 65535]
            if case_ctrl_only > 1:
                u = case_cts[small] + case_cts[large]
                if (small == large or not u
                        or u == sizes[small] + sizes[large]):
                    continue
                if large < small:
                    small, large = large, small
                if prevented[_tri(small, large)]:
                    continue
            else:
                if large < small:
                    small, large = large, small
                if small == large or prevented[_tri(small, large)]:
                    continue
            if cp.old_tiebreaks and si != tie_end:
                # prefer the lexicographically smallest merged pair among
                # the remaining tied entries
                best = None
                for s2 in range(si, tie_end):
                    uj = entries[s2]
                    if uj == 0xFFFFFFFF:
                        continue
                    t2 = remap[uj >> 16]
                    t1 = remap[uj & 65535]
                    if case_ctrl_only > 1:
                        if t1 == t2:
                            entries[s2] = 0xFFFFFFFF
                            continue
                        u = case_cts[t1] + case_cts[t2]
                        if not u or u == sizes[t1] + sizes[t2]:
                            continue
                        if t2 < t1:
                            t1, t2 = t2, t1
                        if prevented[_tri(t1, t2)]:
                            entries[s2] = 0xFFFFFFFF
                            continue
                    else:
                        if t2 < t1:
                            t1, t2 = t2, t1
                        if t1 == t2 or prevented[_tri(t1, t2)]:
                            entries[s2] = 0xFFFFFFFF
                            continue
                    if t1 < small or (t1 == small and t2 < large):
                        small, large = t1, t2
                        best = s2
                if best is not None:
                    entries[best] = uii
                    t2 = remap[uii >> 16]
                    t1 = remap[uii & 65535]
                    if t2 < t1:
                        t1, t2 = t2, t1
                    cluster_index[_tri(t1, t2)] = best
            found = True
            break
        if not found:
            break
        if case_ctrl_only > 1:
            u = case_cts[small]
            if (not u) or u == sizes[small]:
                case_ctrl_only -= 1
            u = case_cts[large]
            if (not u) or u == sizes[large]:
                case_ctrl_only -= 1
        merge_seq.append((small, large))
        remap[large] = small
        for u in range(large + 1, C):
            if remap[u] == large:
                remap[u] = small
        if sizes is not None:
            cur_size = sizes[small] + sizes[large]
            sizes[small] = cur_size
            if case_cts is not None:
                cur_cases = case_cts[small] + case_cts[large]
                case_cts[small] = cur_cases
                cur_ctrls = cur_size - cur_cases
                cur_cases = cp.max_cases - cur_cases
                cur_ctrls = cp.max_ctrls - cur_ctrls
            cur_size = cp.max_size - cur_size
        t1 = (large * (large - 1)) // 2
        t2 = (small * (small - 1)) // 2

        def _upd(other, coord_large, coord_small):
            blocked = prevented[coord_large]
            if sccr and not blocked:
                if size_restr and sizes[other] > cur_size:
                    blocked = True
                elif case_restr and case_cts[other] > cur_cases:
                    blocked = True
                elif (ctrl_restr
                      and sizes[other] - case_cts[other] > cur_ctrls):
                    blocked = True
            if blocked:
                prevented[coord_small] = True
            else:
                pj = cluster_index[coord_large]
                pk = cluster_index[coord_small]
                if pj < pk:
                    entries[pj] = 0xFFFFFFFF
                else:
                    entries[pk] = 0xFFFFFFFF
                    cluster_index[coord_small] = pj

        for u in range(small):
            if remap[u] == u and not prevented[t2 + u]:
                _upd(u, t1 + u, t2 + u)
        for u in range(small + 1, large):
            if remap[u] == u and not prevented[_tri(small, u)]:
                _upd(u, t1 + u, _tri(small, u))
        for u in range(large + 1, C):
            if remap[u] == u and not prevented[_tri(small, u)]:
                _upd(u, _tri(large, u), _tri(small, u))
        merge_ct += 1
    return merge_seq, remap


def _merge_loop_group_avg(C, vals_sorted, pairs_sorted, prevented, cp,
                          sizes, case_cts, case_ct, ctrl_ct, sample_ct):
    """Port of cluster_group_avg_main (plink_cluster.c:2406-2654)."""
    remap = list(range(C))
    merge_seq = []
    max_merge = C - cp.min_ct
    size_restr = cp.max_size < sample_ct
    case_restr = case_ct is not None and cp.max_cases < case_ct
    ctrl_restr = ctrl_ct is not None and cp.max_ctrls < ctrl_ct
    sccr = size_restr or case_restr or ctrl_restr
    n_list = len(pairs_sorted)
    # 1-indexed heap; initial sorted-descending array is a valid max-heap
    hv = [0.0] * (n_list + 2)
    vc = [0] * (n_list + 2)
    for i in range(n_list):
        hv[i + 1] = vals_sorted[i]
        vc[i + 1] = pairs_sorted[i]
    ci = {}
    for i in range(n_list):
        code = pairs_sorted[i]
        ci[_tri(code & 65535, code >> 16)] = i + 1
    hs_box = [n_list + 1]
    top_index = n_list  # saved-slot cursor for the cc variant
    cluster_cc = 0
    case_ctrl_only = 0
    if cp.cc:
        for c in range(C):
            u = case_cts[c]
            if (not u) or u == sizes[c]:
                case_ctrl_only += 1
    if case_ctrl_only > 1:
        cluster_cc = 1
    merge_ct = 0
    while merge_ct < max_merge:
        while True:
            if hs_box[0] == 1:
                return merge_seq, remap
            uii = vc[1]
            if case_ctrl_only > 1:
                ds1 = hv[1]
            _heap_remove(1, hs_box, hv, vc, ci)
            large = remap[uii >> 16]
            small = remap[uii & 65535]
            if large < small:
                small, large = large, small
            if small == large or prevented[_tri(small, large)]:
                continue
            if case_ctrl_only > 1:
                u = case_cts[small] + case_cts[large]
                if (not u) or u == sizes[small] + sizes[large]:
                    hv[top_index] = ds1
                    vc[top_index] = uii
                    ci[_tri(small, large)] = top_index
                    top_index -= 1
                    continue
            break
        merge_seq.append((small, large))
        remap[large] = small
        for u in range(large + 1, C):
            if remap[u] == large:
                remap[u] = small
        cur_size = sizes[small]
        dsize1 = float(cur_size)
        u = sizes[large]
        dsize2 = float(u)
        cur_size += u
        sizes[small] = cur_size
        dsr = 1.0 / cur_size
        if case_cts is not None:
            cur_cases = case_cts[small] + case_cts[large]
            case_cts[small] = cur_cases
            cur_ctrls = cur_size - cur_cases
            cur_cases = cp.max_cases - cur_cases
            cur_ctrls = cp.max_ctrls - cur_ctrls
        if size_restr:
            cur_size = cp.max_size - cur_size
        t1 = (large * (large - 1)) // 2
        t2 = (small * (small - 1)) // 2
        merge_fn = _heap_merge_two_cc if cluster_cc else _heap_merge_two

        def _upd(other, coord_large, coord_small):
            blocked = prevented[coord_large]
            if sccr and not blocked:
                if size_restr and sizes[other] > cur_size:
                    blocked = True
                elif case_restr and case_cts[other] > cur_cases:
                    blocked = True
                elif (ctrl_restr
                      and sizes[other] - case_cts[other] > cur_ctrls):
                    blocked = True
            if blocked:
                prevented[coord_small] = True
            else:
                merge_fn(coord_large, coord_small, dsize2, dsize1, dsr,
                         hs_box, hv, vc, ci)

        for u in range(small):
            if remap[u] == u and not prevented[t2 + u]:
                _upd(u, t1 + u, t2 + u)
        for u in range(small + 1, large):
            if remap[u] == u and not prevented[_tri(small, u)]:
                _upd(u, t1 + u, _tri(small, u))
        for u in range(large + 1, C):
            if remap[u] == u and not prevented[_tri(small, u)]:
                _upd(u, _tri(large, u), _tri(small, u))
        merge_ct += 1
    return merge_seq, remap


def _write_solution(out, fid, iid, remap, merge_seq, cp, pheno_case, log):
    """Port of write_cluster_solution (plink_cluster.c:2732-2918)."""
    C = len(remap)
    merge_ct = len(merge_seq)
    survivors = [c for c in range(C) if remap[c] == c]
    sol_of = {c: k for k, c in enumerate(survivors)}
    with open(out + ".cluster2", "w") as f:
        for s in range(C):
            f.write(f"{fid[s]} {iid[s]}\t{sol_of[remap[s]]}\n")
    if cp.only2:
        log.log(f"Cluster solution written to {out}.cluster2 .")
        return
    small = [m[0] for m in merge_seq]
    large = [m[1] for m in merge_seq]

    # merge-tree preorder DFS matching write_cluster1's manual recursion:
    # children of a cluster are the clusters it absorbed, in merge order
    children: dict[int, list[int]] = {}
    for m in range(merge_ct):
        children.setdefault(small[m], []).append(large[m])
    with open(out + ".cluster1", "w") as f:
        for c in survivors:
            f.write(f"SOL-{sol_of[c]}\t")
            stack = [c]
            while stack:
                cl = stack.pop()
                f.write(" " + fid[cl] + "_" + iid[cl])
                if cp.report_pheno and pheno_case is not None:
                    f.write("(2)" if pheno_case[cl] else "(1)")
                stack.extend(reversed(children.get(cl, ())))
            f.write("\n")

    suffix = ".cluster3.missing" if cp.missing else ".cluster3"
    # column s = compacted cluster id after merges 0..s applied, where ids
    # are renumbered by dropping absorbed clusters with smaller index
    cur = list(range(C))
    cols = np.zeros((merge_ct, C), np.int64)
    absorbed_sorted = []
    import bisect

    for s in range(merge_ct):
        sm, lg = merge_seq[s]
        for i in range(C):
            if cur[i] == lg:
                cur[i] = sm
        bisect.insort(absorbed_sorted, lg)
        for i in range(C):
            cols[s, i] = cur[i] - bisect.bisect_left(absorbed_sorted, cur[i])
    with open(out + suffix, "w") as f:
        for i in range(C):
            f.write(f"{fid[i]} {iid[i]}\t{i} ")
            for s in range(merge_ct):
                f.write(f"{cols[s, i]} ")
            for _ in range(merge_ct + 1, C):
                f.write("0 ")
            f.write("\n")
        f.write("\n")
    log.log(
        f"Cluster solution written to {out}.cluster1 , {out}.cluster2 , "
        f"and {out}{suffix} ."
    )


def _write_mds(out, fid, iid, sol, ibs, dim_ct, eigendecomp, dump_eigvals,
               by_cluster, final_ct, log):
    """Port of mds_plot / mds_plot_eigendecomp (plink_cluster.c:2920-3525)."""
    n = ibs.shape[0]
    if by_cluster:
        # cluster-averaged matrix over final clusters, replicating the
        # reference's dead else-branch (plink_cluster.c:2973-2980 — both
        # conditions are clidx2<clidx1): a sample pair j<i contributes only
        # when cluster(j)<cluster(i); the divisor is still the full size
        # product, so dropped pairs deflate the average
        m = final_ct
        rc = np.asarray(sol)
        cnt = np.bincount(rc, minlength=m).astype(np.int64)
        sums = np.zeros((m, m))
        ju, iu_ = np.triu_indices(n, 1)
        sel = rc[iu_] > rc[ju]
        np.add.at(sums, (rc[iu_][sel], rc[ju][sel]), ibs[ju[sel], iu_[sel]])
        with np.errstate(divide="ignore", invalid="ignore"):
            sums /= cnt[:, None] * cnt[None, :]
        mat = sums + sums.T
        np.fill_diagonal(mat, 0.0)
        ulii = m
    else:
        mat = ibs
        ulii = n
    d = 1.0 - mat
    d2 = d * d
    np.fill_diagonal(d2, 0.0)
    col_means = d2.mean(axis=0)
    grand = col_means.mean()
    b = -0.5 * (d2 - col_means[None, :] - col_means[:, None] + grand)
    dim_ct = min(dim_ct, ulii)
    if eigendecomp:
        # replicate mds_plot_eigendecomp's quirk: the centering loop starts
        # at row 1, so element [0,0] is left at 0.0 (plink_cluster.c:3350);
        # dsyevr (range='I', top dim_ct) on the same triangle bits
        from scipy.linalg.lapack import dsyevr

        b = np.asfortranarray(b)
        b[0, 0] = 0.0
        w, z, m_, _isuppz, info = dsyevr(
            b, compute_v=1, range="I", lower=0,
            il=ulii + 1 - dim_ct, iu=ulii, abstol=-1.0)
        if info != 0:
            raise RuntimeError(f"dsyevr failed (info={info})")
        # ascending from LAPACK; C1 = largest (written via reversed *--dptr)
        eigvals = w[:dim_ct][::-1].copy()
        vecs = z[:, :dim_ct][:, ::-1].copy()
    else:
        u, s, _vt = np.linalg.svd(b)
        eigvals = s[:dim_ct]
        vecs = u[:, :dim_ct]
    sqrt_ev = np.sqrt(np.maximum(eigvals, 0.0))
    coords = vecs * sqrt_ev[None, :]

    # calc_plink_maxfid widths (plink_misc.c:1771): 4, or len+2 when len>4
    mf = max(len(x) for x in fid)
    mi = max(len(x) for x in iid)
    maxfid = 4 if mf <= 4 else mf + 2
    maxiid = 4 if mi <= 4 else mi + 2
    with open(out + ".mds", "w") as f:
        f.write(_fw("FID", maxfid) + " " + _fw("IID", maxiid) + "    SOL ")
        for k in range(dim_ct):
            f.write(("C" + str(k + 1)).rjust(12) + " ")
        f.write("\n")
        for i in range(n):
            f.write(_fw(fid[i], maxfid) + " " + _fw(iid[i], maxiid) + " ")
            f.write(str(sol[i]).rjust(6) + " ")
            row = coords[sol[i]] if by_cluster else coords[i]
            for k in range(dim_ct):
                s_ = dtoa_g(float(row[k])) + " "
                if len(s_) < 13:
                    s_ = " " * (13 - len(s_)) + s_
                f.write(s_)
            f.write("\n")
    if dump_eigvals:
        with open(out + ".mds.eigvals", "w") as f:
            for k in range(dim_ct):
                f.write(dtoa_g(float(sqrt_ev[k] * sqrt_ev[k])) + "\n")
        log.log(
            f"MDS solution written to {out}.mds (eigenvalues in "
            f"{out}.mds.eigvals )."
        )
    else:
        log.log(f"MDS solution written to {out}.mds .")


def run_cluster(ds: Dataset, cfg, log: RunLogger) -> None:
    do_cluster = cfg.cluster is not None
    do_neighbor = cfg.neighbour is not None

    auto = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    vmask = ds.variant_mask & auto
    if not vmask.any():
        raise ValueError("--cluster: no autosomal variants remaining.")
    marker_ct = int(vmask.sum())

    inc = np.flatnonzero(ds.sample_mask)
    n = len(inc)
    si = ds.si
    fid = [str(si.fid[i]) for i in inc]
    iid = [str(si.iid[i]) for i in inc]

    pheno_case = None
    case_ct = ctrl_ct = None
    for _nm, pc in si.phenos.items():
        if pc.kind == "cc":
            pheno_case = [bool(pc.nonmiss[i] and pc.data[i] == 1)
                          for i in inc]
            case_ct = sum(pheno_case)
            ctrl_ct = n - case_ct
            break

    cp = _ClusterParams(cfg, n, case_ct, ctrl_ct) if do_cluster else None
    if cp is None:

        class _NoCluster:
            ppc = cfg.cluster_ppc or 0.0
            missing = False
            min_ibm = 0.0

        cp = _NoCluster()

    # integer pair stats over the masked markers, from K7's counters: idist
    # (allele-difference counts), nsnp (joint nonmissing), nm (per-sample
    # nonmissing)
    idist, nsnp, _, _, _ = _pair_counts(ds, vmask, False, cfg.nonfounders)
    nm = np.diag(nsnp).copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        ibs = 1.0 - idist.astype(np.float64) / (2 * nsnp)
    ibs[~np.isfinite(ibs)] = 0.0
    np.fill_diagonal(ibs, 0.0)

    ppc_fail = None
    ppc_fail_counts = None
    if cp.ppc != 0.0:
        ppc_gap = getattr(cfg, "ppc_gap", None) or 500000
        ppc_fail = _ppc_fail_matrix(ds, vmask, inc, cp.ppc, ppc_gap)
        ppc_fail_counts = ppc_fail.sum(axis=1).astype(np.int64)

    if do_neighbor:
        n1, n2 = cfg.neighbour
        if n2 >= n:
            raise ValueError(
                "Second --neighbour parameter too large (>= population "
                "size)."
            )
        _write_nearest(cfg.out, fid, iid, ibs, n1, n2, n, ppc_fail_counts,
                       log)
        if not do_cluster:
            return

    # clustering distance basis
    if cp.missing:
        miss = marker_ct - nm
        dbl = miss[:, None] + miss[None, :] - marker_ct + nsnp
        dxx1 = 1.0 / marker_ct
        cmat = 1.0 - (miss[:, None] + miss[None, :] - 2 * dbl) * dxx1
        np.fill_diagonal(cmat, 0.0)
        _write_ibm_matrix(cfg.out, cmat, n, log)
    else:
        cmat = ibs

    C = n
    T = (C * (C - 1)) // 2
    prevented = np.zeros(T, bool)
    if ppc_fail is not None:
        iu = np.triu_indices(n, 1)
        tcoords = (iu[1] * (iu[1] - 1)) // 2 + iu[0]
        prevented[tcoords[ppc_fail[iu]]] = True
    if cp.min_ibm != 0.0 and not cp.missing:
        miss = marker_ct - nm
        dbl = miss[:, None] + miss[None, :] - marker_ct + nsnp
        dxx1 = 1.0 / marker_ct
        ibm = 1.0 - (miss[:, None] + miss[None, :] - 2 * dbl) * dxx1
        iu = np.triu_indices(n, 1)
        tcoords = (iu[1] * (iu[1] - 1)) // 2 + iu[0]
        prevented[tcoords[ibm[iu] < cp.min_ibm]] = True
    elif cp.min_ibm != 0.0 and cp.missing:
        iu = np.triu_indices(n, 1)
        tcoords = (iu[1] * (iu[1] - 1)) // 2 + iu[0]
        prevented[tcoords[cmat[iu] < cp.min_ibm]] = True

    if n > 65536:
        raise ValueError("--cluster cannot handle >65536 initial clusters.")

    # sorted most-similar-first list of allowed pairs, triangle order for
    # ties (stable sort = glibc mergesort qsort behavior)
    iu_small, iu_large = np.triu_indices(n, 1)
    tcoords = (iu_large * (iu_large - 1)) // 2 + iu_small
    order = np.argsort(tcoords, kind="stable")  # triangle order
    ts = tcoords[order]
    keep = ~prevented[ts]
    vals_tri = cmat[(iu_small[order][keep], iu_large[order][keep])]
    codes_tri = (iu_large[order][keep].astype(np.int64) << 16) | \
        iu_small[order][keep]
    sort_idx = np.argsort(-vals_tri, kind="stable")
    vals_sorted = vals_tri[sort_idx]
    pairs_sorted = codes_tri[sort_idx].tolist()
    if len(pairs_sorted) == 0:
        raise ValueError("No cluster merges possible.")
    ties = np.zeros(len(vals_sorted), bool)
    if cp.old_tiebreaks and len(vals_sorted) > 1:
        ties[:-1] = vals_sorted[:-1] == vals_sorted[1:]

    sizes = [1] * C
    case_cts = None
    if pheno_case is not None and (
            cp.cc or cp.max_cases != 0xFFFFFFFF
            or cp.max_ctrls != 0xFFFFFFFF):
        case_cts = [1 if pheno_case[i] else 0 for i in range(C)]

    if cp.group_avg:
        merge_seq, remap = _merge_loop_group_avg(
            C, vals_sorted.tolist(), pairs_sorted, prevented, cp, sizes,
            case_cts, case_ct, ctrl_ct, n)
    else:
        merge_seq, remap = _merge_loop(
            C, vals_sorted.tolist(), pairs_sorted, prevented, cp, sizes,
            case_cts, case_ct, ctrl_ct, n, ties)
    log.log(f"Clustering... done ({len(merge_seq)} merges).")

    _write_solution(cfg.out, fid, iid, remap, merge_seq, cp, pheno_case, log)

    if cfg.mds_plot is not None:
        dim_ct, by_cluster, eigendecomp, eigvals = cfg.mds_plot
        survivors = [c for c in range(C) if remap[c] == c]
        sol_of = {c: k for k, c in enumerate(survivors)}
        sol = [sol_of[remap[s]] for s in range(C)]
        _write_mds(cfg.out, fid, iid, sol, ibs, dim_ct, eigendecomp,
                   eigvals, by_cluster, len(survivors), log)


def _write_nearest(out, fid, iid, ibs, n1, n2, n, ppc_fail_counts, log):
    """Port of the .nearest writer (plink_calc.c:8572-8673)."""
    # per-sample descending IBS; nonincr_doublearr_leq_stride's binary
    # search places a new value below existing equal entries, and candidates
    # arrive in ascending other-index order (triangle row scan,
    # plink_calc.c:8512-8518), so ties keep ascending-index order = stable
    qvals = np.zeros((n2, n))
    qidx = np.zeros((n2, n), np.int64)
    for s in range(n):
        others = np.concatenate([np.arange(s), np.arange(s + 1, n)])
        v = ibs[s, others]
        o = np.argsort(-v, kind="stable")[:n2]
        qvals[:, s] = v[o]
        qidx[:, s] = others[o]
    ct_recip = 1.0 / n
    means = np.zeros(n2 - n1 + 1)
    stdev_recips = np.zeros(n2 - n1 + 1)
    for r in range(n1 - 1, n2):
        ssum = 0.0
        ssq = 0.0
        for s in range(n):
            dyy = qvals[r, s]
            ssum += dyy
            ssq += dyy * dyy
        mean = ssum * ct_recip
        means[r + 1 - n1] = mean
        stdev_recips[r + 1 - n1] = math.sqrt((n - 1) / (ssq - ssum * mean))
    with open(out + ".nearest", "w") as f:
        f.write("         FID          IID     NN      MIN_DST            Z"
                "         FID2         IID2 ")
        if ppc_fail_counts is not None:
            f.write("   PROP_DIFF ")
        f.write("\n")
        dxx1 = 1.0 / (n - 1)
        for s in range(n):
            pre = _fw(fid[s], 12) + " " + _fw(iid[s], 12) + " "
            for k in range(n2 - n1 + 1):
                # reference quirk (plink_calc.c:8610-8646): the value/index
                # come from quantile row k (the k-th nearest), but the row is
                # labeled NN k+n1 and the Z uses row k+n1-1's mean/stdev
                x = qvals[k, s]
                z = (x - means[k]) * stdev_recips[k]
                j = qidx[k, s]
                line = (pre + str(k + n1).rjust(6) + " " + dtoa_g_wxp4(x, 12)
                        + " " + dtoa_g_wxp4(z, 12) + " " + _fw(fid[j], 12)
                        + " " + _fw(iid[j], 12) + " ")
                if ppc_fail_counts is not None:
                    line += dtoa_g_wxp4(ppc_fail_counts[s] * dxx1, 12) + " "
                f.write(line + "\n")
    log.log(f"--neighbour report written to {out}.nearest .")


def _write_ibm_matrix(out, ibm, n, log):
    """IBM matrix emit (plink_calc.c:8688-8806): full square, dtoa_g with
    trailing spaces, diagonal printed as '1'."""
    with open(out + ".mdist.missing", "w") as f:
        for i in range(n):
            parts = []
            for j in range(n):
                if i == j:
                    parts.append("1 ")
                else:
                    parts.append(dtoa_g(float(ibm[i, j])) + " ")
            f.write("".join(parts) + "\n")
    log.log(f"IBM matrix written to {out}.mdist.missing .")

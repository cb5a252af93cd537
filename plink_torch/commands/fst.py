"""--fst <categorical pheno> [method=hudson|wc]: population differentiation
(plink_tpu/commands/fst.py).

Behavior reference: FstReport / FstThread (2.0/plink2_misc.cc:11233, :11190;
the code cites scikit-allel's allel/stats/fst.py as the readable form):
- Hudson (default): per variant and pop pair,
    dxy   = 1 - sum_a ct1_a*ct2_a / (n1*n2)          (allele counts)
    within_k = (n_k*(n_k-1)/2 - same_k) / (n_k*(n_k-1))
    numer = dxy - within_1 - within_2,  denom = dxy
  skipped when n_diff == 0 or any term is nan; summary FST is the ratio of
  sums over autosomal variants.
- Weir-Cockerham (method=wc): the a/b/c variance components (:12010-12045).
Per-pop genotype counts come from kernel K1 (Dataset.counts, ops/counts.py
`masked_geno_counts`: one launch per three sample masks over the
device-resident matrix, or numpy on small panels), as plink_tpu's
multi-mask counting pass.

Output: <out>.fst.summary (#POP1 POP2 <METHOD>_FST); with
'report-variants', one <out>.<POP1>.<POP2>.fst.var per pair (#CHROM POS ID
OBS_CT <METHOD>_FST, computable rows only).

chrX (ref :11643-11710): a second Hudson-only pass over chrX writes
<out>.x.* files; male genotypes are haploid (one allele each, male hets
dropped as missing).  Weir-Cockerham skips the chrX pass like the
reference.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from ..dataset import Dataset
from ..io.compress import open_out
from ..utils.chrom import X_CODE
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import _provref_strs


_VCOL_SETS = ("chrom", "pos", "ref", "alt", "maybeprovref", "provref",
              "nobs", "nallele", "fstfrac", "fst")
_VCOL_DEFAULT = ("chrom", "pos", "maybeprovref", "nobs", "fst")


def run_fst(ds: Dataset, cfg, log: RunLogger) -> None:
    args = list(cfg.fst)
    if not args:
        raise ValueError("--fst requires a categorical phenotype name")
    pheno_name = args[0]
    method = "hudson"
    report_variants = False
    blocksize = 0
    zs = False
    scol_nobs = False
    vcols = set(_VCOL_DEFAULT)
    pair_mode = None  # None | ("base", id) | ("ids",) | ("file", path)
    pair_ids: list[str] = []
    i = 1
    while i < len(args):
        a = args[i]
        if a.startswith("method="):
            method = a.split("=", 1)[1].lower()
            if method not in ("hudson", "wc"):
                raise ValueError(f"--fst: unknown method '{method}'")
        elif a == "report-variants":
            report_variants = True
        elif a == "zs":
            zs = True
        elif a.startswith("blocksize="):
            blocksize = int(a.split("=", 1)[1])
        elif a.startswith("cols="):
            for tok in a.split("=", 1)[1].split(","):
                if tok == "nobs":
                    scol_nobs = True
                else:
                    raise ValueError(f"--fst cols= unknown set '{tok}'")
        elif a.startswith("vcols="):
            spec = a.split("=", 1)[1]
            if spec.startswith("+") or spec.startswith("-"):
                for tok in spec.replace("-", ",-").replace("+", ",+") \
                        .split(","):
                    if not tok:
                        continue
                    nm_ = tok[1:]
                    if nm_ not in _VCOL_SETS:
                        raise ValueError(
                            f"--fst vcols= unknown set '{nm_}'")
                    (vcols.discard if tok[0] == "-" else vcols.add)(nm_)
            else:
                vcols = set()
                for tok in spec.split(","):
                    if tok not in _VCOL_SETS:
                        raise ValueError(f"--fst vcols= unknown set '{tok}'")
                    vcols.add(tok)
        elif a.startswith("base="):
            pair_mode = ("base", a.split("=", 1)[1])
            pair_ids = list(args[i + 1:])
            i = len(args)
        elif a.startswith("ids="):
            pair_mode = ("ids",)
            pair_ids = [a.split("=", 1)[1]] + list(args[i + 1:])
            i = len(args)
        elif a.startswith("file="):
            pair_mode = ("file", a.split("=", 1)[1])
        else:
            raise ValueError(f"--fst: unrecognized modifier '{a}'")
        i += 1

    pc = ds.si.phenos.get(pheno_name)
    if pc is None:
        raise ValueError(f"--fst: phenotype '{pheno_name}' not found")
    if pc.kind == "cat":
        # category code 0 is the missing placeholder ('NONE')
        cats = [c for c in pc.categories[1:] if c]
        pop_names = sorted(cats)
        member = {
            name: (pc.data == (pc.categories.index(name))) & pc.nonmiss
            for name in pop_names
        }
    elif pc.kind == "cc":
        pop_names = ["CONTROL", "CASE"]
        member = {
            "CONTROL": (pc.data == 0) & pc.nonmiss,
            "CASE": (pc.data == 1) & pc.nonmiss,
        }
    else:
        raise ValueError("--fst: phenotype must be categorical or case/control")

    # base=/ids=/file= population-pair selection (ref FstReport pop_pairs
    # assembly; default = all pairs)
    if pair_mode is None:
        pair_list = list(itertools.combinations(range(len(pop_names)), 2))
    else:
        idx_of = {p: k for k, p in enumerate(pop_names)}

        def _pidx(nm_):
            if nm_ not in idx_of:
                raise ValueError(f"--fst: population '{nm_}' not found.")
            return idx_of[nm_]

        if pair_mode[0] == "base":
            b = _pidx(pair_mode[1])
            others = [_pidx(x) for x in pair_ids] if pair_ids else [
                k for k in range(len(pop_names)) if k != b]
            pair_list = [(min(b, o), max(b, o)) for o in others if o != b]
        elif pair_mode[0] == "ids":
            sel_ = [_pidx(x) for x in pair_ids]
            pair_list = list(itertools.combinations(sorted(set(sel_)), 2))
        else:
            pair_list = []
            with open(pair_mode[1]) as pf:
                for ln in pf:
                    t = ln.split()
                    if len(t) >= 2:
                        a_, b_ = _pidx(t[0]), _pidx(t[1])
                        pair_list.append((min(a_, b_), max(a_, b_)))
        seen_pairs = set()
        pair_list = [p for p in pair_list
                     if not (p in seen_pairs or seen_pairs.add(p))]

    masks = [member[p] & ds.sample_mask for p in pop_names]
    auto = ds.vi.chr_info.is_autosomal(ds.vi.chrom)
    isx = ds.vi.chrom == X_CODE
    male = ds.male_mask()
    P = len(pop_names)

    passes = [("", "Autosomal", auto)]
    if method == "hudson" and (ds.variant_mask & isx).any():
        passes.append((".x", "chrX", isx))

    x_needed = len(passes) > 1 and male.any()
    # per-pop genotype counts [P][M, 4]; for chrX, male/nonmale split
    count_masks = list(masks)
    if x_needed:
        count_masks = [m & ~male for m in masks] + [m & male for m in masks]
    raw_cts = [c.astype(np.float64) for c in ds.counts(count_masks)]

    for suffix, prefix, chr_sel in passes:
        vmask = ds.variant_mask & chr_sel
        if not vmask.any():
            continue
        sel = np.flatnonzero(vmask)
        is_x_pass = suffix == ".x"
        # per-pop (ref allele ct, alt allele ct, nonmissing sample ct)
        refs, alts, obss, cts = [], [], [], []
        for g in range(P):
            if x_needed:
                c_nm = raw_cts[g][sel]
                c_m = raw_cts[P + g][sel]
                c = c_nm + c_m
            else:
                c_nm = c = raw_cts[g][sel]
                c_m = np.zeros_like(c_nm)
            if is_x_pass:
                # males haploid; male hets are missing (ref :11062-11067)
                refs.append(2 * c_nm[:, 0] + c_nm[:, 1] + c_m[:, 0])
                alts.append(2 * c_nm[:, 2] + c_nm[:, 1] + c_m[:, 2])
                obss.append(
                    c_nm[:, 0] + c_nm[:, 1] + c_nm[:, 2]
                    + c_m[:, 0] + c_m[:, 2]
                )
            else:
                refs.append(2 * c[:, 0] + c[:, 1])
                alts.append(2 * c[:, 2] + c[:, 1])
                obss.append(c[:, 0] + c[:, 1] + c[:, 2])
            cts.append(c)
        rows = []
        for i1, i2 in pair_list:
            ref1, alt1, obs1 = refs[i1], alts[i1], obss[i1]
            ref2, alt2, obs2 = refs[i2], alts[i2], obss[i2]
            n1 = ref1 + alt1
            n2 = ref2 + alt2
            with np.errstate(divide="ignore", invalid="ignore"):
                if method == "hudson":
                    n_same = ref1 * ref2 + alt1 * alt2
                    n_pairs = n1 * n2
                    n_diff = n_pairs - n_same
                    within1 = _half_within(ref1, alt1, n1)
                    within2 = _half_within(ref2, alt2, n2)
                    denom = n_diff / n_pairs
                    numer = denom - within1 - within2
                    valid = (n_diff > 0) & np.isfinite(numer) & (denom != 0)
                else:
                    numer, denom, valid = _wc_components(cts[i1], cts[i2])
                if blocksize:
                    fst, se_, nobs_ = _fst_jackknife(
                        numer, denom, valid, blocksize)
                else:
                    fst = np.nansum(numer[valid]) / np.nansum(denom[valid])
                    se_, nobs_ = None, int(valid.sum())
            rows.append((pop_names[i1], pop_names[i2], fst, se_, nobs_))
            if report_variants:
                tag = "HUDSON_FST" if method == "hudson" else "WC_FST"
                vp = (
                    f"{cfg.out}{suffix}.{pop_names[i1]}.{pop_names[i2]}"
                    ".fst.var"
                )
                with np.errstate(divide="ignore", invalid="ignore"):
                    per_var = numer / denom
                obs = (obs1 + obs2).astype(np.int64)
                vi = ds.vi
                want_provref = "provref" in vcols
                prov_hdr, prov_fn = ("", lambda i: "")
                if want_provref or "maybeprovref" in vcols:
                    prov_hdr, prov_fn = _provref_strs(ds)
                    if want_provref and not prov_hdr:
                        prov_hdr = "\tPROVISIONAL_REF?"
                        prov_fn = lambda i: "\tY"
                f, vp = open_out(vp, zs)
                with f:
                    hdr = ""
                    if "chrom" in vcols:
                        hdr += "#CHROM\t"
                    if "pos" in vcols:
                        hdr += "POS\t"
                    hdr = (hdr or "#") + "ID"
                    if "ref" in vcols:
                        hdr += "\tREF"
                    if "alt" in vcols:
                        hdr += "\tALT"
                    hdr += prov_hdr
                    if "nobs" in vcols:
                        hdr += "\tOBS_CT"
                    if "nallele" in vcols:
                        hdr += "\tPOP1_ALLELE_CT\tPOP2_ALLELE_CT"
                    if "fstfrac" in vcols:
                        hdr += "\tFST_NUMER\tFST_DENOM"
                    if "fst" in vcols:
                        hdr += "\t" + tag
                    f.write(hdr + "\n")
                    # the reference prints every considered variant, rendering
                    # incomputable rows as nan (they are only excluded from
                    # the summary sums)
                    for k in range(len(sel)):
                        v = sel[k]
                        line = ""
                        if "chrom" in vcols:
                            line += f"{vi.chr_info.name(vi.chrom[v])}\t"
                        if "pos" in vcols:
                            line += f"{vi.pos[v]}\t"
                        line += str(vi.vid[v])
                        if "ref" in vcols:
                            line += f"\t{vi.ref[v]}"
                        if "alt" in vcols:
                            line += f"\t{vi.alt[v]}"
                        line += prov_fn(v)
                        if "nobs" in vcols:
                            line += f"\t{obs[k]}"
                        if "nallele" in vcols:
                            line += (f"\t{int(n1[k])}" f"\t{int(n2[k])}")
                        if "fstfrac" in vcols:
                            line += (f"\t{g6(numer[k])}\t{g6(denom[k])}"
                                     if valid[k] else "\tnan\tnan")
                        if "fst" in vcols:
                            line += ("\t" + g6(per_var[k])) if valid[k] \
                                else "\tnan"
                        f.write(line + "\n")

        if report_variants:
            npair = len(rows)
            log.log(
                f"{prefix} --fst: {npair} .fst.var file"
                f"{'s' if npair != 1 else ''} written."
            )
        path = cfg.out + suffix + ".fst.summary"
        tag = "HUDSON_FST" if method == "hudson" else "WC_FST"
        f, path = open_out(path, zs)
        with f:
            hdr = "#POP1\tPOP2\t"
            if scol_nobs:
                hdr += "OBS_CT\t"
            hdr += tag
            if blocksize:
                hdr += "\tSE"
            f.write(hdr + "\n")
            for a, b, v, se_, nobs_ in rows:
                line = f"{a}\t{b}\t"
                if scol_nobs:
                    line += f"{nobs_}\t"
                line += g6(v)
                if blocksize:
                    line += "\t" + g6(se_)
                f.write(line + "\n")
        log.log(f"{prefix} --fst: Summary written to {path} .")


def _fst_jackknife(numer, denom, valid, blocksize):
    """Weighted block jackknife over consecutive VALID variants (ref
    FstReport, 2.0/plink2_misc.cc:12190-12240; Busing et al. wjack):
    returns (theta_hat, se, nobs) with the reference's accumulation
    order (per-variant sequential adds into per-block sums, then a
    sequential sum of block sums).

    Known upstream divergence: when blocksize divides nobs exactly, the
    reference's summary loop (plink2_misc.cc:12209) iterates n_block+1
    times and reads a phantom out-of-bounds block, producing garbage SE;
    this implementation uses the mathematically-defined n_block blocks."""
    nv = numer[valid]
    dv = denom[valid]
    nobs = nv.size
    n_block = (nobs + blocksize - 1) // blocksize
    bn = np.zeros(n_block)
    bd = np.zeros(n_block)
    for b in range(n_block):
        sn = sd = 0.0
        for k in range(b * blocksize, min((b + 1) * blocksize, nobs)):
            sn += nv[k]
            sd += dv[k]
        bn[b] = sn
        bd[b] = sd
    num_sum = den_sum = 0.0
    for b in range(n_block):
        num_sum += bn[b]
        den_sum += bd[b]
    theta_hat = num_sum / den_sum
    if n_block < 2:
        return theta_hat, float("nan"), nobs
    last_size = nobs - (n_block - 1) * blocksize
    sizes = [blocksize] * (n_block - 1) + [last_size]
    nobs_d = float(nobs)
    theta_jack = 0.0
    for b in range(n_block):
        t_rm = (num_sum - bn[b]) / (den_sum - bd[b])
        theta_jack += (theta_hat - t_rm) + sizes[b] * t_rm / nobs_d
    main_sum = 0.0
    for b in range(n_block):
        hh = nobs_d / sizes[b]
        t_rm = (num_sum - bn[b]) / (den_sum - bd[b])
        tau = hh * theta_hat - (hh - 1.0) * t_rm
        d_ = tau - theta_jack
        main_sum += d_ * d_ / (hh - 1.0)
    return theta_hat, math.sqrt(main_sum / n_block), nobs


def _half_within(ref, alt, n):
    ssq = ref * ref + alt * alt
    n_pairs_x2 = n * (n - 1.0)
    n_same = (ssq - n) / 2.0
    n_diff = n_pairs_x2 / 2.0 - n_same
    return n_diff / n_pairs_x2


def _wc_components(c1, c2):
    """Weir-Cockerham a / (a+b+c) per variant (biallelic, REF allele term,
    ref :12010-12045)."""
    n1 = c1[:, 0] + c1[:, 1] + c1[:, 2]
    n2 = c2[:, 0] + c2[:, 1] + c2[:, 2]
    n_total = n1 + n2
    ref1 = 2 * c1[:, 0] + c1[:, 1]
    ref2 = 2 * c2[:, 0] + c2[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        n_total_recip = 1.0 / n_total
        n_bar = n_total / 2.0
        n_bar_m1_recip = 1.0 / (n_bar - 1.0)
        n_bar_div_n_c = n_bar / (
            n_total - (n1 * n1 + n2 * n2) * n_total_recip
        )
        p1 = ref1 / (2 * n1)
        p2 = ref2 / (2 * n2)
        p_bar = (ref1 + ref2) * 0.5 * n_total_recip
        s1 = p1 - p_bar
        s2 = p2 - p_bar
        s_squared = (n1 * s1 * s1 + n2 * s2 * s2) * n_total_recip * 2.0
        h_bar = (c1[:, 1] + c2[:, 1]) * n_total_recip
        pq = p_bar * (1.0 - p_bar)
        a = n_bar_div_n_c * (
            s_squared - (pq - 0.5 * s_squared - 0.25 * h_bar) * n_bar_m1_recip
        )
        b = n_bar * n_bar_m1_recip * (
            pq - 0.5 * s_squared - (0.5 - 0.5 * n_total_recip) * h_bar
        )
        c = h_bar * 0.5
        total_ref = ref1 + ref2
        # monomorphic-for-REF across both pops contributes nothing
        mono = (total_ref == 0) | (total_ref == 2 * n_total)
        a = np.where(mono, 0.0, a)
        b = np.where(mono, 0.0, b)
        c = np.where(mono, 0.0, c)
        numer = a
        denom = a + b + c
        valid = (denom != 0) & np.isfinite(numer)
    return numer, denom, valid

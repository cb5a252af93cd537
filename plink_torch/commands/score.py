"""--score / --score-list / --q-score-range: polygenic scoring.

Behavior reference: ScoreReport / CalcScoreThread
(2.0/plink2_matrix_calc.cc:6892, :6467) and the .sscore writer (:8440-8620):
- flag grammar: --score <file> [varid-col] [allele-col] [score-col]
  ['header' | 'header-read'] ['no-mean-imputation'] (1-based columns,
  defaults 1 2 3); --score-col-nums <range list> selects multiple
  coefficient columns (SCORE1.. names unless header-read);
- per-sample: ALLELE_CT = denom_base - missing alleles; with
  mean-imputation (default) missing genotypes contribute
  weight * 2 * named_allele_freq and SCORE_AVG divides by the full
  denom_base, with 'no-mean-imputation' by ALLELE_CT;
- --q-score-range <range file> <data file> [cols] ['header'] ['min']:
  range lines "NAME LO HI" (non-numeric bound lines silently skipped,
  :6977), data lines map variant IDs to values, one
  <out>.<range>.sscore per range restricted to variants with
  LO <= value <= HI;
- --score-list <file>: one score file per line, single .sscore with one
  score-column set per file and no ALLELE_CT/DOSAGE columns (:11511).

Sex-chromosome allele accounting (:8389) is not implemented, as in
plink_tpu (autosomal diploid assumed); multiallelic variants unsupported.

Port of plink_tpu/commands/score.py: a job's K score columns, its dosage sum
and its missing-allele count are one K21 launch over the device-resident
matrix (K + 2 weight sets); dosage-track variants are scored on the host in
f64, as plink_tpu does.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.counts import weighted_sample_sums
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs


def _ddosagetoa(val: float) -> str:
    """Dosage-sum renderer (ddosagetoa, 2.0/plink2_common.cc): 3-decimal
    precision with the reference's +16 rounding and trailing-zero drop."""
    v = int(round(val * 32768.0)) + 16
    whole = v // 32768
    rem = v % 32768
    if rem < 33:
        return str(whole)
    three = (125 * rem + 48) // 4096 - (1 if rem % 8192 == 4048 else 0)
    first, pair = divmod(three, 100)
    s = f"{whole}.{first}"
    if pair:
        s += f"{pair:02d}"
        if s[-1] == "0":
            s = s[:-1]
    return s


class ScoreMods:
    """Parsed --score modifiers (ref flag grammar: plink2_help.cc:1623)."""

    def __init__(self):
        self.header = False
        self.header_read = False
        self.no_meanimpute = False
        self.center = False
        self.vstd = False
        self.dominant = False
        self.recessive = False
        self.list_variants = False


def _parse_score_args(args: tuple):
    path = args[0]
    nums = []
    m = ScoreMods()
    for a in args[1:]:
        if a == "header":
            m.header = True
        elif a == "header-read":
            m.header = m.header_read = True
        elif a == "no-mean-imputation":
            m.no_meanimpute = True
        elif a == "center":
            m.center = True
        elif a == "variance-standardize":
            m.vstd = m.center = True
        elif a == "dominant":
            m.dominant = True
        elif a == "recessive":
            m.recessive = True
        elif a in ("list-variants", "list-variants-zs"):
            m.list_variants = True
        elif a.isdigit():
            nums.append(int(a))
        else:
            raise ValueError(f"--score: unrecognized modifier '{a}'")
    if (m.dominant or m.recessive) and m.center:
        raise ValueError(
            "--score 'dominant'/'recessive' cannot be used with "
            "'center'/'variance-standardize'.")
    if m.dominant and m.recessive:
        raise ValueError("--score 'dominant' and 'recessive' conflict.")
    while len(nums) < 3:
        nums.append([1, 2, 3][len(nums)])
    return path, nums[0], nums[1], nums[2], m


def _parse_col_nums(spec: str) -> list[int]:
    """--score-col-nums range list, e.g. '3-5,7' -> [3,4,5,7] (1-based)."""
    out: list[int] = []
    for part in spec.replace(" ", ",").split(","):
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-", 1)
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def _read_score_file(ds: Dataset, path, vcol, acol, scols, header, header_read):
    """Parse one score file -> (names, w [V,K], named_is_alt, in_score,
    missed_ct)."""
    with open(path) as f:
        lines = [l.split() for l in f.read().splitlines() if l.strip()]
    K = len(scols)
    names = [f"SCORE{k + 1}" for k in range(K)]
    if header_read and lines:
        names = [lines[0][c - 1] for c in scols]
    if header:
        lines = lines[1:]
    vid_to_idx = {str(v): i for i, v in enumerate(ds.vi.vid)}
    V = ds.raw_variant_ct
    w = np.zeros((V, K))
    named_is_alt = np.zeros(V, bool)
    in_score = np.zeros(V, bool)
    missed = 0
    for t in lines:
        vid, allele = t[vcol - 1], t[acol - 1]
        i = vid_to_idx.get(vid)
        if i is None or not ds.variant_mask[i]:
            missed += 1
            continue
        alt1 = str(ds.vi.alt[i]).split(",", 1)[0]
        if allele == alt1:
            named_is_alt[i] = True
        elif allele != str(ds.vi.ref[i]):
            missed += 1
            continue
        w[i] = [float(t[c - 1]) for c in scols]
        in_score[i] = True
    return names, w, named_is_alt, in_score, missed


def _slope_intercept(ds: Dataset, named_freq, named_is_alt, in_score, m):
    """Per-variant (slope, intercept) in named-dosage units.

    ref geno_slope/geno_intercept (plink2_matrix_calc.cc:8005-8035):
    default slope 1, intercept 0; 'variance-standardize' slope =
    1/sqrt(2f(1-f)) (0 with an error check when degenerate); 'center' (or
    vstd) intercept = -2f*slope.  Autosomal diploid scope."""
    V = len(named_freq)
    slope = np.ones(V)
    intercept = np.zeros(V)
    if not m.center:
        return slope, intercept
    if m.vstd:
        f = named_freq
        var = 2.0 * f * (1.0 - f)
        eps = 2.0 ** -44  # kSmallEpsilon
        degenerate = in_score & ~(var > eps)
        if degenerate.any():
            from .basic_reports import _group_counts

            cts = _group_counts(ds, False)["all"].astype(np.float64)
            hom_named = np.where(named_is_alt, cts[:, 2], cts[:, 0])
            bad = degenerate & ((cts[:, 1] + hom_named) > 0)
            if bad.any():
                vid = str(ds.vi.vid[int(np.flatnonzero(bad)[0])])
                raise ValueError(
                    f"--score[-list] variance-standardize failure for "
                    f"variant '{vid}': estimated allele frequency is zero "
                    "or NaN, but not all dosages are zero.")
        with np.errstate(divide="ignore", invalid="ignore"):
            slope = np.where(var > eps, 1.0 / np.sqrt(var), 0.0)
    intercept = -2.0 * named_freq * slope
    return slope, intercept


def _compute_scores(ds: Dataset, w, named_is_alt, in_score, named_freq,
                    m):
    """Returns (nallele [n], dosage_sum [n], avg [n, K]).

    Per-genotype contributions replicate the reference's lookup table
    (plink2_matrix_calc.cc:6746-6763): nonmissing named-dosage d maps to
    t(d)*slope + intercept with t = min(d,1) under 'dominant' /
    max(d-1,0) under 'recessive'; a mean-imputed missing genotype
    contributes (2 - domrec)*f*slope WITHOUT the intercept term, exactly
    as lookup_table[6] does."""
    no_meanimpute = m.no_meanimpute
    n = ds.raw_sample_ct
    K = w.shape[1]
    scored_ct = int(in_score.sum())
    denom_base = 2 * scored_ct
    score_sum = np.zeros((n, K))
    dosage_sum = np.zeros(n)
    miss_ct2 = np.zeros(n)
    in_score = in_score.copy()
    slope, intercept = _slope_intercept(ds, named_freq, named_is_alt,
                                        in_score, m)
    domrec = m.dominant or m.recessive

    def tdose(d):
        if m.dominant:
            return np.minimum(d, 1.0)
        if m.recessive:
            return np.maximum(d - 1.0, 0.0)
        return d

    miss_fac = (1.0 if domrec else 2.0)
    if ds.has_dosage:
        # dosage-track variants take the dense fused-dosage path
        vr = ds.reader.header.vrtypes
        for v in np.flatnonzero(in_score & ((vr & 0x60) != 0)):
            d = ds.dosage_row(int(v))
            nd = d if named_is_alt[v] else 2.0 - d
            fin = np.isfinite(nd)
            fill = 0.0 if no_meanimpute \
                else miss_fac * named_freq[v] * slope[v]
            contrib = np.where(fin, tdose(nd) * slope[v] + intercept[v],
                               fill)
            score_sum += np.outer(contrib, w[v])
            # NAMED_ALLELE_DOSAGE_SUM accumulates the domrec-TRANSFORMED
            # dosage (ref ddosage_incrs are post-lookup)
            dosage_sum += np.where(fin, tdose(nd), 0.0)
            miss_ct2 += 2.0 * (~fin)
            in_score[v] = False
    if in_score.any():
        V = len(in_score)
        sel = in_score.astype(np.float64)
        ia = named_is_alt
        # named dosage per 2-bit code, transformed
        d_by_code = [np.where(ia, 0.0, 2.0), np.ones(V), np.where(ia, 2.0, 0.0)]
        t_by_code = [tdose(d) * slope + intercept for d in d_by_code]
        t_mis = (0.0 if no_meanimpute else 1.0) * miss_fac * named_freq * slope
        # weight sets: the K score columns, the dosage sum, the missing count
        wts = np.zeros((V, 4, K + 2))
        for k in range(K):
            wv = w[:, k] * sel
            wts[:, :, k] = np.stack([t_by_code[0] * wv, t_by_code[1] * wv,
                                     t_by_code[2] * wv, t_mis * wv], axis=1)
        wts[:, 0, K] = tdose(np.where(ia, 0.0, 2.0)) * sel
        wts[:, 1, K] = tdose(np.ones(V)) * sel
        wts[:, 2, K] = tdose(np.where(ia, 2.0, 0.0)) * sel
        wts[:, 3, K + 1] = 2.0 * sel
        sums = weighted_sample_sums(ds.device_all_packed(), n, wts)
        score_sum += sums[:K].T
        dosage_sum += sums[K]
        miss_ct2 += sums[K + 1]
    nallele = denom_base - miss_ct2
    denom = nallele if no_meanimpute else np.full(n, float(denom_base))
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.where(denom[:, None] > 0, score_sum / denom[:, None], np.nan)
    return nallele, dosage_sum, avg


def _parse_qsr(ds: Dataset, cfg, log: RunLogger):
    """--q-score-range -> list of (range_name, member_mask [V])."""
    args = cfg.q_score_range
    range_path, data_path = args[0], args[1]
    nums = []
    header = False
    use_min = False
    for a in args[2:]:
        if a == "header":
            header = True
        elif a == "min":
            use_min = True
        elif a.isdigit():
            nums.append(int(a))
        else:
            raise ValueError(f"--q-score-range: invalid argument '{a}'")
    vcol = nums[0] if nums else 1
    dcol = nums[1] if len(nums) > 1 else vcol + 1

    ranges = []
    with open(range_path) as f:
        for ln in f:
            t = ln.split()
            if len(t) < 3:
                continue
            try:
                lo, hi = float(t[1]), float(t[2])
            except ValueError:
                continue  # documented: nonnumeric bound lines are ignored
            if lo > hi:
                raise ValueError(
                    "Upper bound < lower bound in --q-score-range range file."
                )
            ranges.append((t[0], lo, hi))
    if not ranges:
        raise ValueError("Empty --q-score-range range file.")

    vid_to_idx = {
        str(ds.vi.vid[i]): i for i in np.flatnonzero(ds.variant_mask)
    }
    vals: dict[int, float] = {}
    with open(data_path) as f:
        lines = f.read().splitlines()
    if header:
        lines = lines[1:]
    for ln in lines:
        t = ln.split()
        if not t:
            continue
        if len(t) < max(vcol, dcol):
            raise ValueError("Missing tokens in --q-score-range data file.")
        i = vid_to_idx.get(t[vcol - 1])
        if i is None:
            continue
        try:
            v = float(t[dcol - 1])
        except ValueError:
            continue  # NA tolerated
        if i in vals:
            if not use_min:
                raise ValueError(
                    f"Duplicate variant ID '{t[vcol - 1]}' in --q-score-range "
                    "data file."
                )
            if vals[i] <= v:
                continue
        vals[i] = v
    if not vals:
        raise ValueError("No valid entries in --q-score-range data file.")
    V = ds.raw_variant_ct
    jobs = []
    idxs = np.fromiter(vals.keys(), dtype=np.int64)
    vv = np.fromiter(vals.values(), dtype=np.float64)
    for name, lo, hi in ranges:
        mask = np.zeros(V, bool)
        mask[idxs[(vv >= lo) & (vv <= hi)]] = True
        jobs.append((name, mask))
    return jobs


def _write_sscore(ds: Dataset, path, score_names, avg, nallele, dosage_sum,
                  with_counts, log: RunLogger):
    inc = np.flatnonzero(ds.sample_mask)
    si = ds.si
    use_fid = si.has_fid and any(str(si.fid[i]) != "0" for i in inc)
    pheno_items = list(si.phenos.items())
    with open(path, "w") as f:
        hdr = "#FID\tIID" if use_fid else "#IID"
        for pname, _ in pheno_items:
            hdr += f"\t{pname}"
        if with_counts:
            hdr += "\tALLELE_CT\tNAMED_ALLELE_DOSAGE_SUM"
        for nm in score_names:
            hdr += f"\t{nm}_AVG"
        f.write(hdr + "\n")
        phen = [(pc.nonmiss.tolist(), pc.kind == "cc", pc.data.tolist())
                for _, pc in pheno_items]
        avg_l = avg.tolist()
        if with_counts:
            counts = list(zip(nallele.tolist(), dosage_sum.tolist()))
        for i in inc.tolist():
            idp = f"{si.fid[i]}\t{si.iid[i]}" if use_fid else str(si.iid[i])
            pvals = ""
            for nonmiss, cc, data in phen:
                if not nonmiss[i]:
                    pvals += "\tNA"
                elif cc:
                    pvals += f"\t{int(data[i]) + 1}"
                else:
                    pvals += f"\t{g6(data[i])}"
            row = idp + pvals
            if with_counts:
                row += f"\t{_ddosagetoa(counts[i][0])}\t{_ddosagetoa(counts[i][1])}"
            row += "".join(f"\t{g6(x)}" for x in avg_l[i])
            f.write(row + "\n")


def score_report(ds: Dataset, cfg, log: RunLogger) -> None:
    freqs = np.nan_to_num(alt_allele_freqs(ds, founders_only=True, dosage=True))

    if getattr(cfg, "score_list", None):
        path0, vcol, acol, scol, m = _parse_score_args(cfg.score_list)
        scols = (
            _parse_col_nums(cfg.score_col_nums) if cfg.score_col_nums else [scol]
        )
        with open(path0) as f:
            files = [l.strip() for l in f if l.strip()]
        all_names: list[str] = []
        all_avg = []
        for k0, path in enumerate(files):
            names, w, nia, ins, missed = _read_score_file(
                ds, path, vcol, acol, scols, m.header, m.header_read
            )
            if not m.header_read:
                names = [f"SCORE{len(all_names) + j + 1}" for j in range(len(names))]
            nf = np.where(nia, freqs, 1.0 - freqs)
            _, _, avg = _compute_scores(ds, w, nia, ins, nf, m)
            all_names.extend(names)
            all_avg.append(avg)
            log.log(
                f"--score-list file {k0 + 1}/{len(files)}: "
                f"{int(ins.sum())} variants processed."
            )
        out = cfg.out + ".sscore"
        _write_sscore(
            ds, out, all_names, np.concatenate(all_avg, axis=1), None, None,
            with_counts=False, log=log,
        )
        log.log(f"--score-list: Results written to {out} .")
        return

    path, vcol, acol, scol, m = _parse_score_args(cfg.score)
    scols = _parse_col_nums(cfg.score_col_nums) if cfg.score_col_nums else [scol]
    names, w, named_is_alt, in_score, missed = _read_score_file(
        ds, path, vcol, acol, scols, m.header, m.header_read
    )
    named_freq = np.where(named_is_alt, freqs, 1.0 - freqs)
    if m.list_variants:
        vpath = cfg.out + ".sscore.vars"
        with open(vpath, "w") as f:
            for i in np.flatnonzero(in_score):
                f.write(str(ds.vi.vid[i]) + "\n")
        log.log(f"--score: Variant list written to {vpath} .")

    jobs = [(None, None)]
    if getattr(cfg, "q_score_range", None):
        jobs = _parse_qsr(ds, cfg, log)
    for rname, rmask in jobs:
        ins = in_score if rmask is None else (in_score & rmask)
        nallele, dosage_sum, avg = _compute_scores(
            ds, w, named_is_alt, ins, named_freq, m
        )
        out = (
            cfg.out + ".sscore" if rname is None
            else f"{cfg.out}.{rname}.sscore"
        )
        _write_sscore(ds, out, names, avg, nallele, dosage_sum,
                      with_counts=True, log=log)
    if missed:
        log.log(f"Warning: --score: {missed} line(s) skipped (unmatched ID/allele).")
    if jobs[0][0] is None:
        log.log(f"--score: Results written to {cfg.out}.sscore .")
    else:
        log.log(
            f"--score + --q-score-range: Results written to "
            f"{cfg.out}.<range name>.sscore ."
        )

"""--check-sex / --impute-sex.

Port of plink_tpu/commands/check_sex.py.  Behavior reference:
CheckOrImputeSex (2.0/plink2_misc.cc; flag help):
- chrX inbreeding coefficient per sample (the --het F statistic restricted
  to polymorphic chrX variants, with chrX's half-allele male freq
  accounting feeding E(HET));
- chrY valid-call rate (het calls invalid);
- SNPSEX called when every specified threshold for that sex is satisfied;
  with no thresholds, min-male-xf=1 / max-female-yrate=0 defaults apply
  (with a warning, matching the reference).
Output <out>.sexcheck: #[FID\t]IID PEDSEX SNPSEX STATUS F YRATE (default
column set).  --impute-sex additionally overwrites SEX for called samples.

The four per-sample sums (chrX missing calls, het calls and the missing
calls' E(HET); valid chrY calls) are one K21 launch over the
device-resident matrix.
"""

from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..ops.counts import weighted_sample_sums
from ..utils.chrom import X_CODE, Y_CODE
from ..utils.fmt import g6
from ..utils.logging import RunLogger
from .basic_reports import alt_allele_freqs


_SEXCHECK_COLS = ("maybefid", "fid", "maybesid", "sid", "pedsex", "status",
                  "xf", "ycount", "yrate", "yobs")
_SEXCHECK_DEFAULT = {"maybefid", "maybesid", "pedsex", "status", "xf",
                     "yrate"}


def _parse_thresholds(args: tuple) -> tuple[dict, set]:
    th = {}
    cols = set(_SEXCHECK_DEFAULT)
    for a in args:
        if a.startswith("cols="):
            spec = a.split("=", 1)[1]
            if spec[:1] in "+-":
                for tok in spec.replace("-", ",-").replace("+", ",+") \
                        .split(","):
                    if not tok:
                        continue
                    if tok[1:] not in _SEXCHECK_COLS:
                        raise ValueError(
                            f"--check-sex cols= unknown set '{tok[1:]}'")
                    (cols.discard if tok[0] == "-" else cols.add)(tok[1:])
            else:
                cols = set()
                for tok in spec.split(","):
                    if tok not in _SEXCHECK_COLS:
                        raise ValueError(
                            f"--check-sex cols= unknown set '{tok}'")
                    cols.add(tok)
            continue
        if "=" in a:
            k, v = a.split("=", 1)
            if k in ("max-female-xf", "min-male-xf", "max-female-ycount",
                     "min-male-ycount", "max-female-yrate", "min-male-yrate",
                     "max-female-fadj", "min-male-fadj"):
                th[k.replace("fadj", "xf")] = float(v)
            else:
                raise ValueError(f"--check-sex: unknown modifier '{a}'")
        else:
            raise ValueError(f"--check-sex: unknown modifier '{a}'")
    return th, cols


def run_check_sex(ds: Dataset, cfg, log: RunLogger, impute: bool) -> None:
    th, cols = _parse_thresholds(cfg.check_sex if not impute else cfg.impute_sex)
    if not th:
        log.log(
            "Warning: --check-sex run with default thresholds (min-male-xf=1, "
            "max-female-yrate=0); inspect the xf/yrate distributions and rerun "
            "with data-derived thresholds."
        )
        th = {"min-male-xf": 1.0, "max-female-yrate": 0.0}
    use_x_male = "min-male-xf" in th
    use_x_female = "max-female-xf" in th
    use_y = any(k in th for k in (
        "max-female-ycount", "min-male-ycount", "max-female-yrate",
        "min-male-yrate",
    ))

    n = ds.raw_sample_ct
    freqs = alt_allele_freqs(ds, founders_only=True, dosage=True)
    with np.errstate(invalid="ignore"):
        ehet = np.nan_to_num(2.0 * freqs * (1.0 - freqs))
    x_sel = ds.variant_mask & (ds.vi.chrom == X_CODE) & (ehet >= 2.0 ** -35)
    y_sel = ds.variant_mask & (ds.vi.chrom == Y_CODE)
    x_ct = int((ds.variant_mask & (ds.vi.chrom == X_CODE)).sum())
    y_ct = int(y_sel.sum())

    total_sel = float(x_sel.sum())
    total_ehet = float(ehet[x_sel].sum())
    sx = x_sel.astype(np.float64)
    sy = y_sel.astype(np.float64)
    z = np.zeros_like(sx)
    # weights per plane (homref, het, homalt, missing); a valid chrY call
    # is nonmissing and non-het
    wts = np.stack([np.stack([z, z, z, sx], 1), np.stack([z, sx, z, z], 1),
                    np.stack([z, z, z, ehet * sx], 1),
                    np.stack([sy, z, sy, z], 1)], axis=2)
    miss_ct, ohet, miss_ehet, ycount = weighted_sample_sums(
        ds.device_all_packed(), n, wts)
    obs = total_sel - miss_ct
    esum = total_ehet - miss_ehet
    with np.errstate(divide="ignore", invalid="ignore"):
        o_hom = obs - ohet
        e_hom = obs - esum
        xf = np.where(obs - e_hom != 0, (o_hom - e_hom) / (obs - e_hom), np.nan)
        yrate = np.where(y_ct > 0, ycount / max(y_ct, 1), np.nan)

    # SNPSEX: male (1) when every male threshold given holds, female (2)
    # likewise, NA (0) when neither or both (a NaN F or YRATE fails its test)
    male_any = female_any = False
    male_ok = np.ones(n, bool)
    female_ok = np.ones(n, bool)
    with np.errstate(invalid="ignore"):
        for key, stat, ge in (("min-male-xf", xf, True), ("min-male-ycount", ycount, True),
                              ("min-male-yrate", yrate, True),
                              ("max-female-xf", xf, False),
                              ("max-female-ycount", ycount, False),
                              ("max-female-yrate", yrate, False)):
            if key not in th:
                continue
            ok = np.isfinite(stat) & (stat >= th[key] if ge else stat <= th[key])
            if ge:
                male_any, male_ok = True, male_ok & ok
            else:
                female_any, female_ok = True, female_ok & ok
    m = male_ok & male_any
    f = female_ok & female_any
    snpsex = np.where(m & ~f, 1, np.where(f & ~m, 2, 0)).astype(np.int8)

    si = ds.si
    inc = np.flatnonzero(ds.sample_mask)
    # column gating (ref 2.0/plink2_misc.cc:10664-10702): FID forced by
    # 'fid' or maybefid-with-informative-FIDs; x/y statistic columns only
    # when that chromosome was actually used
    use_fid = "fid" in cols or (
        "maybefid" in cols and si.has_fid
        and any(str(si.fid[i]) != "0" for i in inc))
    x_used = x_ct and (use_x_male or use_x_female)
    y_used = y_ct and use_y
    use_sid = "sid" in cols or ("maybesid" in cols and si.sid is not None)
    c_pedsex = "pedsex" in cols
    c_status = "status" in cols
    c_xf = bool(x_used) and "xf" in cols
    c_ycount = bool(y_used) and "ycount" in cols
    c_yrate = bool(y_used) and "yrate" in cols
    c_yobs = bool(y_used) and "yobs" in cols
    path = cfg.out + ".sexcheck"
    problems = 0
    with open(path, "w") as f:
        hdr = ("#FID\tIID" if use_fid else "#IID")
        if use_sid:
            hdr += "\tSID"
        if c_pedsex:
            hdr += "\tPEDSEX"
        hdr += "\tSNPSEX"
        if c_status:
            hdr += "\tSTATUS"
        if c_xf:
            hdr += "\tF"
        if c_ycount:
            hdr += "\tYCOUNT"
        if c_yrate:
            hdr += "\tYRATE"
        if c_yobs:
            hdr += "\tYOBS"
        f.write(hdr + "\n")
        sex_l, snp_l = si.sex.tolist(), snpsex.tolist()
        xf_l, yc_l, yr_l = xf.tolist(), ycount.tolist(), yrate.tolist()
        for i in inc.tolist():
            ped = sex_l[i]
            snp = snp_l[i]
            ok = snp != 0 and ped == snp
            if not ok:
                problems += 1
            row = f"{si.fid[i]}\t{si.iid[i]}" if use_fid else str(si.iid[i])
            if use_sid:
                row += "\t" + (str(si.sid[i]) if si.sid is not None else "0")
            if c_pedsex:
                row += f"\t{ped if ped else 'NA'}"
            row += f"\t{snp if snp else 'NA'}"
            if c_status:
                row += "\tOK" if ok else "\tPROBLEM"
            if c_xf:
                row += f"\t{g6(xf_l[i])}"
            if c_ycount:
                row += f"\t{int(yc_l[i])}"
            if c_yrate:
                row += f"\t{g6(yr_l[i])}"
            if c_yobs:
                row += f"\t{y_ct}"
            f.write(row + "\n")
    flag = "--impute-sex" if impute else "--check-sex"
    log.log(
        f"{flag}: {x_ct} chrX variants and {y_ct} variants scanned, "
        f"{problems} problems detected.\nReport written to {path} ."
    )
    if impute:
        # imputation REPLACES sex wholesale: uncalled samples become missing
        # (verified against the reference's --impute-sex .psam output)
        ds.si.sex[:] = snpsex
        ds.invalidate_counts()
        log.log(f"--impute-sex: {int((snpsex != 0).sum())} sexes imputed.")

"""--glm: logistic / Firth / logistic-hybrid on case/control phenotypes,
linear regression on quantitative ones.

Port of plink_tpu/commands/glm.py (run_glm, _glm_logistic,
_emit_logistic_rows, _glm_linear, _emit_linear_rows and their host
helpers).  Behaviour reference: GlmMain (2.0/plink2_glm.cc:2395),
GlmLogistic (2.0/plink2_glm_logistic.cc) with the glm.fit()-imitating IRLS
of LogisticRegressionD (:3590), and GlmLinear (2.0/plink2_glm_linear.cc).

- A1 = minor allele by default; 'omit-ref' makes A1 = ALT.
- Output <out>.<pheno>.glm.logistic[.hybrid] / .glm.firth with columns
  #CHROM POS ID REF ALT [PROVISIONAL_REF?] A1 OMITTED A1_FREQ [FIRTH?] TEST
  OBS_CT OR LOG(OR)_SE Z_STAT P ERRCODE, and <out>.<pheno>.glm.linear with
  ... TEST OBS_CT BETA SE T_STAT P ERRCODE.
- hybrid Firth fallback triggers: separation (A1 case dosage 0 or total,
  plink2_glm_logistic.cc:2224-2236) or logistic convergence failure.

The device passes are ops/glm.py: kernels K2-K4 (logistic; K3's
residualized design for cc-/firth-residualize, K2/K3's scaled design and
K14 for --xchr-model 1; K2/K3 with two genotype columns for genotypic and
hethom; K15/K16 for `interaction`, whose G x covariate columns carry a
covariate factor, and for any design too wide for K2/K3, at any width) and
K6 (the linear plane sums, solved per variant in f64 on the host for every
model and interaction design; run twice more with s- and s^2-scaled tables
under --xchr-model 1); the A1 choice counts with K1.  A fileset with
dosage tracks takes glm_dosage.py's route (K17 / K18 / K4).  Rows the f32
device fit cannot resolve to reference precision are refitted per variant
in f64 on the host, as in plink_tpu; on panels of at most 65,536 samples
every row of a joint (GENO_2DF) model is.  --condition / --condition-list add the
named variants' A1 dosages as leading covariates.

'aperm' / 'mperm=' run plink_tpu's permutation tests after the report
(glm_perm.py: K19 / K20 for the linear scan, K3 / K16 Firth fits per
permuted phenotype for case/control); local covariates (local-covar= /
local-psam= / local-pvar=) take glm_dosage.py's per-variant host route on
any fileset, as in plink_tpu; --adjust writes <report>.adjusted
(adjust.py) after each report.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from ..dataset import Dataset
from ..ops.pairwise import PackedDevice
from ..ops.planes import _unpack_np
from ..stats.distributions import f_logsf, t_logp_2sided, zstat_logp_2sided
from ..utils.chrom import X_CODE, Y_CODE
from ..utils.fmt import g6, logp_to_str
from ..utils.logging import RunLogger
from .basic_reports import _provref_strs, alt_allele_freqs


def _read_table(path: str):
    """Read a pheno/covar file: header (#FID IID ... | #IID ... | FID IID ...),
    returns (id_mode, ids, colnames, str values [n, k])."""
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    hdr = lines[0]
    toks = hdr.lstrip("#").split()
    if toks[0] == "FID":
        id_cols, id_mode = 2, "fid_iid"
    elif toks[0] == "IID":
        id_cols, id_mode = 1, "iid"
    else:
        raise ValueError(f"{path}: header must start with #FID/#IID")
    colnames = toks[id_cols:]
    ids, vals = [], []
    for l in lines[1:]:
        t = l.split()
        ids.append("\t".join(t[:id_cols]))
        vals.append(t[id_cols : id_cols + len(colnames)])
    return id_mode, np.array(ids, dtype=object), colnames, vals


def _match_rows(ds: Dataset, id_mode: str, ids: np.ndarray) -> np.ndarray:
    """Map file rows -> raw sample indices (-1 = unmatched)."""
    si = ds.si
    if id_mode == "iid" and len(ids) == si.sample_ct:
        # common case: file rows in psam order -- skip the dict build
        if np.array_equal(np.asarray(ids, dtype=object), si.iid):
            return np.arange(si.sample_ct, dtype=np.int64)
    if id_mode == "fid_iid":
        keys = {f"{si.fid[i]}\t{si.iid[i]}": i for i in range(si.sample_ct)}
    else:
        keys = {str(si.iid[i]): i for i in range(si.sample_ct)}
    return np.array([keys.get(str(x), -1) for x in ids], dtype=np.int64)


def _quantile_normalize_col(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Force a column to N(0,1) quantiles over the masked samples, ties
    sharing the midpoint z (ref PhenoQuantileNormalize,
    2.0/plink2_misc.cc:3318: z = QuantileToZscore((start+end)/(2n)) per
    tie group)."""
    from ..stats.distributions import norm_ppf

    idx = np.flatnonzero(mask)
    v = np.asarray(vals, np.float64)[idx]
    order = np.argsort(v, kind="stable")
    sv = v[order]
    n = v.size
    out = np.empty(n)
    i = 0
    while i < n:
        j = i + 1
        while j < n and sv[j] == sv[i]:
            j += 1
        out[order[i:j]] = float(norm_ppf((i + j) / (2.0 * n)))
        i = j
    res = np.asarray(vals, np.float64).copy()
    res[idx] = out
    return res


def _load_covars(ds: Dataset, cfg, log: RunLogger):
    """Returns (names, data [n_raw, k] float64, nonmiss [n_raw] bool)."""
    if not cfg.covar:
        return [], np.zeros((ds.raw_sample_ct, 0)), np.ones(ds.raw_sample_ct, bool)
    with open(cfg.covar) as f:
        hdr_line = f.readline()
        body = f.read()
    toks_hdr = hdr_line.lstrip("#").split()
    if toks_hdr[0] == "FID":
        id_cols, id_mode = 2, "fid_iid"
    elif toks_hdr[0] == "IID":
        id_cols, id_mode = 1, "iid"
    else:
        raise ValueError(f"{cfg.covar}: header must start with #FID/#IID")
    colnames = toks_hdr[id_cols:]
    ncol = len(toks_hdr)
    flat = body.split()
    if len(flat) % ncol:
        # ragged file: row-wise parser
        id_mode, ids, colnames, vals = _read_table(cfg.covar)
        flat = None
    if flat is not None:
        nrow = len(flat) // ncol
        if id_cols == 2:
            ids = np.array(
                [flat[i * ncol] + "\t" + flat[i * ncol + 1]
                 for i in range(nrow)], dtype=object,
            )
        else:
            ids = np.array(flat[0::ncol], dtype=object)
    rows = _match_rows(ds, id_mode, ids)
    if cfg.covar_name:
        sel = [colnames.index(n) for n in cfg.covar_name]
        names = list(cfg.covar_name)
    else:
        sel = list(range(len(colnames)))
        names = colnames
    n = ds.raw_sample_ct
    data = np.full((n, len(sel)), np.nan)
    ok = rows >= 0
    if flat is not None:
        from ..io.psam import _parse_float_col

        fa = np.asarray(flat, dtype=object).reshape(nrow, ncol)
        numeric = np.empty((nrow, len(sel)))
        for k, s in enumerate(sel):
            col = fa[:, id_cols + s]
            try:
                numeric[:, k] = col.astype(np.float64)
            except (ValueError, TypeError):
                numeric[:, k] = _parse_float_col(col)
        numeric[numeric == -9.0] = np.nan  # input-missing-phenotype code
        data[rows[ok]] = numeric[ok]
    else:
        arr = np.array([[row[s] for s in sel] for row in vals], dtype=object)
        with np.errstate(invalid="ignore"):
            numeric = np.where(
                np.isin(arr, ("NA", "nan", "-9")), "nan", arr
            ).astype(np.float64)
        # plink2 compares the parsed double to missing_phenod (-9.0), so
        # "-9.0"/"-9e0" are also missing (2.0/plink2_psam.cc:358,524)
        numeric[numeric == -9.0] = np.nan
        data[rows[ok]] = numeric[ok]
    nonmiss = ~np.isnan(data).any(axis=1)
    log.log(
        f"{len(names)} covariate{'s' if len(names) != 1 else ''} loaded from "
        f"{cfg.covar}."
    )
    return names, np.nan_to_num(data), nonmiss


def _load_phenos(ds: Dataset, cfg, log: RunLogger):
    """Returns list of (name, kind 'qt'|'cc'|'cat', values f64 [n_raw], nonmiss)."""
    out = []
    if cfg.pheno:
        from ..io.psam import _build_pheno

        id_mode, ids, colnames, vals = _read_table(cfg.pheno)
        rows = _match_rows(ds, id_mode, ids)
        n = ds.raw_sample_ct
        for c, name in enumerate(colnames):
            col_strs = ["NA"] * n
            for r, idx in enumerate(rows):
                if idx >= 0:
                    col_strs[idx] = vals[r][c]
            pc = _build_pheno(name, col_strs)
            out.append((name, pc.kind, pc.data, pc.nonmiss))
    else:
        for name, pc in ds.si.phenos.items():
            out.append((name, pc.kind, pc.data, pc.nonmiss))
    if cfg.pheno_name:
        keep = set(cfg.pheno_name)
        out = [p for p in out if p[0] in keep]
    return out


_GLM_MODEL_MODS = {"genotypic", "hethom", "dominant", "recessive", "hetonly"}
# the modifiers plink_tpu's --glm accepts (every one runs in this port); the
# hybrid default may also be named explicitly ('firth-fallback'); no-x-sex
# (read by _ploidy_groups), skip-invalid-pheno and cols= are accepted as
# plink_tpu accepts them, and so are mperm=N and local-covar= / local-psam=
# / local-pvar=
_GLM_PORTED_MODS = _GLM_MODEL_MODS | {
    "interaction", "hide-covar", "firth", "no-firth", "firth-fallback",
    "intercept", "log10", "omit-ref", "sex", "allow-no-covars", "pheno-ids",
    "cc-residualize", "firth-residualize", "qt-residualize", "single-prec-cc",
    "aperm", "permute-qt-residuals", "perm-count", "no-x-sex",
    "skip-invalid-pheno",
}
_GLM_PREFIXES = ("cols=", "mperm=", "local-covar=", "local-psam=", "local-pvar=")
_GLM_KNOWN_UNSUPPORTED_MODS = {
    "zs", "local-omit-last", "local-haps", "local-cats",
}


def _load_condition(ds: Dataset, cfg, a1_is_alt, log: RunLogger):
    """--condition / --condition-list (plink_tpu _load_condition; ref
    GlmCondition, 2.0/plink2_glm.cc:1260): the A1 dosage of each named
    variant as a leading quantitative covariate named by its ID, ahead of
    the --covar columns.  'dominant' caps the dosage at 1, 'recessive' maps
    it to max(dosage - 1, 0) (both refused on haploid variants); haploid
    dosages other than chrX are halved.  Returns (names, data [n_raw, k]
    f64, nonmissing [n_raw] bool: every named variant called)."""
    if cfg.condition:
        want = [cfg.condition[0]]
        mods = set(cfg.condition[1:])
        flagname = "--condition"
    else:
        with open(cfg.condition_list[0]) as f:
            want = f.read().split()
        mods = set(cfg.condition_list[1:])
        flagname = "--condition-list"
    dominant = "dominant" in mods
    recessive = "recessive" in mods
    vid_to_idx: dict = {}
    dups = set()
    for i in np.flatnonzero(ds.variant_mask):
        v = str(ds.vi.vid[i])
        if v in vid_to_idx:
            dups.add(v)
        vid_to_idx[v] = i
    names, colvals = [], []
    nonmiss_all = np.ones(ds.raw_sample_ct, bool)
    skip_ct = 0
    haploid = ds.is_haploid_all()
    is_x = ds.vi.chrom == X_CODE
    seen = set()
    for v in want:
        if v in seen:
            continue
        seen.add(v)
        if v in dups:
            raise ValueError(
                f"{flagname} variant ID '{v}' appears multiple times in dataset.")
        if v not in vid_to_idx:
            skip_ct += 1
            continue
        i = vid_to_idx[v]
        codes = _unpack_np(ds.reader.read_packed(i, 1))[0][: ds.raw_sample_ct]
        nm = codes != 3
        d = codes.astype(np.float64)
        if not a1_is_alt[i]:
            d = 2.0 - d
        d[~nm] = 0.0
        if (dominant or recessive) and haploid[i]:
            raise ValueError(f"{flagname} 'dominant'/'recessive' cannot be used "
                             "with haploid variants.")
        if dominant:
            d = np.minimum(d, 1.0)
        elif recessive:
            d = np.maximum(d - 1.0, 0.0)
        if haploid[i] and not is_x[i]:
            d = d * 0.5
        names.append(v)
        colvals.append(d)
        nonmiss_all &= nm
    if skip_ct:
        log.log(f"Warning: {skip_ct} {flagname} variant ID"
                f"{'s' if skip_ct != 1 else ''} not found.")
    ct = len(names)
    log.log(f"--condition[-list]: {ct} covariate{'s' if ct != 1 else ''} added.")
    data = (np.column_stack(colvals) if colvals
            else np.zeros((ds.raw_sample_ct, 0)))
    return names, data, nonmiss_all


def _hap_scale(ds) -> np.ndarray:
    """Per-variant genotype-predictor scale: 0.5 on haploid chromosomes
    other than chrX (the reference codes haploid dosages 0..1 --
    GetGenoDosages haploid halving; chrX under --xchr-model 2 stays
    0..2)."""
    hap = ds.is_haploid_all() & (ds.vi.chrom != X_CODE)
    return np.where(hap, 0.5, 1.0).astype(np.float32)


def _ploidy_groups(ds, cfg, mods, smask, cov_names, cov_data, log):
    """Split the GLM into per-ploidy passes (plink_tpu _ploidy_groups; ref
    GlmMain's chrX/chrY sample-set and covariate switching,
    2.0/plink2_glm.cc:2502-2640, 3154-3240):

    - chrX: SEX is auto-added as a covariate (unless 'no-x-sex', the 'sex'
      modifier already added it, samples are single-sex, or all-female
      panels make X fully diploid); samples with unknown sex drop out.
    - chrY: restricted to nonfemales; skipped when all samples are female.
    - --xchr-model 0 removes chrX variants; model 1 halves male chrX
      dosages (0..1 coding, PLINK 1.x default; ref GetGenoDosages male
      halving under !xchr_model_2).

    - 'dominant'/'recessive'/'hetonly'/'genotypic'/'hethom' exclude the
      haploid chromosomes (chrY, MT) and run one pass over the rest.

    Returns None when a single pass suffices, else a list of
    (vmask_g, smask_g, cov_names_g, cov_data_g[, gmul_g]) tuples where the
    optional gmul_g is a raw-sample-indexed genotype multiplier."""
    chrom = ds.vi.chrom
    vmask = ds.variant_mask
    is_x = chrom == X_CODE
    is_y = chrom == Y_CODE
    sex = ds.si.sex
    xchr_model = cfg.xchr_model
    male_ct = int((smask & (sex == 1)).sum())
    sexnm_ct = int((smask & (sex != 0)).sum())
    n_inc = int(smask.sum())
    x_fully_diploid = (male_ct == 0) and (sexnm_ct == n_inc) and xchr_model

    if mods & _GLM_MODEL_MODS:
        # diploid-only models: drop the haploid chromosomes (chrX kept only
        # in the fully-diploid all-female case)
        drop = ds.is_haploid_all().copy()
        if x_fully_diploid:
            drop &= ~is_x
        if (vmask & drop).any():
            ct = int((vmask & drop).sum())
            log.log(f"--glm: Excluding {ct} non-diploid variant"
                    f"{'s' if ct != 1 else ''} (diploid-only genotype model).")
            return [(vmask & ~drop, smask, cov_names, cov_data)]
        return None

    has_x = bool((vmask & is_x).any())
    has_y = bool((vmask & is_y).any())
    if not has_x and not has_y:
        return None
    add_sex = (has_x and "no-x-sex" not in mods and "sex" not in mods
               and male_ct > 0 and male_ct != sexnm_ct and not x_fully_diploid)
    nonfemale = smask & (sex != 2)
    nonfemale_ct = int(nonfemale.sum())

    def with_sex():
        return (smask & (sex != 0), list(cov_names) + ["SEX"],
                np.concatenate([cov_data, sex.astype(np.float64)[:, None]],
                               axis=1))

    main_mask = vmask & ~is_x & ~is_y
    groups = []
    # chrX merges into the main pass when its sample/covariate sets match
    if has_x:
        if xchr_model == 0:
            log.log("--glm: Excluding chrX variants (--xchr-model 0).")
        elif xchr_model == 1 and male_ct > 0 and not x_fully_diploid:
            # male chrX dosage halving: a pass of its own with a per-sample
            # genotype multiplier of 0.5 for males
            gmul_x = np.where(sex == 1, 0.5, 1.0)
            if not add_sex:
                groups.append((vmask & is_x, smask, list(cov_names), cov_data,
                               gmul_x))
            else:
                groups.append((vmask & is_x, *with_sex(), gmul_x))
        elif not add_sex:
            main_mask = main_mask | (vmask & is_x)
        else:
            groups.append((vmask & is_x, *with_sex()))
    if has_y:
        if nonfemale_ct == 0:
            log.log("--glm: Skipping chrY since all samples are female.")
        elif nonfemale_ct == n_inc:
            main_mask = main_mask | (vmask & is_y)
        else:
            groups.append((vmask & is_y, nonfemale, list(cov_names), cov_data))
    if not groups and np.array_equal(main_mask, vmask):
        return None
    if main_mask.any():
        groups.insert(0, (main_mask, smask, list(cov_names), cov_data))
    return groups


def _write_pheno_ids(ds, cfg, log, pheno_name, suffix, smask, groups):
    """--glm 'pheno-ids' (plink_tpu _write_pheno_ids): the per-regression
    sample sets, <out>.<pheno>.<suffix>.id, plus .x.id / .y.id when the
    chrX / chrY sample sets differ from the main one (ref
    2.0/plink2_glm.cc:4219-4241)."""
    from .king import _ids_header_and_rows, _write_king_id

    si = ds.si
    use_fid = _ids_header_and_rows(si, np.flatnonzero(smask))
    base = f"{cfg.out}.{pheno_name}.{suffix}"
    x_sm = y_sm = None
    chrom = ds.vi.chrom
    for grp in groups or ():
        vm, sm = grp[0], grp[1]
        if not vm.any():
            continue
        if (chrom[vm] == X_CODE).all():
            x_sm = sm
        elif (chrom[vm] == Y_CODE).all():
            y_sm = sm
    _write_king_id(base + ".id", si, np.flatnonzero(smask), use_fid)
    log.log(f"--glm pheno-ids: IDs written to {base}.id .")
    if x_sm is not None and not np.array_equal(x_sm, smask):
        _write_king_id(base + ".x.id", si, np.flatnonzero(x_sm), use_fid)
    if y_sm is not None and not np.array_equal(y_sm, smask):
        _write_king_id(base + ".y.id", si, np.flatnonzero(y_sm), use_fid)


def _qt_residualize(ydata, smask, cov_data):
    """qt-residualize: the phenotype's residual after regressing it on
    [intercept | covariates] over the GLM sample set, the covariates then
    cleared (ref FillResidualizedPhenoAndXtY via
    GlmAllocFillAndTestPhenoCovarsQt, 2.0/plink2_glm_linear.cc:181-210;
    the regressions that follow keep the intercept)."""
    inc = np.flatnonzero(smask)
    X = np.concatenate(
        [np.ones((inc.size, 1)), cov_data[inc].astype(np.float64)], axis=1)
    yv = ydata[inc].astype(np.float64)
    beta, *_ = np.linalg.lstsq(X, yv, rcond=None)
    y2 = np.array(ydata, dtype=np.float64, copy=True)
    y2[inc] = yv - X @ beta
    return y2, [], np.zeros((ydata.shape[0], 0))


def _drop_const_covars(smask_g, names_g, data_g):
    """Per-group constant-covariate pruning (ref: GlmDetermineCovars run
    per chrX/chrY sample set)."""
    if not names_g:
        return names_g, data_g
    keep = [j for j in range(len(names_g))
            if np.ptp(data_g[smask_g, j]) != 0]
    if len(keep) == len(names_g):
        return names_g, data_g
    return [names_g[j] for j in keep], data_g[:, keep]


def _phase_timer(log):
    """PLINK_TORCH_TIMING=1: per-phase wall times in the .log (device work
    is complete at each mark: every mark follows a device-to-host fetch)."""
    if not os.environ.get("PLINK_TORCH_TIMING"):
        return lambda label: None
    t = [time.perf_counter()]

    def mark(label):
        now = time.perf_counter()
        log.log(f"[timing] {label}: {now - t[0]:.3f}s", console=False)
        t[0] = now

    return mark


def _check_modifiers(mods: set, log: RunLogger):
    """plink_tpu run_glm's --glm modifier validation, in its order (ref
    2.0/plink2.cc --glm parsing, the residualize checks of :6775-6800 and
    the permutation modifiers).  Drops a redundant 'firth-residualize'
    from `mods` with plink_tpu's note.  Returns (permutation mode:
    'adaptive', 'maxT' or None, the mperm= count)."""
    for m_ in sorted(mods):
        if m_ in _GLM_PORTED_MODS or m_.startswith(_GLM_PREFIXES):
            continue
        if m_ in _GLM_KNOWN_UNSUPPORTED_MODS or m_.startswith("local-"):
            raise ValueError(f"--glm modifier '{m_}' is not supported yet.")
        raise ValueError(f"Invalid --glm argument '{m_}'.")
    if len(mods & _GLM_MODEL_MODS) > 1 or ("firth" in mods and "no-firth" in mods):
        raise ValueError("Conflicting --glm arguments.")
    if {"cc-residualize", "firth-residualize", "qt-residualize"} & mods:
        if "firth-residualize" in mods and "cc-residualize" in mods:
            log.log("Note: 'firth-residualize' is redundant when "
                    "'cc-residualize' is already specified.")
            mods.discard("firth-residualize")
        if "hide-covar" not in mods:
            raise ValueError("--glm '{cc,firth,qt}-residualize' requires "
                             "'hide-covar' to be specified as well.")
        if "interaction" in mods:
            raise ValueError("--glm '{cc,firth,qt}-residualize' cannot be used "
                             "with 'interaction'.")
        if "intercept" in mods:
            raise ValueError("--glm '{cc,firth,qt}-residualize' cannot be used "
                             "with 'intercept'.")
        if any(m_.startswith("local-covar=") for m_ in mods):
            raise ValueError("--glm '{cc,firth,qt}-residualize' cannot be used "
                             "with local covariates.")
        if "firth-residualize" in mods and "no-firth" in mods:
            raise ValueError("--glm 'firth-residualize' doesn't make sense "
                             "with 'no-firth'.")
    mperm_ct = 0
    for m_ in mods:
        if m_.startswith("mperm="):
            mperm_ct = int(m_.split("=", 1)[1])
    if "aperm" in mods and mperm_ct:
        raise ValueError("Conflicting --glm arguments (aperm + mperm).")
    perm_mode = "adaptive" if "aperm" in mods else ("maxT" if mperm_ct else None)
    if "permute-qt-residuals" in mods and (perm_mode is None
                                           or "qt-residualize" not in mods):
        raise ValueError("--glm 'permute-qt-residuals' must be used with "
                         "'qt-residualize' and a permutation test.")
    return perm_mode, mperm_ct


def _transform_covars(ds, cfg, log, cov_names, cov_data, cov_nonmiss):
    """--covar-variance-standardize, --variance-standardize and the
    covariate half of --quantile-normalize / --covar-quantile-normalize,
    as plink_tpu run_glm applies them (in place on cov_data)."""
    if cfg.covar_variance_standardize and cov_data.shape[1]:
        m = cov_data[cov_nonmiss].mean(axis=0)
        sd = cov_data[cov_nonmiss].std(axis=0, ddof=1)
        sd[sd == 0] = 1.0
        cov_data[:] = (cov_data - m) / sd
    vs = cfg.variance_standardize
    if vs and cov_data.shape[1]:
        sel = [j for j, nm_ in enumerate(cov_names) if "*" in vs or nm_ in vs]
        if sel:
            sub = cov_data[:, sel]
            m = sub[cov_nonmiss].mean(axis=0)
            sd = sub[cov_nonmiss].std(axis=0, ddof=1)
            sd[sd == 0] = 1.0
            cov_data[:, sel] = (sub - m) / sd
    qn_cov = set()
    for spec in (cfg.quantile_normalize, cfg.covar_quantile_normalize):
        if spec:
            qn_cov |= {j for j, nm_ in enumerate(cov_names)
                       if "*" in spec or nm_ in spec}
    if qn_cov:
        mask_c = cov_nonmiss & ds.sample_mask
        for j in sorted(qn_cov):
            cov_data[:, j] = _quantile_normalize_col(cov_data[:, j], mask_c)
        log.log(f"--covar-quantile-normalize: {len(qn_cov)} covariate"
                f"{'s' if len(qn_cov) != 1 else ''} transformed.")


def _a1_names(ds: Dataset, a1_is_alt) -> np.ndarray:
    """Each variant's A1 allele (the .adjusted report's A1 column)."""
    return np.where(a1_is_alt, ds.vi.alt1(), ds.vi.ref)


def _write_adjusted(ds, cfg, log, pheno_name, suffix, add_results, a1_is_alt):
    """--adjust after a report (plink_tpu calls write_adjusted wherever a
    report is written)."""
    if cfg.adjust:
        from .adjust import write_adjusted

        write_adjusted(ds, cfg, log, pheno_name, suffix, add_results,
                       _a1_names(ds, a1_is_alt))


def _fit_groups(fit, report, groups, ydata, qt_resid, log, perm_capture=None):
    """Run `fit` once per ploidy group into one report (the per-ploidy
    passes of plink_tpu run_glm :740-760, :826-850), each group with its
    own constant-covariate pruning, qt-residualization and genotype
    multiplier.  Returns the groups' (variant, ln p) pairs for --adjust."""
    sink: list = []
    hdr_box: list = []
    add_results: list = []
    for grp in groups:
        vm_g, sm_g, nm_g, dt_g = grp[:4]
        gmul_g = grp[4] if len(grp) > 4 else None
        if not vm_g.any() or not sm_g.any():
            continue
        nm_g, dt_g = _drop_const_covars(sm_g, nm_g, dt_g)
        y_g = ydata
        if qt_resid:
            # per sample set: plink2 residualizes main / chrX / chrY apart,
            # each with that set's covariates
            y_g, nm_g, dt_g = _qt_residualize(ydata, sm_g, dt_g)
        fit(y_g, sm_g, nm_g, dt_g, vmask=vm_g, sink=sink, header_out=hdr_box,
            gmul=gmul_g, add_results=add_results, perm_capture=perm_capture)
    _write_sink(report, hdr_box[0], sink, log)
    return add_results


def _new_capture(M: int) -> dict:
    """Each variant's original test for the permutation counts (valid
    flag, |t| / |z| or joint F / chisq, ln p, dof or obs), filled by the
    report's emit."""
    return {"valid": np.zeros(M, bool), "t": np.full(M, np.nan),
            "lnp": np.full(M, np.nan), "dof": np.zeros(M)}


def _load_local_covars(ds, mods, log):
    """--glm local-covar= / local-psam= / local-pvar= (plink_tpu
    _load_local_covars; ref GlmLocalOpen, 2.0/plink2_glm.cc:751): the
    local-pvar variant list RESTRICTS the analysis to its variants (one
    local-covar line each); local-psam fixes the per-line sample column
    order; the covariate count is inferred from the line width.  Returns
    None or (vals [L, n_loc, K], line_of {raw variant: line}, loc_raw_idx,
    K)."""
    paths = {}
    for m_ in mods:
        for key in ("local-covar", "local-psam", "local-pvar"):
            if m_.startswith(key + "="):
                paths[key] = m_.split("=", 1)[1]
    if not paths:
        return None
    if len(paths) != 3:
        raise ValueError(
            "--glm: local-covar= requires local-psam= and local-pvar=.")
    si = ds.si
    with open(paths["local-psam"]) as f:
        loc_ids = [ln.split()[-1] for ln in f
                   if ln.strip() and not ln.startswith("#")]
    by_iid = {str(si.iid[i]): i for i in range(si.sample_ct)}
    loc_raw_idx = np.array([by_iid.get(x, -1) for x in loc_ids])
    with open(paths["local-pvar"]) as f:
        loc_vids = [ln.split("\t")[2] if "\t" in ln else ln.split()[2]
                    for ln in f if ln.strip() and not ln.startswith("#")]
    vid_to_raw = {str(v): i for i, v in enumerate(ds.vi.vid)}
    line_of = {}
    for ln_idx, vid_ in enumerate(loc_vids):
        i = vid_to_raw.get(vid_)
        if i is not None:
            line_of[i] = ln_idx
    n_loc = len(loc_ids)
    rows = []
    K = None
    with open(paths["local-covar"]) as f:
        for ln in f:
            t = ln.split()
            if not t:
                continue
            if K is None:
                K = len(t) // n_loc
                if K * n_loc != len(t):
                    raise ValueError(
                        "--glm local-covar=: line width is not a multiple of "
                        "the local sample count.")
            rows.append(np.array(t, dtype=np.float64).reshape(n_loc, K))
    vals = np.stack(rows)
    log.log(f"--glm local-covar=: {K} local covariate{'s' if K != 1 else ''} "
            "present.")
    return vals, line_of, loc_raw_idx, K


def run_glm(ds: Dataset, cfg, log: RunLogger) -> None:
    mods = set(cfg.glm_modifiers)
    perm_mode, mperm_ct = _check_modifiers(mods, log)
    hide_covar = "hide-covar" in mods
    omit_ref = "omit-ref" in mods
    always_firth = "firth" in mods
    no_firth = "no-firth" in mods

    mark = _phase_timer(log)
    cov_names, cov_data, cov_nonmiss = _load_covars(ds, cfg, log)
    phenos = _load_phenos(ds, cfg, log)
    mark("covariates+phenotypes")

    # A1 selection (minor allele unless omit-ref; from the dosages where a
    # variant has them)
    freqs = alt_allele_freqs(ds, founders_only=not cfg.nonfounders,
                             dosage=True)
    a1_is_alt = np.ones(ds.raw_variant_ct, bool) if omit_ref else ~(freqs > 0.5)
    mark("A1 counts")
    if cfg.condition or cfg.condition_list:
        cnames, cdata, cnonmiss = _load_condition(ds, cfg, a1_is_alt, log)
        cov_names = cnames + cov_names
        cov_data = np.concatenate([cdata, cov_data], axis=1)
        cov_nonmiss = cov_nonmiss & cnonmiss
    if "sex" in mods:
        cov_names = cov_names + ["SEX"]
        cov_data = np.concatenate(
            [cov_data, ds.si.sex.astype(np.float64)[:, None]], axis=1)
        cov_nonmiss = cov_nonmiss & (ds.si.sex != 0)
    has_local = any(m_.startswith("local-covar=") for m_ in mods)
    if not cov_names and "allow-no-covars" not in mods and not has_local:
        raise ValueError(
            "--glm: no covariates loaded; use 'allow-no-covars' to allow this"
        )
    _transform_covars(ds, cfg, log, cov_names, cov_data, cov_nonmiss)
    local_info = _load_local_covars(ds, mods, log)
    if not phenos:
        raise ValueError("--glm: no phenotypes loaded")

    suffix = "glm.firth" if always_firth else (
        "glm.logistic" if no_firth else "glm.logistic.hybrid")
    for name, kind, ydata, ynonmiss in phenos:
        if kind == "cat":
            log.log(f"--glm: skipping categorical phenotype '{name}'.")
            continue
        for spec in (cfg.pheno_quantile_normalize, cfg.quantile_normalize):
            if spec and kind == "qt" and ("*" in spec or name in spec):
                ydata = _quantile_normalize_col(ydata, ynonmiss & ds.sample_mask)
                break
        smask = ds.sample_mask & ynonmiss & cov_nonmiss
        nm_ct = int(smask.sum())
        # drop covariates that are constant over this pheno's sample set
        # (ref: GlmDetermineCovars; log wording matches plink2)
        p_names, p_data = list(cov_names), cov_data
        keep = []
        for j, cn in enumerate(p_names):
            if np.ptp(p_data[smask, j]) == 0:
                log.log(
                    f"Warning: Excluding constant covariate '{cn}' from --glm."
                )
            else:
                keep.append(j)
        p_names = [p_names[j] for j in keep]
        p_data = p_data[:, keep]
        qt_resid = False
        if kind == "cc":
            case_ct = int(ydata[smask].sum())
            log.log(
                f"--glm {'Firth' if always_firth else 'logistic'} regression on "
                f"phenotype '{name}': {case_ct} cases, {nm_ct - case_ct} controls."
            )
            rsuffix = suffix
            fit = partial(_glm_logistic, ds, cfg, log, name,
                          a1_is_alt=a1_is_alt, hide_covar=hide_covar,
                          always_firth=always_firth, no_firth=no_firth)
        else:
            log.log(f"--glm linear regression on phenotype '{name}': {nm_ct} samples.")
            rsuffix = "glm.linear"
            qt_resid = "qt-residualize" in mods
            fit = partial(_glm_linear, ds, cfg, log, name,
                          a1_is_alt=a1_is_alt, hide_covar=hide_covar)
        if ds.has_dosage or local_info is not None:
            # plink_tpu's dosage route (also every run with local
            # covariates): no ploidy groups, no permutation test,
            # qt-residualize before the pheno-ids file (glm_dosage.py)
            from .glm_dosage import glm_dosage

            if qt_resid:
                ydata, p_names, p_data = _qt_residualize(ydata, smask, p_data)
            if "pheno-ids" in mods:
                _write_pheno_ids(ds, cfg, log, name, rsuffix, smask, None)
            glm_dosage(ds, cfg, log, name, ydata, smask, p_names, p_data,
                       a1_is_alt, hide_covar, kind, always_firth, no_firth,
                       local_info)
            continue
        report = f"{cfg.out}.{name}.{rsuffix}"
        # fit(phenotype, sample mask, covariate names, covariate data,
        #     **pass options)
        groups = _ploidy_groups(ds, cfg, mods, smask, p_names, p_data, log)
        if "pheno-ids" in mods:
            _write_pheno_ids(ds, cfg, log, name, rsuffix, smask, groups)
        capture = None
        if perm_mode:
            if kind == "cc" and not always_firth:
                raise ValueError("--glm case/control permutation test requires "
                                 "'firth' modifier.")
            if qt_resid and groups is not None:
                # plink2 rejects permute-qt-residuals here outright
                # (2.0/plink2_glm.cc:2992); plink_tpu extends the guard to
                # qt-residualize, whose per-group residual phenotypes would
                # need per-permutation refits
                raise ValueError(
                    "--glm 'qt-residualize' permutation does not support "
                    "chrX/chrY unless the samples/covariates are unchanged "
                    "there.")
            capture = _new_capture(ds.raw_variant_ct)
        if groups is None:
            y_run, nm_run, dt_run = ydata, p_names, p_data
            if qt_resid:
                y_run, nm_run, dt_run = _qt_residualize(ydata, smask, p_data)
            add_results: list = []
            fit(y_run, smask, nm_run, dt_run, add_results=add_results,
                perm_capture=capture)
        else:
            add_results = _fit_groups(fit, report, groups, ydata, qt_resid, log,
                                      capture)
        _write_adjusted(ds, cfg, log, name, rsuffix, add_results, a1_is_alt)
        if perm_mode:
            from .glm_perm import glm_firth_perm, glm_linear_perm

            if kind == "cc":
                glm_firth_perm(ds, cfg, log, name, ydata, smask, p_names, p_data,
                               a1_is_alt, capture, perm_mode, mperm_ct, groups)
            else:
                y_run, nm_run, dt_run = ydata, p_names, p_data
                if qt_resid:
                    y_run, nm_run, dt_run = _qt_residualize(ydata, smask, p_data)
                glm_linear_perm(ds, cfg, log, name, y_run, smask, nm_run, dt_run,
                                a1_is_alt, capture, perm_mode, mperm_ct, groups)


def _row_meta(ds: Dataset, a1_is_alt):
    vi = ds.vi
    _, prov_fn = _provref_strs(ds)
    provref = [prov_fn(i).lstrip("\t") or "N" for i in range(vi.variant_ct)]
    chrom = [vi.chr_info.name(c) for c in vi.chrom]
    alt1 = vi.alt1()
    a1 = np.where(a1_is_alt, alt1, vi.ref)
    omitted = np.where(a1_is_alt, vi.ref, alt1)
    return chrom, provref, a1, omitted


ERR_OK = "."
_LN10 = np.log(10.0)


def _p_str(lnp: float, log10: bool) -> str:
    """P column renderer: ln-space string, or -log10(p) under 'log10'."""
    if log10:
        return "NA" if not np.isfinite(lnp) else g6(-lnp / _LN10)
    return logp_to_str(lnp)


def _auto_vb(npad: int) -> int:
    """Variant-block size bounded so the plain versions' [vb, n] f32
    temporaries stay ~0.5 GB at biobank n (the kernels keep none); 2,048 at
    500,000 samples.  PLINK_TORCH_VB overrides (the tests force many blocks
    on small panels with it)."""
    env = os.environ.get("PLINK_TORCH_VB")
    if env:
        return max(8, (int(env) // 8) * 8)
    target_elems = 1 << 30
    vb = max(64, min(2048, target_elems // max(npad, 1)))
    return (vb // 8) * 8


# the additive predictor: plane weights over (het, hom-ALT, valid) when A1 is
# ALT, and after the A1=REF flip g' = 2*valid - g
_ADD = ("ADD", (1, 2, 0), (-1, -2, 2))


def _geno_predictors(mods: set):
    """Genotype predictor descriptors for the requested model.

    Each predictor is (test_name, weights_when_A1_is_ALT,
    weights_when_A1_is_REF) with weights over the (H, A, V) planes; the
    A1=REF flip follows g' = 2*valid - g algebra (ADD' = -H - 2A + 2V, etc).
    Returns (preds, joint_name) where joint_name is e.g. GENO_2DF.
    """
    if "dominant" in mods:
        return [("DOM", (1, 1, 0), (0, -1, 1))], None
    if "recessive" in mods:
        return [("REC", (0, 1, 0), (-1, -1, 1))], None
    if "hetonly" in mods:
        return [("HET", (1, 0, 0), (1, 0, 0))], None
    if "genotypic" in mods:
        return (
            [("ADD", (1, 2, 0), (-1, -2, 2)), ("DOMDEV", (1, 0, 0), (1, 0, 0))],
            "GENO_2DF",
        )
    if "hethom" in mods:
        # HOM = hom-A1 indicator, HET = het indicator
        return (
            [("HOM", (0, 1, 0), (-1, -1, 1)), ("HET", (1, 0, 0), (1, 0, 0))],
            "GENO_2DF",
        )
    return [_ADD], None


def _glm_linear(
    ds, cfg, log, pheno_name, ydata, smask, cov_names, cov_data, a1_is_alt,
    hide_covar, vmask=None, sink=None, header_out=None, gmul=None,
    add_results=None, perm_capture=None,
):
    """Runs one linear-GLM pass over `vmask` (default: all included
    variants) for one sample set / covariate set.  Writes
    <out>.<pheno>.glm.linear, or with `sink` appends per-variant row strings
    to it and the header to `header_out` (the per-ploidy passes share one
    report; ref: GlmMain's per-chromosome sample/covariate switching,
    2.0/plink2_glm.cc:3154-3240).  `add_results` collects each valid
    primary test's (variant, ln p) for --adjust, `perm_capture` each
    variant's original statistic for the permutation test.

    K6 gives every variant's plane sums in one pass per block; X^T X, X^T y
    and y^T y of any model are their linear combinations with the
    sample-set totals (the role RegressionNmPrecomp plays in the
    reference), solved per variant in f64 on the host.  `gmul` (raw-sample
    genotype multiplier, --xchr-model 1) needs s^k-weighted sums for the
    entries with k genotype factors: K6 runs twice more with its per-sample
    table pre-scaled by s and s^2 (plink_tpu _glm_linear :1045-1113)."""
    from ..ops.glm import linear_sums_scan

    mods = set(cfg.glm_modifiers)
    geno_preds, joint_name = _geno_predictors(mods)
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float64)
    dc = len(cov_names) + 1
    vb = _auto_vb(-(-n // 4) * 4)
    c = np.concatenate([np.ones((n, 1)), cov_data[inc]], axis=1)

    # predictors: const, genotype predictors, covariates, then (interaction)
    # each genotype predictor times each covariate; each is (name, plane
    # weights (wH, wA, wV) when A1 is ALT, when A1 is REF, c column)
    pred_specs = [("CONST", (0, 0, 1), (0, 0, 1), 0)]
    pred_specs += [(nm_, wa, wr, 0) for nm_, wa, wr in geno_preds]
    pred_specs += [(cn, (0, 0, 1), (0, 0, 1), j + 1)
                   for j, cn in enumerate(cov_names)]
    if "interaction" in mods:
        pred_specs += [(f"{g}x{cn}", wa, wr, j + 1) for g, wa, wr in geno_preds
                       for j, cn in enumerate(cov_names)]
    d = len(pred_specs)
    geno_idx = list(range(1, 1 + len(geno_preds)))  # the joint test's columns
    # every column with a genotype factor (main effects and interactions)
    is_geno = [wa != (0, 0, 1) or wr != (0, 0, 1) for _, wa, wr, _ in pred_specs]
    tests = [s_[0] for s_ in pred_specs[1:]]
    if hide_covar:
        tests = [t for t in tests if t not in cov_names]
    if joint_name:
        tests = tests + [joint_name]
    if "intercept" in mods:
        tests = ["INTERCEPT"] + tests
    log10 = "log10" in mods
    geno_desc = [sp for sp, g in zip(pred_specs, is_geno) if g]
    exact_s_fn = _exact_s_builder(ds, inc, c, a1_is_alt, geno_desc, gmul)

    # shared f64 blocks (role of RegressionNmPrecomp)
    ctc_full = c.T @ c
    cty_full = c.T @ y
    yy_full = float(y @ y)

    if vmask is None:
        vmask = ds.variant_mask
    standalone = sink is None
    if standalone:
        sink = []
    mark = _phase_timer(log)
    pd = PackedDevice(ds, vmask, vb=vb, sample_mask=smask)
    npad = pd.npad
    cp = np.zeros((npad, dc))
    cp[:n] = c
    yp = np.zeros(npad)
    yp[:n] = y

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(ds.device)

    ccfl = dev32((cp[:, :, None] * cp[:, None, :]).reshape(npad, dc * dc))
    cy32 = dev32(cp * yp[:, None])
    y232 = dev32(yp * yp)

    M = ds.raw_variant_ct
    chrom, provref, a1, omitted = _row_meta(ds, a1_is_alt)
    vi = ds.vi
    stat_col = "T_OR_F_STAT" if joint_name else "T_STAT"
    p_col = "NEG_LOG10_P" if log10 else "P"
    header = (
        "#CHROM\tPOS\tID\tREF\tALT\tPROVISIONAL_REF?\tA1\tOMITTED\tA1_FREQ\t"
        f"TEST\tOBS_CT\tBETA\tSE\t{stat_col}\t{p_col}\tERRCODE\n"
    )
    if header_out is not None:
        header_out.append(header)
    mark("pack+upload")

    # K6 sums each variant's hom-A1 plane (hom-REF where A1 is REF), so
    # every model is assembled from its A1 weights alone
    a1_ref = np.zeros(pd.nblocks * pd.vb, bool)
    a1_ref[:M] = ~a1_is_alt
    a1_ref = torch.from_numpy(a1_ref.reshape(pd.nblocks, pd.vb)).to(ds.device)

    def scan(ccfl_, cy_, y2_):
        return {k: v.cpu().numpy().astype(np.float64)
                for k, v in linear_sums_scan(pd.packed, ccfl_, cy_, y2_,
                                             a1_ref).items()}

    # powers[k]: the plane sums with the per-sample table scaled by s^k, and
    # the matching sample-set totals (plane * s * c_j c_k == plane *
    # (s * c_j c_k), so the same kernel serves)
    powers = {0: (scan(ccfl, cy32, y232), ctc_full, cty_full)}
    if gmul is not None:
        sm_pad = np.zeros(npad)
        sm_pad[:n] = gmul[inc]
        for pw in (1, 2):
            sk = dev32(sm_pad ** pw)
            spad64 = (sm_pad ** pw)[:, None]
            powers[pw] = (scan(ccfl * sk[:, None], cy32 * sk[:, None],
                               y232 * sk),
                          (cp * spad64).T @ cp, (cp * spad64).T @ yp)
    mark("device scan+fetch")
    hs_all = _hap_scale(ds).astype(np.float64)
    scaled = gmul is not None
    for bi in range(pd.nblocks):
        v0 = bi * pd.vb
        vct = min(pd.vb, M - v0)
        ia = np.flatnonzero(vmask[v0 : v0 + vct])
        if ia.size == 0:
            continue
        b = len(ia)
        plane = {}
        for pw, (sums_all, ctc_p, cty_p) in powers.items():
            sums = {k: v[bi][ia] for k, v in sums_all.items()}
            plane[pw] = (sums["hcc"].reshape(b, dc, dc),
                         sums["acc"].reshape(b, dc, dc),
                         ctc_p[None] - sums["mcc"].reshape(b, dc, dc),
                         sums["hcy"], sums["acy"], cty_p[None] - sums["mcy"])
            if pw == 0:
                yy_v = yy_full - sums["myy"]
        nm = plane[0][2][:, 0, 0]

        def cross(w1, w2, j1, j2, pw=0):
            # plane products collapse: H*H = H, H*V = H, A*V = A, H*A = 0
            hcc, acc, vcc = plane[pw][:3]
            h1, a1_, v1 = w1
            h2, a2_, v2 = w2
            coef_h = h1 * h2 + h1 * v2 + v1 * h2
            coef_a = a1_ * a2_ + a1_ * v2 + v1 * a2_
            coef_v = v1 * v2
            return (coef_h * hcc[:, j1, j2] + coef_a * acc[:, j1, j2]
                    + coef_v * vcc[:, j1, j2])

        def xy(w, j, pw=0):
            hcy, acy, vcy = plane[pw][3:]
            h, a_, v = w
            return h * hcy[:, j] + a_ * acy[:, j] + v * vcy[:, j]

        xtx = np.zeros((b, d, d))
        xty = np.zeros((b, d))
        for p in range(d):
            _, wa1, _, j1 = pred_specs[p]
            for q in range(p, d):
                _, wa2, _, j2 = pred_specs[q]
                pw = (is_geno[p] + is_geno[q]) if scaled else 0
                val = cross(wa1, wa2, j1, j2, pw)
                xtx[:, p, q] = val
                xtx[:, q, p] = val
            pwy = int(is_geno[p]) if scaled else 0
            xty[:, p] = xy(wa1, j1, pwy)

        # A1 dosage sums for A1_FREQ / const-allele detection (one and two
        # genotype factors: s- and s^2-weighted when scaled)
        pw1, pw2 = (1, 2) if scaled else (0, 0)
        g1 = cross((1, 2, 0), (0, 0, 1), 0, 0, pw1)
        gg1 = cross((1, 2, 0), (1, 2, 0), 0, 0, pw2)

        # haploid genotype coding 0..1: scale geno rows/cols of the
        # sufficient statistics (s for cross terms, s^2 for geno-geno)
        hs_b = hs_all[v0 + ia]
        if (hs_b != 1.0).any():
            for p in np.flatnonzero(is_geno):
                xtx[:, p, :] *= hs_b[:, None]
                xtx[:, :, p] *= hs_b[:, None]
                xty[:, p] *= hs_b
        aobs = rawconst = None
        if scaled:
            # --xchr-model 1: allele_obs = 2 sum_valid(s) (= 2 nm - nm_male,
            # ref allele_obs_ct -= nm_male_ct) and the raw-genocount const
            # rule (ref plink2_glm_logistic.cc:1578-1582)
            aobs = 2.0 * plane[1][2][:, 0, 0]
            hct, act = plane[0][0][:, 0, 0], plane[0][1][:, 0, 0]
            rawconst = ((hct >= nm - 0.5) | (act >= nm - 0.5)
                        | ((hct <= 0.5) & (act <= 0.5)))
        _emit_linear_rows(
            sink, v0, ia, nm, g1, gg1, xtx, xty, yy_v, d, tests, chrom,
            provref, a1, omitted, vi, pred_specs, geno_idx, joint_name,
            exact_s_fn, log10, aobs, rawconst, add_results, perm_capture,
        )
    mark("host postprocess+emit")
    if standalone:
        _write_sink(f"{cfg.out}.{pheno_name}.glm.linear", header, sink, log)


def _emit_linear_rows(
    sink, v0, ia, nm, g1, gg1, xtx, xty, yy_v, d, tests, chrom, provref, a1,
    omitted, vi, pred_specs, geno_idx, joint_name, exact_s_fn, log10,
    aobs=None, rawconst=None, add_results=None, perm_capture=None,
):
    b = len(ia)
    beta = np.full((b, d), np.nan)
    se = np.full((b, d), np.nan)
    tstat = np.full((b, d), np.nan)
    logp = np.full((b, d), np.nan)
    fstat = np.full(b, np.nan)
    logp_joint = np.full(b, np.nan)
    err = [ERR_OK] * b
    dof = nm - d
    gvar = gg1 - np.where(nm > 0, g1 * g1 / np.maximum(nm, 1), 0.0)
    q_joint = len(geno_idx)
    for i in range(b):
        if nm[i] <= d:
            err[i] = "SAMPLE_CT<=PREDICTOR_CT"
            continue
        if rawconst[i] if rawconst is not None else gvar[i] <= 1e-12:
            # biallelic const genotype: the reference's check order flags the
            # omitted (major) allele first (plink2_glm_logistic.cc:1966-1969)
            err[i] = "CONST_OMITTED_ALLELE"
            continue
        ce = _collinearity_err_checked(
            xtx[i], nm[i], lambda i=i: exact_s_fn(int(v0 + ia[i]))
        )
        if ce is not None:
            err[i] = ce
            continue
        try:
            inv = np.linalg.inv(xtx[i])
        except np.linalg.LinAlgError:
            err[i] = "RANK_DEFICIENT"
            continue
        bvec = inv @ xty[i]
        rss = yy_v[i] - bvec @ xty[i]
        sigma2 = rss / dof[i]
        diag = np.diag(inv)
        if sigma2 < 0 or (diag <= 0).any():
            err[i] = "INVALID_RESULT"
            continue
        beta[i] = bvec
        se[i] = np.sqrt(sigma2 * diag)
        tstat[i] = bvec / se[i]
        if joint_name:
            # reduced model: drop the genotype predictors
            keep = [p for p in range(d) if p not in geno_idx]
            try:
                inv0 = np.linalg.inv(xtx[i][np.ix_(keep, keep)])
                b0 = inv0 @ xty[i][keep]
                rss0 = yy_v[i] - b0 @ xty[i][keep]
                fstat[i] = ((rss0 - rss) / q_joint) / sigma2
            except np.linalg.LinAlgError:
                pass
    ok = np.array([e == ERR_OK for e in err])
    if ok.any():
        logp[ok] = np.asarray(t_logp_2sided(tstat[ok], dof[ok, None]))
        if joint_name:
            okj = ok & np.isfinite(fstat)
            if okj.any():
                # second dof = sample_obs_ct (ref FstatToLnP(chisq/ct, ct,
                # sample_obs_ct)), not the residual dof
                logp_joint[okj] = np.asarray(
                    f_logsf(fstat[okj], float(q_joint),
                            nm[okj].astype(np.float64))
                )

    with np.errstate(invalid="ignore"):
        denom = aobs if aobs is not None else 2 * np.maximum(nm, 1)
        a1f = np.where(nm > 0, g1 / np.maximum(denom, 1e-300), np.nan)
    if add_results is not None:
        # the first of these predictors is --adjust's test (plink_tpu's
        # list: a `hetonly` model's HET is not in it)
        add_pred = next((p for p, spec in enumerate(pred_specs)
                         if spec[0] in ("ADD", "DOM", "REC", "HETONLY", "HOM")),
                        None)
        if add_pred is not None:
            for i in range(b):
                if err[i] == ERR_OK and np.isfinite(logp[i, add_pred]):
                    add_results.append((int(v0 + ia[i]), float(logp[i, add_pred])))
    if perm_capture is not None and geno_idx:
        vv = v0 + ia
        if joint_name:
            # constraint models permute on the joint test: raw F on the
            # device, its ln p on the host for EMP2
            okp = ok & np.isfinite(fstat) & np.isfinite(logp_joint)
            perm_capture["t"][vv] = np.where(okp, fstat, np.nan)
            perm_capture["lnp"][vv] = np.where(okp, logp_joint, np.nan)
        else:
            gp = geno_idx[0]
            okp = ok & np.isfinite(logp[:, gp])
            perm_capture["t"][vv] = np.where(okp, tstat[:, gp], np.nan)
            perm_capture["lnp"][vv] = np.where(okp, logp[:, gp], np.nan)
        perm_capture["valid"][vv] = okp
        perm_capture["dof"][vv] = dof
    test_pred = {spec[0]: p for p, spec in enumerate(pred_specs)}
    test_pred["INTERCEPT"] = 0
    for i in range(b):
        vidx = v0 + ia[i]
        lines = []
        meta = (
            f"{chrom[vidx]}\t{vi.pos[vidx]}\t{vi.vid[vidx]}\t{vi.ref[vidx]}\t"
            f"{vi.alt[vidx]}\t{provref[vidx]}\t{a1[vidx]}\t{omitted[vidx]}\t"
            f"{g6(a1f[i])}"
        )
        for tname in tests:
            if err[i] != ERR_OK:
                lines.append(
                    f"{meta}\t{tname}\t{int(nm[i])}\tNA\tNA\tNA\tNA\t{err[i]}\n"
                )
            elif tname == joint_name:
                lines.append(
                    f"{meta}\t{tname}\t{int(nm[i])}\tNA\tNA\t{g6(fstat[i])}\t"
                    f"{_p_str(logp_joint[i], log10)}\t.\n"
                )
            else:
                pi = test_pred[tname]
                lines.append(
                    f"{meta}\t{tname}\t{int(nm[i])}\t{g6(beta[i, pi])}\t"
                    f"{g6(se[i, pi])}\t{g6(tstat[i, pi])}\t"
                    f"{_p_str(logp[i, pi], log10)}\t.\n"
                )
        sink.append((int(vidx), "".join(lines)))


def _write_sink(path, header, sink, log):
    sink.sort(key=lambda kv: kv[0])
    with open(path, "w") as f:
        f.write(header)
        f.writelines(s for _, s in sink)
    log.log(f"Results written to {path} .")


def _collinearity_err(s, nm_i):
    """Port of CheckMaxCorrAndVif (2.0/plink2_glm_shared.cc:60-134, defaults
    max_corr=0.999 / vif=50) as built WITHOUT LAPACK: every inversion is the
    SVD-based InvertMatrix (2.0/plink2_matrix.cc:355) which zeroes singular
    values below wmax*1e-24 and never "fails" on merely-singular input --
    near-singular correlation matrices produce huge NEGATIVE diagonals that
    pass the "> vif_thresh" test, so such variants proceed to regression.

    s = X^T X over the variant's valid samples, intercept in column 0.
    Returns (errcode | None, decisive); decisive=False means the verdict is
    within f32 noise of a threshold and should be recomputed from an exact
    f64 s.
    """
    k = s.shape[0] - 1
    if k < 2:
        # reference: 1x1 correlation "matrix" trivially passes
        return None, True
    sums = s[0, 1:]
    covm = (s[1:, 1:] - np.outer(sums, sums) / nm_i) / (nm_i - 1.0)
    var = np.diag(covm)
    with np.errstate(divide="ignore", invalid="ignore"):
        istd = 1.0 / np.sqrt(var)
        corr = covm * np.outer(istd, istd)
    od = np.abs(corr[~np.eye(k, dtype=bool)])
    odf = od[np.isfinite(od)]
    max_od = float(odf.max()) if odf.size else 0.0
    decisive = max_od < 0.99
    if max_od > 0.999:
        return "CORR_TOO_HIGH", decisive
    cm = corr.copy()
    np.fill_diagonal(cm, 1.0)
    try:
        u, w, vt = np.linalg.svd(cm)
    except np.linalg.LinAlgError:
        # NaN rows (zero-variance predictor): SvdcmpC fails to converge
        return "VIF_INFINITE", False
    if not np.isfinite(w).all():
        return "VIF_INFINITE", False
    winv = np.where(w < w.max() * 1e-24, 0.0, 1.0 / w)
    diag = np.einsum("ij,j,ji->i", u, winv, vt)
    max_diag = float(diag.max())
    if w.min() < 1e-9 * w.max() or max_diag > 40.0 or diag.min() < 0.0:
        decisive = False
    if max_diag > 50.0:
        return "VIF_TOO_HIGH", decisive
    return None, decisive


def _exact_s_builder(ds, inc, c, a1_is_alt, preds=(_ADD,), gmul=None):
    """Returns a per-variant callback computing exact f64 X^T X of [c |
    preds] for the borderline-collinearity recheck (`preds` as in
    _variant_design_f64)."""
    def exact_s(vidx):
        X, _ = _variant_design_f64(ds, inc, c, bool(a1_is_alt[vidx]), vidx,
                                   preds, gmul)
        return X.T @ X
    return exact_s


def _collinearity_err_checked(s, nm_i, exact_s_fn):
    """Run the collinearity check on fast (f32-derived) moments; if the
    verdict is within noise of a threshold, recompute from exact f64
    moments."""
    err, decisive = _collinearity_err(s, nm_i)
    if decisive:
        return err
    es = exact_s_fn()
    return _collinearity_err(es, float(es[0, 0]))[0]


def _collinearity_errs_batch(xtx, rows, exact_s_fn):
    """Vectorized collinearity pre-check over a block of variants.

    xtx: [vb, d, d] f64 moments; rows: indices to check.  Clearly-clean
    variants (the overwhelming majority) are screened with one batched
    eigensolve; only threshold-adjacent rows fall back to the per-variant
    checked path.  Returns a list indexed like xtx with errcode or None."""
    out = [None] * xtx.shape[0]
    if len(rows) == 0:
        return out
    k = xtx.shape[1] - 1
    if k < 2:
        return out
    s = xtx[rows]
    nm = s[:, 0, 0]
    sums = s[:, 0, 1:]
    covm = (
        s[:, 1:, 1:] - sums[:, :, None] * sums[:, None, :] / nm[:, None, None]
    ) / (nm - 1.0)[:, None, None]
    var = np.einsum("vii->vi", covm)
    with np.errstate(divide="ignore", invalid="ignore"):
        istd = 1.0 / np.sqrt(var)
        corr = covm * istd[:, :, None] * istd[:, None, :]
    eye = np.eye(k, dtype=bool)
    od = np.abs(np.where(eye[None], 0.0, corr))
    max_od = np.nanmax(od, axis=(1, 2))
    cm = np.where(eye[None], 1.0, corr)
    finite = np.isfinite(cm).all(axis=(1, 2))
    clean = finite & (max_od < 0.99)
    decided = np.zeros(len(rows), bool)
    if clean.any():
        try:
            # symmetric corr matrices: eigh gives the inverse-corr diagonals;
            # non-clean rows still fall back to the exact per-variant path
            wf, vv = np.linalg.eigh(cm[clean])
            wmax = wf.max(axis=1, keepdims=True)
            winv = np.where(wf < wmax * 1e-24, 0.0, 1.0 / wf)
            diag = np.einsum("vij,vj->vi", vv * vv, winv)
            ok = (
                (wf.min(axis=1) >= 1e-9 * wf.max(axis=1))
                & (diag.max(axis=1) <= 40.0)
                & (diag.min(axis=1) >= 0.0)
            )
        except np.linalg.LinAlgError:
            ok = np.zeros(int(clean.sum()), bool)
        decided[clean] = ok
    for j, i in enumerate(rows):
        if not decided[j]:
            out[i] = _collinearity_err_checked(
                xtx[i], nm[j], lambda i=i: exact_s_fn(int(i))
            )
    return out


def _pinv_nolapack(m):
    """plink2 built without LAPACK inverts every matrix via SVD with
    singular values below wmax*1e-24 zeroed (InvertMatrix,
    2.0/plink2_matrix.cc:355) -- merely-singular input does NOT fail, it
    produces a huge-magnitude garbage inverse that downstream validity
    checks may or may not catch.  Returns None only when SVD itself fails."""
    try:
        u, w, vt = np.linalg.svd(m)
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(w).all():
        return None
    winv = np.where(w < w.max() * 1e-24, 0.0, 1.0 / w)
    return (u * winv) @ vt


def _variant_design_f64(ds, inc, c, alt_is_a1, vidx, preds=(_ADD,),
                        gmul=None):
    """Host f64 design matrix [nm, d] for one variant: [c | G_1..G_P] with
    the flip-resolved genotype predictors (name, plane weights when A1 is
    ALT, when A1 is REF[, c column that multiplies it (interaction), 0 for
    none]); haploid variants scale 0.5 like the device kernels, and `gmul`
    (raw-sample genotype multiplier, --xchr-model 1) multiplies each
    sample's predictors."""
    codes = _unpack_np(ds.reader.read_packed(vidx, 1))[0][: ds.raw_sample_ct][inc]
    val = codes != 3
    hp = (codes == 1).astype(np.float64)
    ap = (codes == 2).astype(np.float64)
    vp = val.astype(np.float64)
    scale = float(_hap_scale(ds)[vidx])
    cols = [c]
    for pred in preds:
        wa, wr = pred[1:3]
        w = wa if alt_is_a1 else wr
        g = (w[0] * hp + w[1] * ap + w[2] * vp) * scale
        if gmul is not None:
            g = g * gmul[inc]
        if len(pred) > 3 and pred[3]:
            g = g * c[:, pred[3]]
        cols.append(g[:, None])
    return np.concatenate(cols, axis=1)[val], val


def _logistic_f64(X, yv, offset=None):
    """glm.fit-imitating IRLS in f64, matching LogisticRegressionD
    (2.0/plink2_glm_logistic.cc:2768): init OLS on z = 4.8638...*(y-0.5),
    converge on |dll| < 1e-8*(0.05+|ll|), maxit 25.  `offset` = fixed
    linear-predictor term (cc-residualize; the init OLS ignores it, the eta
    evaluation adds it, as the reference's sample_offsets).  Vectorised
    over the samples (the null-model fit runs at biobank n).  Returns (beta,
    se, hinv, converged, unfinished) or None on failure."""
    z = 4.863891244002886 * (yv - 0.5)
    try:
        b = np.linalg.solve(X.T @ X, X.T @ z)
    except np.linalg.LinAlgError:
        return None
    off = 0.0 if offset is None else offset

    def ll_of(eta):
        with np.errstate(divide="ignore", over="ignore"):
            return float(
                np.where(yv != 0.0, -np.logaddexp(0.0, -eta),
                         -np.logaddexp(0.0, eta)).sum()
            )

    eta = X @ b + off
    ll_old = ll_of(eta)
    if np.isnan(ll_old):
        return None
    conv = unf = False
    h_last = None
    with np.errstate(over="ignore"):
        p = 1.0 / (1.0 + np.exp(-eta))
        for _ in range(1, 25):
            v = p * (1.0 - p)
            h = (X.T * v) @ X
            h_last = h  # reference SE comes from the LAST solve's Cholesky
            # factor (hessian at the pre-update iterate), not a fresh
            # hessian at the final beta (plink2_glm_logistic.cc:4813-4845)
            grad = X.T @ (p - yv)
            try:
                dco = np.linalg.solve(h, grad)
            except np.linalg.LinAlgError:
                return None
            b = b - dco
            eta = X @ b + off
            p = 1.0 / (1.0 + np.exp(-eta))
            ll = ll_of(eta)
            if np.isnan(ll):
                return None
            if abs(ll - ll_old) < 1e-8 * (0.05 + abs(ll)):
                conv = True
                break
            ll_old = ll
        else:
            unf = True
    try:
        hinv = np.linalg.inv(h_last)
    except np.linalg.LinAlgError:
        return None
    se = np.sqrt(np.maximum(np.diag(hinv), 0.0))
    return b, se, hinv, conv, unf


def _firth_f64(X, yv, offset=None):
    """f64 Firth regression matching FirthRegressionD
    (2.0/plink2_glm_logistic.cc:3049, logistf algorithm); see
    ops/glm.py _firth_core for the update equations.  `offset` as in
    _logistic_f64.  Returns (beta, se, hinv2, converged, unfinished) or None
    on failure."""
    d = X.shape[1]
    b = np.zeros(d)
    pll_old = 0.0
    delta_max = 0.0
    conv = fail = False
    off = 0.0 if offset is None else offset

    def parts(b):
        eta = X @ b + off
        with np.errstate(over="ignore"):
            p = 1.0 / (1.0 + np.exp(-eta))
        v = p * (1.0 - p)
        h0 = (X.T * v) @ X
        try:
            u, w, vt = np.linalg.svd(h0)
        except np.linalg.LinAlgError:
            return None
        if not np.isfinite(w).all():
            return None
        winv = np.where(w < w.max() * 1e-24, 0.0, 1.0 / w)
        h0inv = (u * winv) @ vt
        hd = v * ((X @ h0inv) * X).sum(axis=1)  # x_s^T h0inv x_s
        ustar = X.T @ (yv - p + hd * (0.5 - p))
        # dethh = |prod(singular values)| (HalfSymmInvertedDet)
        with np.errstate(divide="ignore"):
            logdet = float(np.log(w).sum())
        ll = np.where(yv != 0.0, -np.logaddexp(0.0, -eta),
                      -np.logaddexp(0.0, eta)).sum()
        return ll + 0.5 * logdet, ustar, hd, v

    unf = False
    hinv2 = None
    it = 0
    while True:
        pr = parts(b)
        if pr is None:
            fail = True
            break
        pll, ustar, hd, v = pr
        if np.isnan(pll):
            fail = True
            break
        if it > 0:
            if (
                delta_max <= 1e-5 and np.max(np.abs(ustar)) < 1e-5
                and (pll - pll_old) < 1e-5
            ):
                conv = True
                break
            if it > 25:  # max_iter
                unf = True
                break
        pll_old = pll
        # reference keeps the INVERTED second-weight hessian from the last
        # executed step as the reported covariance (hh output of
        # FirthRegressionD) -- not recomputed at the final beta
        h2 = (X.T * ((1.0 + hd) * v)) @ X
        hinv2 = _pinv_nolapack(h2)
        if hinv2 is None:
            fail = True
            break
        dbeta = hinv2 @ ustar
        if np.isnan(dbeta).any():
            fail = True
            break
        dmax = float(np.max(np.abs(dbeta)))
        if dmax > 5.0:  # maxstep
            dbeta *= 5.0 / dmax
            dmax = 5.0
        b = b + dbeta
        delta_max = dmax
        it += 1
    if fail or hinv2 is None:
        return None
    se = np.sqrt(np.maximum(np.diag(hinv2), 0.0))
    return b, se, hinv2, conv, unf


def _null_offsets(c, y, cc_resid, always_firth, no_firth):
    """cc-/firth-residualize null-model offsets (plink_tpu _glm_logistic
    :1681-1706; ref FillSampleOffsetsD, 2.0/plink2_glm_logistic.cc:
    3397-3467): the covariates-only logistic fit (cc-residualize, unless
    'firth') and Firth fit (unless 'no-firth'), each in f64 on the host;
    their linear predictors enter every per-variant regression as a fixed
    term.  Returns (logistic offsets or None, Firth offsets or None)."""
    offs_log = offs_fir = None
    if cc_resid and not always_firth:
        r0 = _logistic_f64(c, y)
        if r0 is not None and r0[3] and not r0[4]:
            offs_log = c @ r0[0]
        elif no_firth:
            raise ValueError("--glm cc-residualize: null logistic regression "
                             "failed to converge.")
    if not no_firth:
        rf = _firth_f64(c, y)
        if rf is None or not rf[3]:
            raise ValueError("--glm residualize: null Firth regression failed "
                             "to converge.")
        offs_fir = c @ rf[0]
    return offs_log, offs_fir


def _widen(a, dc, d):
    """Residualized results of width 1 (no intercept / covariates) into the
    full design layout [vb, d] or [vb, d, d] the emit path expects."""
    if a.ndim == 2:
        out = np.zeros((a.shape[0], d))
        out[:, dc:] = a
    else:
        out = np.zeros((a.shape[0], d, d))
        out[:, dc:, dc:] = a
    return out


def _glm_logistic(
    ds, cfg, log, pheno_name, ydata, smask, cov_names, cov_data, a1_is_alt,
    hide_covar, always_firth, no_firth, vmask=None, sink=None,
    header_out=None, gmul=None, add_results=None, perm_capture=None,
):
    """One logistic/Firth pass over `vmask` (default: all included variants)
    for one sample / covariate set.  Writes <out>.<pheno>.<suffix>, or with
    `sink` appends per-variant row strings to it and the header to
    `header_out` (the per-ploidy passes share one report).

    The design is [1 | covariates | G_1..G_P]: the model's genotype
    predictors (one, or two for genotypic / hethom), then under
    'interaction' each of them times each covariate (K15 / K16 then carry
    those columns' covariate factor).  cc-/firth-residualize fit the
    residualized design (K3, dc = 0, d = P) with the null model's linear
    predictor as offset; `gmul` (raw-sample genotype multiplier,
    --xchr-model 1) runs the kernels in their scaled modes and K14 for the
    allele-observation counts.  A joint model (GENO_2DF) adds the Wald test
    of its P main effects.  `add_results` and `perm_capture` as in
    _glm_linear."""
    from ..ops.glm import (firth_irls_block, glm_logistic_scan,
                           glm_resid_scan, resid_irls_block, xm1_stats_scan)

    mods = set(cfg.glm_modifiers)
    resid = "cc-residualize" in mods or "firth-residualize" in mods
    single_prec = "single-prec-cc" in mods
    dev = ds.device
    geno_preds, joint_name = _geno_predictors(mods)
    n_main = len(geno_preds)
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float64)  # 0 = control, 1 = case
    dc = len(cov_names) + 1
    # kernel genotype predictors: the main effects, then the G x C
    # interactions; each is (name, plane weights for A1 = ALT, for A1 = REF,
    # covariate column that multiplies it).  Design [1 | covariates | G_1..G_P]
    kern_preds = [(nm_, wa, wr, 0) for nm_, wa, wr in geno_preds]
    if "interaction" in mods:
        kern_preds += [(f"{nm_}x{cn}", wa, wr, j + 1) for nm_, wa, wr in geno_preds
                       for j, cn in enumerate(cov_names)]
    P = len(kern_preds)
    covj = tuple(sp[3] for sp in kern_preds)
    d = dc + P
    c = np.concatenate([np.ones((n, 1)), cov_data[inc]], axis=1)
    vb = _auto_vb(-(-n // 4) * 4)
    mark = _phase_timer(log)
    offs_log = offs_fir = None
    if resid:
        offs_log, offs_fir = _null_offsets(c, y, "cc-residualize" in mods,
                                           always_firth, no_firth)
        mark("null model fits")
    exact_s_fn = _exact_s_builder(ds, inc, c, a1_is_alt, kern_preds, gmul)
    if vmask is None:
        vmask = ds.variant_mask
    standalone = sink is None
    if standalone:
        sink = []
    pd = PackedDevice(ds, vmask, vb=vb, sample_mask=smask)
    npad = pd.npad
    feat = np.zeros((npad, dc + 2), np.float32)  # [c | y | mask]
    feat[:n, :dc] = c
    feat[:n, dc] = y
    feat[:n, dc + 1] = 1.0
    feat_d = torch.from_numpy(feat).to(dev)

    def padded(v, fill=0.0):  # per-included-sample f32 [n] -> [npad] on dev
        a = np.full(npad, fill, np.float32)
        a[:n] = v
        return torch.from_numpy(a).to(dev)

    sscale_d = None if gmul is None else padded(gmul[inc], 1.0)

    M = ds.raw_variant_ct
    chrom, provref, a1, omitted = _row_meta(ds, a1_is_alt)
    vi = ds.vi
    suffix = "glm.firth" if always_firth else (
        "glm.logistic" if no_firth else "glm.logistic.hybrid"
    )
    firth_col = not always_firth and not no_firth
    log10 = "log10" in mods
    p_col = "NEG_LOG10_P" if log10 else "P"
    stat_col = "Z_OR_F_STAT" if joint_name else "Z_STAT"
    header = (
        "#CHROM\tPOS\tID\tREF\tALT\tPROVISIONAL_REF?\tA1\tOMITTED\tA1_FREQ\t"
        + ("FIRTH?\t" if firth_col else "")
        + f"TEST\tOBS_CT\tOR\tLOG(OR)_SE\t{stat_col}\t{p_col}\tERRCODE\n"
    )
    if header_out is not None:
        header_out.append(header)
    # report order: INTERCEPT, main effects, covariates, interactions, joint
    tests = ["INTERCEPT"] if "intercept" in mods else []
    tests += [sp[0] for sp in kern_preds[:n_main]]
    if not hide_covar:
        tests += list(cov_names)
    tests += [sp[0] for sp in kern_preds[n_main:]]
    if joint_name:
        tests.append(joint_name)
    test_pred = {"INTERCEPT": 0}
    for p_, sp in enumerate(kern_preds):
        test_pred[sp[0]] = dc + p_
    for j, cn in enumerate(cov_names):
        test_pred[cn] = 1 + j

    # plane weights of every block: the model's predictors [nb, vb, P, 3],
    # and (moments pass) an always-additive copy for the A1-dosage
    # separation/const statistics
    alt_pad_all = np.zeros(pd.nblocks * pd.vb, bool)
    alt_pad_all[:M] = a1_is_alt
    alt_b = alt_pad_all.reshape(pd.nblocks, pd.vb)
    w_alt = np.array([sp[1] for sp in kern_preds], np.float32)  # [P, 3]
    w_ref = np.array([sp[2] for sp in kern_preds], np.float32)
    w_add = np.where(alt_b[:, :, None], np.array(_ADD[1], np.float32),
                     np.array(_ADD[2], np.float32))  # [nb, vb, 3]
    # haploid genotype coding is 0..1 (dosage halved; z/p invariant, OR/SE
    # match the reference's per-copy scale)
    hs_pad = np.ones(pd.nblocks * pd.vb, np.float32)
    hs_pad[:M] = _hap_scale(ds)
    gw_all = (np.where(alt_b[:, :, None, None], w_alt, w_ref)
              * hs_pad.reshape(pd.nblocks, pd.vb)[:, :, None, None])
    gwm_all = np.concatenate([gw_all, w_add[:, :, None, :]], axis=2)
    gw_d = torch.from_numpy(np.ascontiguousarray(gw_all)).to(dev)
    gwm_d = torch.from_numpy(np.ascontiguousarray(gwm_all)).to(dev)
    mark("pack+upload")
    # the residualized scan is Firth under 'firth', or in the hybrid whose
    # null logistic fit failed (plink2 then drops the logistic offsets and
    # every variant takes the Firth path)
    resid_firth_scan = resid and (always_firth or offs_log is None)
    if resid:
        outs = glm_resid_scan(
            pd.packed, gw_d, gwm_d, feat_d,
            padded(offs_fir if resid_firth_scan else offs_log),
            firth=resid_firth_scan, sscale=sscale_d)
    else:
        outs = glm_logistic_scan(pd.packed, gw_d, gwm_d, feat_d,
                                 firth=always_firth, sscale=sscale_d, covj=covj)
    (momy_d, mstats_d, screen_d, beta_d, se_d, conv_d, fail_d, unf_d,
     obs_d, invalid_d, hinv_d) = outs
    # fetch the small per-variant results; the moments stay on the device
    # and a block's slice is fetched only for screen-flagged rows
    mstats_all = mstats_d.cpu().numpy().astype(np.float64)
    screen_all = screen_d.cpu().numpy()
    beta_all = beta_d.cpu().numpy().astype(np.float64)
    se_all = se_d.cpu().numpy().astype(np.float64)
    conv_all = conv_d.cpu().numpy()
    fail_all = fail_d.cpu().numpy()
    unf_all = unf_d.cpu().numpy()
    obs_all = obs_d.cpu().numpy()
    invalid_all = invalid_d.cpu().numpy()
    # the joint test reads the covariance of every row
    hinv_all = hinv_d.cpu().numpy().astype(np.float64) if joint_name else None
    if resid:
        beta_all = np.stack([_widen(b_, dc, d) for b_ in beta_all])
        se_all = np.stack([_widen(s_, dc, d) for s_ in se_all])
        if joint_name:
            hinv_all = np.stack([_widen(h_, dc, d) for h_ in hinv_all])
    xm1 = None
    if gmul is not None:
        # --xchr-model 1 allele observations (K14): allele_obs = 2 sum(s),
        # case_allele_obs = 2 sum(s y) over valid samples (ref
        # allele_obs_ct -= nm_male_ct, plink2_glm_logistic.cc:4438-4440),
        # plus the het / hom counts of the raw-genocount const-allele rule
        w2 = np.zeros((npad, 2), np.float32)
        w2[:n, 0] = gmul[inc]
        w2[:n, 1] = gmul[inc] * y
        xm1 = tuple(x.cpu().numpy().astype(np.float64) for x in xm1_stats_scan(
            pd.packed, torch.from_numpy(w2).to(dev), feat_d[:, dc + 1].contiguous()))
    mark("device scan+fetch")

    def _invalid_rows(hf, rows):
        """Host recomputation of the validParameters() check for rows whose
        covariance was replaced after the device pass (diagonal only for
        the residualized fit, as on the device)."""
        out = np.zeros(len(rows), bool)
        for k_, i in enumerate(rows):
            h = hf[i][dc:, dc:] if resid else hf[i]
            dg = np.diag(h)
            with np.errstate(invalid="ignore"):
                if resid:
                    out[k_] = bool(((dg < 1e-20) | ~np.isfinite(dg)).any())
                    continue
                if ((dg[1:] < 1e-20) | ~np.isfinite(dg[1:])).any():
                    out[k_] = True
                    continue
                sd = np.sqrt(dg)
                for i_ in range(1, d):
                    for j_ in range(i_):
                        if h[i_, j_] > 0.99999 * sd[i_] * sd[j_]:
                            out[k_] = True
        return out

    keep_cols = list(range(dc)) + list(range(dc + 1, dc + 1 + P))
    # small panels: every row of a joint model is refitted in f64 on the
    # host, so the joint Wald statistic comes from the reference's
    # double-precision fit (plink_tpu _glm_logistic :2009-2014)
    refit_all = bool(joint_name) and n <= 65536
    for bi in range(pd.nblocks):
        v0 = bi * pd.vb
        vct = min(pd.vb, M - v0)
        ia = np.array([i for i in range(vct) if vmask[v0 + i]])
        if ia.size == 0:
            continue
        # kernel layout of the moments: [c (dc) | y | ADD model pred | ADD]
        ms = mstats_all[bi]
        g_tot, g_ssq, g_case = ms[:, 0], ms[:, 1], ms[:, 2]
        nm_pre, nc_pre = ms[:, 3], ms[:, 4]
        check_rows = np.array(
            [i for i in ia if nm_pre[i] > d and not screen_all[bi][i]],
            dtype=int)
        if check_rows.size:
            momy = momy_d[bi].cpu().numpy().astype(np.float64)
            xtx = momy[np.ix_(range(pd.vb), keep_cols, keep_cols)]
            pre_err = _collinearity_errs_batch(
                xtx, check_rows, lambda i: exact_s_fn(int(v0 + i))
            )
        else:
            pre_err = [None] * pd.vb
        in_block = np.zeros(pd.vb, bool)
        in_block[ia] = True
        pre_bad = np.array([e is not None for e in pre_err])
        obs = obs_all[bi]
        obs_f = obs.astype(np.float64)

        mac = np.minimum(g_tot, 2.0 * obs_f - g_tot)

        def _extreme(beta_a, se_a, conv_a, fail_a, unf_a, base):
            # rows whose f32 trajectory may diverge from the reference's f64
            # LogisticRegressionD/FirthRegressionD: quasi-separated fits
            # (huge |beta| or SE on the genotype predictor), non-converged
            # rows, and low minor-count rows, whose f32 SE noise exceeds
            # the 1e-3 parity budget
            with np.errstate(invalid="ignore"):
                bm = np.abs(beta_a[:, dc:]).max(axis=1)
                sm = se_a[:, dc:].max(axis=1)
            ext = (bm > 5.0) | (sm > 5.0) | (mac < 30.0) | fail_a | unf_a | ~conv_a
            return ext & base & ~pre_bad

        refined = np.zeros(pd.vb, bool)
        hfull = hinv_all[bi].copy() if joint_name else np.zeros((pd.vb, d, d))

        def _refine(rows, firth_mode, beta_a, se_a, hfull_a, conv_a, fail_a,
                    unf_a):
            if single_prec:
                # 'single-prec-cc': the f32 device results are the answer
                # (ref selects the float32 GlmLogisticThreadF path,
                # 2.0/plink2_glm_logistic.cc:5306); no f64 refinement
                return
            fit = _firth_f64 if firth_mode else _logistic_f64
            for i in rows:
                vidx = v0 + i
                X, val = _variant_design_f64(
                    ds, inc, c, bool(a1_is_alt[vidx]), vidx, kern_preds, gmul)
                if resid:
                    Xg = X[:, dc:] - X[:, dc:].mean(axis=0)
                    offv = (offs_fir if firth_mode else offs_log)[val]
                    res = fit(Xg, y[val], offset=offv)
                else:
                    res = fit(X, y[val])
                refined[i] = True
                if res is None:
                    conv_a[i], fail_a[i], unf_a[i] = False, True, False
                    continue
                b_, se_, hinv_, cv_, un_ = res
                if resid:
                    beta_a[i, dc:], se_a[i, dc:] = b_, se_
                    hfull_a[i][dc:, dc:] = hinv_
                else:
                    beta_a[i], se_a[i], hfull_a[i] = b_, se_, hinv_
                conv_a[i], fail_a[i], unf_a[i] = cv_, False, un_

        beta = beta_all[bi].copy()
        se = se_all[bi].copy()
        conv = conv_all[bi].copy()
        fail = fail_all[bi].copy()
        unf = unf_all[bi].copy()
        if xm1 is not None:
            # --xchr-model 1: the reference's allele observations and
            # raw-genocount const rule
            aobs, caobs = 2.0 * xm1[0][bi], 2.0 * xm1[1][bi]
            hct, act = xm1[2][bi], xm1[3][bi]
            const = (hct == obs_f) | (act == obs_f) | ((hct == 0.0) & (act == 0.0))
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                const = (g_ssq - g_tot * g_tot / np.maximum(obs, 1)) <= 1e-12
        sep_allele = None
        if always_firth or resid_firth_scan:
            used_firth = np.ones(pd.vb, bool)
            rows = np.flatnonzero(_extreme(beta, se, conv, fail, unf,
                                           in_block & ~const))
            _refine(rows, True, beta, se, hfull, conv, fail, unf)
            if refit_all:
                extra = in_block & ~const & ~pre_bad & ~refined & ~fail
                _refine(np.flatnonzero(extra), True, beta, se, hfull, conv,
                        fail, unf)
        else:
            # separation pre-check over BOTH alleles, REF first (ref loop
            # "Does any genotype column have zero case or zero control
            # dosage?", plink2_glm_logistic.cc:2224-2236); the reference
            # reports the separating allele in the errcode
            if xm1 is not None:
                tot_aobs, tot_caobs = aobs, caobs
            else:
                fac_ = 2.0 * hs_pad.reshape(pd.nblocks, pd.vb)[bi]
                tot_aobs, tot_caobs = fac_ * obs, fac_ * nc_pre
            altm = alt_b[bi]
            alt_case = np.where(altm, g_case, tot_caobs - g_case)
            alt_tot = np.where(altm, g_tot, tot_aobs - g_tot)
            ref_case = tot_caobs - alt_case
            ref_tot = tot_aobs - alt_tot
            sep_refb = (ref_case == 0.0) | (ref_case == ref_tot)
            sep_altb = (alt_case == 0.0) | (alt_case == alt_tot)
            sep = (sep_refb | sep_altb) & ~const
            sep_allele = np.where(sep_refb, 0, np.where(sep_altb, 1, -1))
            sep_allele = np.where(sep, sep_allele, -1)
            used_firth = np.zeros(pd.vb, bool)
            rows = np.flatnonzero(
                _extreme(beta, se, conv, fail, unf, in_block & ~const & ~sep)
            )
            _refine(rows, False, beta, se, hfull, conv, fail, unf)
            if refit_all:
                extra = in_block & ~const & ~pre_bad & ~refined & ~fail & ~sep
                _refine(np.flatnonzero(extra), False, beta, se, hfull, conv,
                        fail, unf)
            if no_firth:
                fail = fail | sep  # SEPARATION errcode path
            else:
                need_firth = (sep | fail) & ~const & in_block
                if need_firth.any():
                    need_d = torch.from_numpy(need_firth).to(dev)
                    if resid:
                        fb, fse, _, fconv, ffail, funf, _fobs, fhfull = (
                            x.cpu().numpy() for x in resid_irls_block(
                                pd.packed[bi], gw_d[bi], feat_d,
                                padded(offs_fir), need_d, sscale_d))
                        fb, fse = _widen(fb, dc, d), _widen(fse, dc, d)
                        fhfull = _widen(fhfull, dc, d)
                    else:
                        fb, fse, _, fconv, ffail, funf, _fobs, fhfull = (
                            x.cpu().numpy() for x in firth_irls_block(
                                pd.packed[bi], gw_d[bi], feat_d, need_d,
                                sscale_d, covj))
                    fb = fb.astype(np.float64)
                    fse = fse.astype(np.float64)
                    fhfull = fhfull.astype(np.float64)
                    fconv, ffail, funf = fconv.copy(), ffail.copy(), funf.copy()
                    fext = _extreme(fb, fse, fconv, ffail, funf, need_firth)
                    if refit_all:
                        fext |= need_firth & ~pre_bad
                    _refine(np.flatnonzero(fext), True, fb, fse, fhfull,
                            fconv, ffail, funf)
                    m = need_firth
                    beta[m], se[m], hfull[m] = fb[m], fse[m], fhfull[m]
                    conv[m], fail[m], unf[m] = fconv[m], ffail[m], funf[m]
                    used_firth = need_firth
                    refined[m] = True  # invalid flags recomputed from fhfull

        # validParameters() flags: device pass for unchanged rows; host
        # recomputation for rows refined or replaced above
        invalid = invalid_all[bi].copy()
        rr = np.flatnonzero(refined)
        if rr.size:
            invalid[rr] = _invalid_rows(hfull, rr)
        fstat, logp_joint = _joint_wald(beta, hfull, conv & ~fail & ~const
                                        & ~invalid, dc, n_main, obs) \
            if joint_name else (None, None)
        with np.errstate(divide="ignore", invalid="ignore"):
            # A1_FREQ = A1 dosage / allele observations; under --xchr-model
            # 1 with the male-adjusted denominator (ref line 5753)
            denom = aobs if xm1 is not None else 2 * np.maximum(obs, 1)
            a1f = np.where(obs > 0, g_tot / np.maximum(denom, 1e-300), np.nan)
        _emit_logistic_rows(
            sink, v0, ia, beta, se, fail, unf, obs, a1f, const, used_firth,
            firth_col, tests, test_pred, chrom, provref, a1, omitted, vi, d,
            no_firth, pre_err, invalid, log10, sep_allele, joint_name, fstat,
            logp_joint, add_results, perm_capture,
        )
    mark("host postprocess+emit")
    if standalone:
        _write_sink(f"{cfg.out}.{pheno_name}.{suffix}", header, sink, log)


def _joint_wald(beta, hfull, ok, dc, n_main, obs):
    """Joint Wald test of the P main genotype effects (plink_tpu
    _glm_logistic :2112-2133; ref the constraint set of plink2_glm.cc:2867,
    LinearHypothesisChisq + FstatToLnP(chisq / q, q, sample_obs_ct)):
    F = b^T Sigma^-1 b / q over the rows in `ok`, Sigma inverted as plink2
    without LAPACK does (_pinv_nolapack).  Returns (F, ln p), NaN
    elsewhere."""
    fstat = np.full(beta.shape[0], np.nan)
    logp = np.full(beta.shape[0], np.nan)
    bm = beta[:, dc : dc + n_main]
    cov_m = hfull[:, dc : dc + n_main, dc : dc + n_main]
    for i in np.flatnonzero(ok):
        ci = _pinv_nolapack(cov_m[i])
        if ci is None:
            continue
        w_ = float(bm[i] @ ci @ bm[i])
        if w_ >= 0:
            fstat[i] = w_ / n_main
    okf = np.isfinite(fstat)
    if okf.any():
        logp[okf] = np.asarray(f_logsf(fstat[okf], float(n_main),
                                       obs[okf].astype(np.float64)))
    return fstat, logp


def _emit_logistic_rows(
    sink, v0, ia, beta, se, fail, unf, obs, a1f, const, used_firth,
    firth_col, tests, test_pred, chrom, provref, a1, omitted, vi, d, no_firth,
    pre_err, invalid, log10, sep_allele, joint_name=None, fstat=None,
    logp_joint=None, add_results=None, perm_capture=None,
):
    with np.errstate(divide="ignore", invalid="ignore"):
        zstat = np.where(se > 0, beta / se, np.nan)
    # ln p only for columns that reach the report (hide-covar emits 1-2 of
    # ~14 design columns; the host continued fraction is not free)
    need_cols = sorted({test_pred[t] for t in tests if t != joint_name})
    logp = np.full_like(zstat, np.nan)
    logp[:, need_cols] = np.asarray(
        zstat_logp_2sided(np.nan_to_num(zstat[:, need_cols])))
    # --adjust's test and the permutation test's single effect
    add_test = next(
        (t for t in tests if t in ("ADD", "DOM", "REC", "HET", "HOM")), None)
    for i in ia:
        lines = []
        vidx = v0 + i
        nm_i = int(obs[i])
        meta = (
            f"{chrom[vidx]}\t{vi.pos[vidx]}\t{vi.vid[vidx]}\t{vi.ref[vidx]}\t"
            f"{vi.alt[vidx]}\t{provref[vidx]}\t{a1[vidx]}\t{omitted[vidx]}\t"
            f"{g6(a1f[i])}"
        )
        firth_str = ("Y" if used_firth[i] else "N") if firth_col else None
        errcode = ERR_OK
        bad = False
        if const[i]:
            errcode, bad = "CONST_OMITTED_ALLELE", True
            firth_str = "N" if firth_col else None
        elif nm_i <= d:
            errcode, bad = "SAMPLE_CT<=PREDICTOR_CT", True
        elif pre_err[i] is not None:
            errcode, bad = pre_err[i], True
            firth_str = "N" if firth_col else None
        elif fail[i]:
            bad = True
            if no_firth and sep_allele is not None:
                if sep_allele[i] >= 0:
                    # ref AppendGlmErrstr names the separating allele
                    # (2.0/plink2_glm_shared.cc:36-48)
                    errcode = "SEPARATION," + (
                        "REF" if sep_allele[i] == 0 else f"ALT{sep_allele[i]}"
                    )
                else:
                    errcode = "LOGISTIC_CONVERGE_FAIL"
            elif used_firth[i]:
                errcode = "FIRTH_CONVERGE_FAIL"
            else:
                errcode = "LOGISTIC_CONVERGE_FAIL"
        elif invalid[i]:
            errcode, bad = "INVALID_RESULT", True
        ok_err = "UNFINISHED" if unf[i] else ERR_OK
        if (add_results is not None and not bad and add_test is not None
                and np.isfinite(logp[i, test_pred[add_test]])):
            add_results.append((vidx, float(logp[i, test_pred[add_test]])))
        if perm_capture is not None and joint_name is not None:
            # constraint models permute on the joint Wald chisq / q; its
            # ln p (with the variant's obs) is taken on the host for EMP2
            if not bad and np.isfinite(fstat[i]) and np.isfinite(logp_joint[i]):
                perm_capture["valid"][vidx] = True
                perm_capture["t"][vidx] = fstat[i]
                perm_capture["lnp"][vidx] = logp_joint[i]
                perm_capture["dof"][vidx] = nm_i
        elif perm_capture is not None and add_test is not None:
            pi_ = test_pred[add_test]
            if (not bad and np.isfinite(beta[i, pi_]) and np.isfinite(se[i, pi_])
                    and se[i, pi_] > 0):
                perm_capture["valid"][vidx] = True
                perm_capture["t"][vidx] = abs(beta[i, pi_] / se[i, pi_])
                perm_capture["lnp"][vidx] = logp[i, pi_]
        fcol = f"{firth_str}\t" if firth_col else ""
        for tname in tests:
            if tname == joint_name:
                if bad or not np.isfinite(fstat[i]):
                    ec = errcode if bad else "INVALID_RESULT"
                    lines.append(
                        f"{meta}\t{fcol}{tname}\t{nm_i}\tNA\tNA\tNA\tNA\t{ec}\n")
                else:
                    lines.append(
                        f"{meta}\t{fcol}{tname}\t{nm_i}\tNA\tNA\t{g6(fstat[i])}\t"
                        f"{_p_str(logp_joint[i], log10)}\t{ok_err}\n")
                continue
            pi = test_pred[tname]
            if bad or not np.isfinite(beta[i, pi]) or not np.isfinite(se[i, pi]):
                ec = errcode if bad else "INVALID_RESULT"
                lines.append(
                    f"{meta}\t{fcol}{tname}\t{nm_i}\tNA\tNA\tNA\tNA\t{ec}\n"
                )
            else:
                lines.append(
                    f"{meta}\t{fcol}{tname}\t{nm_i}\t"
                    f"{g6(np.exp(np.float64(beta[i, pi])))}\t{g6(se[i, pi])}\t"
                    f"{g6(zstat[i, pi])}\t{_p_str(logp[i, pi], log10)}\t{ok_err}\n"
                )
        sink.append((int(vidx), "".join(lines)))

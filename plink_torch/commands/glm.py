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

The device passes are ops/glm.py: kernels K2-K4 (logistic) and K6 (the
linear plane sums, solved per variant in f64 on the host); the A1 choice
counts with K1.  Rows the f32 device fit cannot resolve to reference
precision are refitted per variant in f64 on the host, as in plink_tpu.

Not yet ported (each raises NotPortedError): dosage, --xchr-model 0/1, and
every --glm modifier except the hybrid default, firth, no-firth, hide-covar,
intercept, log10 and omit-ref.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from .. import NotPortedError
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


# modifiers this port runs; the hybrid default may also be named
# explicitly ('firth-fallback')
_GLM_PORTED_MODS = {"hide-covar", "firth", "no-firth", "firth-fallback",
                    "intercept", "log10", "omit-ref"}
# the rest of what plink_tpu's --glm accepts
_GLM_REFERENCE_MODS = {
    "genotypic", "hethom", "dominant", "recessive", "hetonly", "interaction",
    "sex", "allow-no-covars", "aperm", "pheno-ids", "cc-residualize",
    "firth-residualize", "qt-residualize", "single-prec-cc",
    "permute-qt-residuals", "perm-count", "no-x-sex", "skip-invalid-pheno",
}
_GLM_KNOWN_UNSUPPORTED_MODS = {
    "zs", "local-omit-last", "local-haps", "local-cats",
}


def _hap_scale(ds) -> np.ndarray:
    """Per-variant genotype-predictor scale: 0.5 on haploid chromosomes
    other than chrX (the reference codes haploid dosages 0..1 --
    GetGenoDosages haploid halving)."""
    hap = ds.is_haploid_all() & (ds.vi.chrom != X_CODE)
    return np.where(hap, 0.5, 1.0).astype(np.float32)


def _ploidy_groups(ds, cfg, smask, cov_names, cov_data, log):
    """Split the GLM into per-ploidy passes (plink_tpu _ploidy_groups; ref
    GlmMain's chrX/chrY sample-set and covariate switching,
    2.0/plink2_glm.cc:2502-2640, 3154-3240), for --xchr-model 2:

    - chrX: SEX is auto-added as a covariate unless the samples are
      single-sex or all-female panels make X fully diploid; samples with
      unknown sex drop out;
    - chrY: restricted to nonfemales; skipped when all samples are female.

    Returns None when a single pass suffices, else a list of
    (vmask_g, smask_g, cov_names_g, cov_data_g)."""
    chrom = ds.vi.chrom
    vmask = ds.variant_mask
    is_x = chrom == X_CODE
    is_y = chrom == Y_CODE
    has_x = bool((vmask & is_x).any())
    has_y = bool((vmask & is_y).any())
    if not has_x and not has_y:
        return None
    if cfg.xchr_model != 2:
        raise NotPortedError("--glm with --xchr-model 0/1 is not yet ported to "
                             "plink_torch.")
    sex = ds.si.sex
    male_ct = int((smask & (sex == 1)).sum())
    sexnm_ct = int((smask & (sex != 0)).sum())
    n_inc = int(smask.sum())
    x_fully_diploid = (male_ct == 0) and (sexnm_ct == n_inc)
    add_sex = has_x and male_ct > 0 and male_ct != sexnm_ct \
        and not x_fully_diploid
    nonfemale = smask & (sex != 2)
    nonfemale_ct = int(nonfemale.sum())

    main_mask = vmask & ~is_x & ~is_y
    groups = []
    # chrX merges into the main pass when its sample/covariate sets match
    if has_x:
        if not add_sex:
            main_mask = main_mask | (vmask & is_x)
        else:
            smask_x = smask & (sex != 0)
            names_x = list(cov_names) + ["SEX"]
            data_x = np.concatenate(
                [cov_data, sex.astype(np.float64)[:, None]], axis=1)
            groups.append((vmask & is_x, smask_x, names_x, data_x))
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


def run_glm(ds: Dataset, cfg, log: RunLogger) -> None:
    mods = set(cfg.glm_modifiers)
    # modifier validation mirrors the reference's parse errors
    # (2.0/plink2.cc --glm parsing: "Invalid --glm argument" /
    # "Conflicting --glm arguments")
    for m_ in sorted(mods):
        if m_ in _GLM_PORTED_MODS:
            continue
        if m_ in _GLM_REFERENCE_MODS or m_.startswith(
                ("cols=", "mperm=", "local-covar=", "local-psam=",
                 "local-pvar=")):
            raise NotPortedError(
                f"--glm modifier '{m_}' is not yet ported to plink_torch.")
        if m_ in _GLM_KNOWN_UNSUPPORTED_MODS or m_.startswith("local-"):
            raise ValueError(f"--glm modifier '{m_}' is not supported yet.")
        raise ValueError(f"Invalid --glm argument '{m_}'.")
    if "firth" in mods and "no-firth" in mods:
        raise ValueError("Conflicting --glm arguments.")
    hide_covar = "hide-covar" in mods
    omit_ref = "omit-ref" in mods
    always_firth = "firth" in mods
    no_firth = "no-firth" in mods

    if ds.has_dosage:
        raise NotPortedError("--glm on dosage data is not yet ported to "
                             "plink_torch.")
    mark = _phase_timer(log)
    cov_names, cov_data, cov_nonmiss = _load_covars(ds, cfg, log)
    phenos = _load_phenos(ds, cfg, log)
    if not phenos:
        raise ValueError("--glm: no phenotypes loaded")
    mark("covariates+phenotypes")

    # A1 selection (minor allele unless omit-ref)
    freqs = alt_allele_freqs(ds, founders_only=not cfg.nonfounders)
    a1_is_alt = np.ones(ds.raw_variant_ct, bool) if omit_ref else ~(freqs > 0.5)
    mark("A1 counts")
    if not cov_names:
        raise ValueError(
            "--glm: no covariates loaded; use 'allow-no-covars' to allow this"
        )

    suffix = "glm.firth" if always_firth else (
        "glm.logistic" if no_firth else "glm.logistic.hybrid")
    for name, kind, ydata, ynonmiss in phenos:
        if kind == "cat":
            log.log(f"--glm: skipping categorical phenotype '{name}'.")
            continue
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
        if kind == "cc":
            case_ct = int(ydata[smask].sum())
            log.log(
                f"--glm {'Firth' if always_firth else 'logistic'} regression on "
                f"phenotype '{name}': {case_ct} cases, {nm_ct - case_ct} controls."
            )
            report = f"{cfg.out}.{name}.{suffix}"
            fit = partial(_glm_logistic, ds, cfg, log, name, ydata,
                          a1_is_alt=a1_is_alt, hide_covar=hide_covar,
                          always_firth=always_firth, no_firth=no_firth)
        else:
            log.log(f"--glm linear regression on phenotype '{name}': {nm_ct} samples.")
            report = f"{cfg.out}.{name}.glm.linear"
            fit = partial(_glm_linear, ds, cfg, log, name, ydata,
                          a1_is_alt=a1_is_alt, hide_covar=hide_covar)
        # fit(sample mask, covariate names, covariate data, **pass options)
        groups = _ploidy_groups(ds, cfg, smask, p_names, p_data, log)
        if groups is None:
            fit(smask, p_names, p_data)
            continue
        sink: list = []
        hdr_box: list = []
        for vm_g, sm_g, nm_g, dt_g in groups:
            if not vm_g.any() or not sm_g.any():
                continue
            nm_g, dt_g = _drop_const_covars(sm_g, nm_g, dt_g)
            fit(sm_g, nm_g, dt_g, vmask=vm_g, sink=sink, header_out=hdr_box)
        _write_sink(report, hdr_box[0], sink, log)


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
    hide_covar, vmask=None, sink=None, header_out=None,
):
    """Runs one linear-GLM pass over `vmask` (default: all included
    variants) for one sample set / covariate set.  Writes
    <out>.<pheno>.glm.linear, or with `sink` appends per-variant row strings
    to it and the header to `header_out` (the per-ploidy passes share one
    report; ref: GlmMain's per-chromosome sample/covariate switching,
    2.0/plink2_glm.cc:3154-3240).

    K6 gives every variant's plane sums in one pass per block; X^T X, X^T y
    and y^T y of any model are their linear combinations with the
    sample-set totals (the role RegressionNmPrecomp plays in the
    reference), solved per variant in f64 on the host."""
    from ..ops.glm import linear_sums_scan

    mods = set(cfg.glm_modifiers)
    geno_preds, joint_name = _geno_predictors(mods)
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float64)
    dc = len(cov_names) + 1
    vb = _auto_vb(-(-n // 4) * 4)
    c = np.concatenate([np.ones((n, 1)), cov_data[inc]], axis=1)

    # predictors: const, genotype predictors, covariates; each is (name,
    # plane weights (wH, wA, wV) when A1 is ALT, when A1 is REF, c column)
    pred_specs = [("CONST", (0, 0, 1), (0, 0, 1), 0)]
    pred_specs += [(nm_, wa, wr, 0) for nm_, wa, wr in geno_preds]
    pred_specs += [(cn, (0, 0, 1), (0, 0, 1), j + 1)
                   for j, cn in enumerate(cov_names)]
    d = len(pred_specs)
    geno_idx = list(range(1, 1 + len(geno_preds)))
    tests = [s_[0] for s_ in pred_specs[1:]]
    if hide_covar:
        tests = [t for t in tests if t not in cov_names]
    if joint_name:
        tests = tests + [joint_name]
    if "intercept" in mods:
        tests = ["INTERCEPT"] + tests
    log10 = "log10" in mods
    exact_s_fn = _exact_s_builder(ds, inc, c, a1_is_alt, geno_preds)

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
    sums_all = {k: v.cpu().numpy().astype(np.float64)
                for k, v in linear_sums_scan(pd.packed, ccfl, cy32, y232).items()}
    mark("device scan+fetch")
    hs_all = _hap_scale(ds).astype(np.float64)
    for bi in range(pd.nblocks):
        v0 = bi * pd.vb
        vct = min(pd.vb, M - v0)
        ia = np.flatnonzero(vmask[v0 : v0 + vct])
        if ia.size == 0:
            continue
        b = len(ia)
        hcc = sums_all["hcc"][bi][ia].reshape(b, dc, dc)
        acc = sums_all["acc"][bi][ia].reshape(b, dc, dc)
        vcc = ctc_full[None] - sums_all["mcc"][bi][ia].reshape(b, dc, dc)
        hcy = sums_all["hcy"][bi][ia]
        acy = sums_all["acy"][bi][ia]
        vcy = cty_full[None] - sums_all["mcy"][bi][ia]
        yy_v = yy_full - sums_all["myy"][bi][ia]
        nm = vcc[:, 0, 0]
        flip = ~a1_is_alt[v0 + ia]

        def cross(w1, w2, j1, j2):
            # plane products collapse: H*H = H, H*V = H, A*V = A, H*A = 0
            h1, a1_, v1 = w1
            h2, a2_, v2 = w2
            coef_h = h1 * h2 + h1 * v2 + v1 * h2
            coef_a = a1_ * a2_ + a1_ * v2 + v1 * a2_
            coef_v = v1 * v2
            return (coef_h * hcc[:, j1, j2] + coef_a * acc[:, j1, j2]
                    + coef_v * vcc[:, j1, j2])

        def xy(w, j):
            h, a_, v = w
            return h * hcy[:, j] + a_ * acy[:, j] + v * vcy[:, j]

        xtx = np.zeros((b, d, d))
        xty = np.zeros((b, d))
        for p in range(d):
            _, wa1, wr1, j1 = pred_specs[p]
            for q in range(p, d):
                _, wa2, wr2, j2 = pred_specs[q]
                val = np.where(flip, cross(wr1, wr2, j1, j2),
                               cross(wa1, wa2, j1, j2))
                xtx[:, p, q] = val
                xtx[:, q, p] = val
            xty[:, p] = np.where(flip, xy(wr1, j1), xy(wa1, j1))

        # A1 dosage sums for A1_FREQ / const-allele detection
        g1 = np.where(flip, cross((-1, -2, 2), (0, 0, 1), 0, 0),
                      cross((1, 2, 0), (0, 0, 1), 0, 0))
        gg1 = np.where(flip, cross((-1, -2, 2), (-1, -2, 2), 0, 0),
                       cross((1, 2, 0), (1, 2, 0), 0, 0))

        # haploid genotype coding 0..1: scale geno rows/cols of the
        # sufficient statistics (s for cross terms, s^2 for geno-geno)
        hs_b = hs_all[v0 + ia]
        if (hs_b != 1.0).any():
            for p in geno_idx:
                xtx[:, p, :] *= hs_b[:, None]
                xtx[:, :, p] *= hs_b[:, None]
                xty[:, p] *= hs_b
        _emit_linear_rows(
            sink, v0, ia, nm, g1, gg1, xtx, xty, yy_v, d, tests, chrom,
            provref, a1, omitted, vi, pred_specs, geno_idx, joint_name,
            exact_s_fn, log10,
        )
    mark("host postprocess+emit")
    if standalone:
        _write_sink(f"{cfg.out}.{pheno_name}.glm.linear", header, sink, log)


def _emit_linear_rows(
    sink, v0, ia, nm, g1, gg1, xtx, xty, yy_v, d, tests, chrom, provref, a1,
    omitted, vi, pred_specs, geno_idx, joint_name, exact_s_fn, log10,
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
        if gvar[i] <= 1e-12:
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
        a1f = np.where(nm > 0, g1 / np.maximum(2 * np.maximum(nm, 1), 1e-300),
                       np.nan)
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


def _exact_s_builder(ds, inc, c, a1_is_alt, preds=(_ADD,)):
    """Returns a per-variant callback computing exact f64 X^T X for the
    borderline-collinearity recheck."""
    def exact_s(vidx):
        X, _ = _variant_design_f64(ds, inc, c, bool(a1_is_alt[vidx]), vidx,
                                   preds)
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


def _variant_design_f64(ds, inc, c, alt_is_a1, vidx, preds=(_ADD,)):
    """Host f64 design matrix [nm, d] for one variant: [c | G_1..G_P] with
    the flip-resolved genotype predictors (name, plane weights when A1 is
    ALT, when A1 is REF); haploid variants scale 0.5 like the device
    kernels."""
    codes = _unpack_np(ds.reader.read_packed(vidx, 1))[0][: ds.raw_sample_ct][inc]
    val = codes != 3
    hp = (codes == 1).astype(np.float64)
    ap = (codes == 2).astype(np.float64)
    vp = val.astype(np.float64)
    scale = float(_hap_scale(ds)[vidx])
    cols = [c]
    for _nm, wa, wr in preds:
        w = wa if alt_is_a1 else wr
        cols.append(((w[0] * hp + w[1] * ap + w[2] * vp) * scale)[:, None])
    return np.concatenate(cols, axis=1)[val], val


def _logistic_f64(X, yv):
    """glm.fit-imitating IRLS in f64, matching LogisticRegressionD
    (2.0/plink2_glm_logistic.cc:2768): init OLS on z = 4.8638...*(y-0.5),
    converge on |dll| < 1e-8*(0.05+|ll|), maxit 25.  Returns (beta, se,
    hinv, converged, unfinished) or None on failure."""
    z = 4.863891244002886 * (yv - 0.5)
    try:
        b = np.linalg.solve(X.T @ X, X.T @ z)
    except np.linalg.LinAlgError:
        return None

    def ll_of(eta):
        with np.errstate(divide="ignore", over="ignore"):
            return float(
                np.where(yv != 0.0, -np.logaddexp(0.0, -eta),
                         -np.logaddexp(0.0, eta)).sum()
            )

    eta = X @ b
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
            eta = X @ b
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


def _firth_f64(X, yv):
    """f64 Firth regression matching FirthRegressionD
    (2.0/plink2_glm_logistic.cc:3049, logistf algorithm); see
    ops/glm.py _firth_core for the update equations.  Returns
    (beta, se, hinv2, converged, unfinished) or None on failure."""
    d = X.shape[1]
    b = np.zeros(d)
    pll_old = 0.0
    delta_max = 0.0
    conv = fail = False

    def parts(b):
        eta = X @ b
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
        hd = v * np.einsum("sd,de,se->s", X, h0inv, X)
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


def _glm_logistic(
    ds, cfg, log, pheno_name, ydata, smask, cov_names, cov_data, a1_is_alt,
    hide_covar, always_firth, no_firth, vmask=None, sink=None,
    header_out=None,
):
    """One logistic/Firth pass over `vmask` (default: all included variants)
    for one sample / covariate set.  Writes <out>.<pheno>.<suffix>, or with
    `sink` appends per-variant row strings to it and the header to
    `header_out` (the per-ploidy passes share one report)."""
    from ..ops.glm import firth_irls_block, glm_logistic_scan

    mods = set(cfg.glm_modifiers)
    dev = ds.device
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float64)  # 0 = control, 1 = case
    dc = len(cov_names) + 1
    d = dc + 1
    c = np.concatenate([np.ones((n, 1)), cov_data[inc]], axis=1)
    vb = _auto_vb(-(-n // 4) * 4)
    exact_s_fn = _exact_s_builder(ds, inc, c, a1_is_alt)
    if vmask is None:
        vmask = ds.variant_mask
    standalone = sink is None
    if standalone:
        sink = []
    mark = _phase_timer(log)
    pd = PackedDevice(ds, vmask, vb=vb, sample_mask=smask)
    npad = pd.npad
    feat = np.zeros((npad, dc + 2), np.float32)  # [c | y | mask]
    feat[:n, :dc] = c
    feat[:n, dc] = y
    feat[:n, dc + 1] = 1.0
    feat_d = torch.from_numpy(feat).to(dev)

    M = ds.raw_variant_ct
    chrom, provref, a1, omitted = _row_meta(ds, a1_is_alt)
    vi = ds.vi
    suffix = "glm.firth" if always_firth else (
        "glm.logistic" if no_firth else "glm.logistic.hybrid"
    )
    firth_col = not always_firth and not no_firth
    log10 = "log10" in mods
    p_col = "NEG_LOG10_P" if log10 else "P"
    header = (
        "#CHROM\tPOS\tID\tREF\tALT\tPROVISIONAL_REF?\tA1\tOMITTED\tA1_FREQ\t"
        + ("FIRTH?\t" if firth_col else "")
        + f"TEST\tOBS_CT\tOR\tLOG(OR)_SE\tZ_STAT\t{p_col}\tERRCODE\n"
    )
    if header_out is not None:
        header_out.append(header)
    tests = ["INTERCEPT"] if "intercept" in mods else []
    tests.append("ADD")
    if not hide_covar:
        tests += list(cov_names)
    test_pred = {"INTERCEPT": 0, "ADD": dc}
    for j, cn in enumerate(cov_names):
        test_pred[cn] = 1 + j

    # plane weights of every block: the model predictor, and (moments pass)
    # an always-additive copy for the A1-dosage separation/const statistics
    alt_pad_all = np.zeros(pd.nblocks * pd.vb, bool)
    alt_pad_all[:M] = a1_is_alt
    alt_b = alt_pad_all.reshape(pd.nblocks, pd.vb)
    w_add = np.where(alt_b[:, :, None], np.array(_ADD[1], np.float32),
                     np.array(_ADD[2], np.float32))  # [nb, vb, 3]
    # haploid genotype coding is 0..1 (dosage halved; z/p invariant, OR/SE
    # match the reference's per-copy scale)
    hs_pad = np.ones(pd.nblocks * pd.vb, np.float32)
    hs_pad[:M] = _hap_scale(ds)
    gw_all = (w_add * hs_pad.reshape(pd.nblocks, pd.vb)[:, :, None])[:, :, None, :]
    gwm_all = np.concatenate([gw_all, w_add[:, :, None, :]], axis=2)
    gw_d = torch.from_numpy(np.ascontiguousarray(gw_all)).to(dev)
    mark("pack+upload")
    outs = glm_logistic_scan(
        pd.packed, gw_d, torch.from_numpy(np.ascontiguousarray(gwm_all)).to(dev),
        feat_d, firth=always_firth)
    (momy_d, mstats_d, screen_d, beta_d, se_d, conv_d, fail_d, unf_d,
     obs_d, invalid_d, _hinv_d) = outs
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
    mark("device scan+fetch")

    def _invalid_rows(hf, rows):
        """Host recomputation of the validParameters() check for rows whose
        covariance was replaced after the device pass."""
        out = np.zeros(len(rows), bool)
        for k_, i in enumerate(rows):
            h = hf[i]
            dg = np.diag(h)
            with np.errstate(invalid="ignore"):
                if ((dg[1:] < 1e-20) | ~np.isfinite(dg[1:])).any():
                    out[k_] = True
                    continue
                sd = np.sqrt(dg)
                for i_ in range(1, d):
                    for j_ in range(i_):
                        if h[i_, j_] > 0.99999 * sd[i_] * sd[j_]:
                            out[k_] = True
        return out

    keep_cols = list(range(dc)) + [dc + 1]
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

        def _extreme(beta_a, se_a, conv_a, fail_a, unf_a, base):
            # rows whose f32 trajectory may diverge from the reference's f64
            # LogisticRegressionD/FirthRegressionD: quasi-separated fits
            # (huge |beta| or SE on the genotype predictor), non-converged
            # rows, and low minor-dosage-count rows, whose f32 SE noise
            # exceeds the 1e-3 parity budget
            with np.errstate(invalid="ignore"):
                bm = np.abs(beta_a[:, dc:]).max(axis=1)
                sm = se_a[:, dc:].max(axis=1)
            mac = np.minimum(g_tot, 2.0 * obs_f - g_tot)
            ext = (bm > 5.0) | (sm > 5.0) | (mac < 30.0) | fail_a | unf_a | ~conv_a
            return ext & base & ~pre_bad

        refined = np.zeros(pd.vb, bool)
        hfull = np.zeros((pd.vb, d, d))

        def _refine(rows, firth_mode, beta_a, se_a, hfull_a, conv_a, fail_a,
                    unf_a):
            fit = _firth_f64 if firth_mode else _logistic_f64
            for i in rows:
                vidx = v0 + i
                X, val = _variant_design_f64(
                    ds, inc, c, bool(a1_is_alt[vidx]), vidx)
                res = fit(X, y[val])
                refined[i] = True
                if res is None:
                    conv_a[i], fail_a[i], unf_a[i] = False, True, False
                    continue
                b_, se_, hinv_, cv_, un_ = res
                beta_a[i] = b_
                se_a[i] = se_
                hfull_a[i] = hinv_
                conv_a[i], fail_a[i], unf_a[i] = cv_, False, un_

        beta = beta_all[bi].copy()
        se = se_all[bi].copy()
        conv = conv_all[bi].copy()
        fail = fail_all[bi].copy()
        unf = unf_all[bi].copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            const = (g_ssq - g_tot * g_tot / np.maximum(obs, 1)) <= 1e-12
        sep_allele = None
        if always_firth:
            used_firth = np.ones(pd.vb, bool)
            rows = np.flatnonzero(_extreme(beta, se, conv, fail, unf,
                                           in_block & ~const))
            _refine(rows, True, beta, se, hfull, conv, fail, unf)
        else:
            # separation pre-check over BOTH alleles, REF first (ref loop
            # "Does any genotype column have zero case or zero control
            # dosage?", plink2_glm_logistic.cc:2224-2236); the reference
            # reports the separating allele in the errcode
            fac_ = 2.0 * hs_pad.reshape(pd.nblocks, pd.vb)[bi]
            altm = alt_b[bi]
            tot_aobs, tot_caobs = fac_ * obs, fac_ * nc_pre
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
            if no_firth:
                fail = fail | sep  # SEPARATION errcode path
            else:
                need_firth = (sep | fail) & ~const & in_block
                if need_firth.any():
                    fb, fse, _, fconv, ffail, funf, _fobs, fhfull = (
                        x.cpu().numpy() for x in firth_irls_block(
                            pd.packed[bi], gw_d[bi], feat_d,
                            torch.from_numpy(need_firth).to(dev)))
                    fb = fb.astype(np.float64)
                    fse = fse.astype(np.float64)
                    fhfull = fhfull.astype(np.float64)
                    fconv, ffail, funf = fconv.copy(), ffail.copy(), funf.copy()
                    fext = _extreme(fb, fse, fconv, ffail, funf, need_firth)
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
        with np.errstate(divide="ignore", invalid="ignore"):
            a1f = np.where(obs > 0, g_tot / (2 * np.maximum(obs, 1)), np.nan)
        _emit_logistic_rows(
            sink, v0, ia, beta, se, fail, unf, obs, a1f, const, used_firth,
            firth_col, tests, test_pred, chrom, provref, a1, omitted, vi, d,
            no_firth, pre_err, invalid, log10, sep_allele,
        )
    mark("host postprocess+emit")
    if standalone:
        _write_sink(f"{cfg.out}.{pheno_name}.{suffix}", header, sink, log)


def _emit_logistic_rows(
    sink, v0, ia, beta, se, fail, unf, obs, a1f, const, used_firth,
    firth_col, tests, test_pred, chrom, provref, a1, omitted, vi, d, no_firth,
    pre_err, invalid, log10, sep_allele,
):
    with np.errstate(divide="ignore", invalid="ignore"):
        zstat = np.where(se > 0, beta / se, np.nan)
    # ln p only for columns that reach the report (hide-covar emits 1-2 of
    # ~14 design columns; the host continued fraction is not free)
    need_cols = sorted({test_pred[t] for t in tests})
    logp = np.full_like(zstat, np.nan)
    logp[:, need_cols] = np.asarray(
        zstat_logp_2sided(np.nan_to_num(zstat[:, need_cols])))
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
        fcol = f"{firth_str}\t" if firth_col else ""
        for tname in tests:
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

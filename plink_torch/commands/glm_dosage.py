"""--glm on dosage data: the logistic / Firth / hybrid and linear reports of a
fileset whose variants carry dosage tracks.

Port of plink_tpu/commands/glm.py `_glm_dosage` (the device route: the
additive model, dense-G batched IRLS / OLS moments) and `_glm_dosage_host`
(the genotype models, `interaction` and local covariates: per-variant f64
fits on the host with plink2's piecewise dosage codings; with local
covariates on any fileset, hard calls read as dosages 0 / 1 / 2).
Behaviour reference: GlmMain's dosage path (2.0/plink2_glm.cc:2395)
and GlmLogisticThreadF (2.0/plink2_glm_logistic.cc:2110-2155).

The device route reads each block's fused ALT dosages as uint16 in 1/16384
units (`Dataset.dosage_u16_row`), turns them to the A1 allele (32768 - u
where A1 = REF; 65535 stays missing) and hands them to ops/glm.py's
`dense_cc_block` / `dense_firth_block` / `dense_qt_block` (kernels K17 /
K18 / K4).  The host's per-variant sums that decide OBS_CT, A1_FREQ,
CONST_OMITTED_ALLELE and separation are exact: integer sums of the
dosages, divided by powers of two, which equal plink_tpu's f64 sums of
the same dyadic values in any order.  As in plink_tpu, the dosage route
takes no ploidy groups, no --xchr-model split and no cc-/firth-residualize
(those modifiers leave a dosage run unchanged; ROADMAP C), and runs no
permutation test.  Each report is followed by its --adjust report.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..dataset import _U16_OF_CODE
from ..ops.planes import _unpack_np
from ..stats.distributions import f_logsf, t_logp_2sided, zstat_logp_2sided
from ..utils.fmt import g6
from .glm import (_GLM_MODEL_MODS, ERR_OK, _collinearity_err,
                  _collinearity_err_checked, _firth_f64, _geno_predictors,
                  _logistic_f64, _p_str, _phase_timer, _row_meta,
                  _write_adjusted)

MISSING = 65535  # uint16 dosage of a missing call


def _dosage_vb(npad: int) -> int:
    """Variants per device block: the uint16 dosages stay ~512 MB (plink_tpu
    takes min(512, 2^26 / npad) variants of 8 bytes a sample, ~0.5 GB: the
    port's 2 bytes a sample give 512 at 500,000 samples).  PLINK_TORCH_VB
    overrides."""
    env = os.environ.get("PLINK_TORCH_VB")
    if env:
        return max(8, int(env))
    return int(min(512, max(16, (1 << 29) // max(2 * npad, 1))))


def _alt_u16(ds, v: int) -> np.ndarray:
    """Variant v's ALT dosage in 1/16384 units over every sample: the fused
    dosage of a dosage fileset, 16384 x the hard call otherwise."""
    if ds.has_dosage:
        return ds.dosage_u16_row(v)
    codes = _unpack_np(ds.reader.read_packed(v, 1))[0][: ds.raw_sample_ct]
    return _U16_OF_CODE[codes]


def a1_dosages(ds, vblk, inc, a1_is_alt) -> np.ndarray:
    """uint16 [len(vblk), len(inc)]: each variant's A1 dosage over the
    included samples in 1/16384 units, MISSING where missing."""
    out = np.empty((len(vblk), inc.size), np.uint16)
    every = inc.size == ds.raw_sample_ct  # inc is then 0..n-1
    for i, v in enumerate(vblk):
        u = _alt_u16(ds, int(v))
        if not every:
            u = u[inc]
        miss = u == MISSING
        if np.count_nonzero(u > 32768) > np.count_nonzero(miss):
            raise ValueError(f"--glm: variant {ds.vi.vid[v]} has a dosage "
                             "above 2.")
        out[i] = u if a1_is_alt[v] else np.where(miss, u, 32768 - u)
    return out


def _g64(urow) -> np.ndarray:
    """One variant's A1 dosages as f64, NaN where missing (plink_tpu's
    graw row)."""
    return np.where(urow == MISSING, np.nan, urow / 16384.0)


def _exact_sums(U, y):
    """Per variant (obs, sum g, sum g^2, sum g y) over the valid samples,
    exact in f64: integer sums of u (< 2^53), then divided by 2^14 / 2^28;
    y is 0/1 (or None)."""
    valid = U != MISSING
    obs = valid.sum(axis=1)
    G = np.where(valid, U, 0)
    g_tot = G.sum(axis=1, dtype=np.int64) / 16384.0
    g_ssq = np.empty(len(U))
    g_case = np.empty(len(U)) if y is not None else None
    for i in range(len(U)):
        gi = G[i].astype(np.float64)  # integers: every product and sum exact
        g_ssq[i] = (gi @ gi) / 268435456.0
        if y is not None:
            g_case[i] = (gi @ y) / 16384.0
    return obs, g_tot, g_ssq, g_case


def _report(cfg, pheno_name, kind, always_firth, no_firth, joint=False):
    """(path, suffix, firth column?, open file with the header written)."""
    log10 = "log10" in set(cfg.glm_modifiers)
    is_cc = kind == "cc"
    if is_cc:
        suffix = "glm.firth" if always_firth else (
            "glm.logistic" if no_firth else "glm.logistic.hybrid")
    else:
        suffix = "glm.linear"
    path = f"{cfg.out}.{pheno_name}.{suffix}"
    firth_col = is_cc and not always_firth and not no_firth
    p_col = "NEG_LOG10_P" if log10 else "P"
    f = open(path, "w")  # closed by the caller
    if is_cc:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tPROVISIONAL_REF?\tA1\tOMITTED\t"
                "A1_FREQ\t" + ("FIRTH?\t" if firth_col else "")
                + "TEST\tOBS_CT\tOR\tLOG(OR)_SE\t"
                + ("Z_OR_F_STAT" if joint else "Z_STAT") + f"\t{p_col}\tERRCODE\n")
    else:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tPROVISIONAL_REF?\tA1\tOMITTED\t"
                "A1_FREQ\tTEST\tOBS_CT\tBETA\tSE\t"
                + ("T_OR_F_STAT" if joint else "T_STAT") + f"\t{p_col}\tERRCODE\n")
    return path, suffix, firth_col, f


def _invalid_params(hinv, d) -> bool:
    """validParameters() on one f64 covariance (as _valid_params_flags)."""
    dg = np.diag(hinv)
    if ((dg[1:] < 1e-20) | ~np.isfinite(dg[1:])).any():
        return True
    with np.errstate(invalid="ignore"):
        sd = np.sqrt(dg)
    return any(hinv[i_, j_] > 0.99999 * sd[i_] * sd[j_]
               for i_ in range(1, d) for j_ in range(i_))


def glm_dosage(ds, cfg, log, pheno_name, ydata, smask, cov_names, cov_data,
               a1_is_alt, hide_covar, kind, always_firth, no_firth,
               local_info=None):
    """plink_tpu `_glm_dosage`: the additive model on the card (dense_cc /
    dense_firth / dense_qt blocks), every other model, `interaction` and
    local covariates (`local_info`, glm._load_local_covars) on the host
    (glm_dosage_host)."""
    from ..ops.glm import dense_cc_block, dense_firth_block, dense_qt_block

    mods = set(cfg.glm_modifiers)
    if local_info is not None or mods & (_GLM_MODEL_MODS | {"interaction"}):
        return glm_dosage_host(ds, cfg, log, pheno_name, ydata, smask,
                               cov_names, cov_data, a1_is_alt, hide_covar, kind,
                               always_firth, no_firth, local_info)
    log10 = "log10" in mods
    intercept = "intercept" in mods
    dev = ds.device
    mark = _phase_timer(log)
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float64)
    k = len(cov_names)
    dc = k + 1
    d = dc + 1
    c = np.concatenate([np.ones((n, 1)), cov_data[inc]], axis=1)

    chrom, provref, a1, omitted = _row_meta(ds, a1_is_alt)
    vi = ds.vi
    is_cc = kind == "cc"
    path, suffix, firth_col, f = _report(cfg, pheno_name, kind, always_firth,
                                         no_firth)
    add_results: list[tuple[int, float]] = []
    tests = (["INTERCEPT"] if intercept else []) + ["ADD"]
    if not hide_covar:
        tests += list(cov_names)
    test_pred = {"INTERCEPT": 0, "ADD": dc}
    for j, cn in enumerate(cov_names):
        test_pred[cn] = 1 + j

    npad = -(-max(n, 1) // 128) * 128
    feat = np.zeros((npad, dc + 2), np.float32)
    feat[:n, :dc] = c
    feat[:n, dc] = y
    feat[:n, dc + 1] = 1.0
    feat = torch.from_numpy(feat).to(dev)
    vsel = np.flatnonzero(ds.variant_mask)
    vb = _dosage_vb(npad)
    dos = torch.full((vb, npad), MISSING, dtype=torch.uint16, device=dev)

    def f64(t):
        return t.to(torch.float64).cpu().numpy()

    for b0 in range(0, len(vsel), vb):
        vblk = vsel[b0: b0 + vb]
        nv = len(vblk)
        U = a1_dosages(ds, vblk, inc, a1_is_alt)
        dos[:nv, :n] = torch.from_numpy(U).to(dev)
        if nv < vb:
            dos[nv:] = MISSING
        # exact f64 per-variant dosage sums on the host (the f32 device sums
        # cannot resolve the const-allele / separation thresholds at scale)
        obs, g_tot, g_ssq, g_case = _exact_sums(U, y if is_cc else None)
        with np.errstate(divide="ignore", invalid="ignore"):
            gvar = g_ssq - np.where(obs > 0, g_tot * g_tot / np.maximum(obs, 1),
                                    0.0)
            mac = np.minimum(g_tot, 2.0 * obs - g_tot)
        mark("dosage read+upload")

        if not is_cc:
            xtx_a, xty_a, yy_a = (f64(x) for x in dense_qt_block(dos, feat)[:3])
        else:
            outs = dense_cc_block(dos, feat, always_firth)
            xtx_a, beta_a, se_a = f64(outs[0]), f64(outs[4]), f64(outs[5])
            conv_a, fail_a, unf_a, invalid_a = (
                outs[i].cpu().numpy().copy() for i in (6, 7, 8, 10))
            used_firth = np.full(vb, bool(always_firth))
            if not always_firth and not no_firth:
                sep = (g_case <= 0.0) | (g_case >= g_tot)
                need_firth = np.zeros(vb, bool)
                need_firth[:nv] = (sep | fail_a[:nv]) & (gvar > 1e-12)
                if need_firth.any():
                    fo = dense_firth_block(dos, feat, torch.from_numpy(
                        need_firth).to(dev))
                    m = need_firth
                    beta_a[m], se_a[m] = f64(fo[0])[m], f64(fo[1])[m]
                    for dst, src in ((conv_a, fo[2]), (fail_a, fo[3]),
                                     (unf_a, fo[4]), (invalid_a, fo[6])):
                        dst[m] = src.cpu().numpy()[m]
                    used_firth = need_firth
        mark("device scan+fetch")

        for i in range(nv):
            v = int(vblk[i])
            nm = int(obs[i])
            meta = (f"{chrom[v]}\t{vi.pos[v]}\t{vi.vid[v]}\t{vi.ref[v]}\t"
                    f"{vi.alt[v]}\t{provref[v]}\t{a1[v]}\t{omitted[v]}\t"
                    f"{g6(g_tot[i] / (2 * nm)) if nm else 'NA'}")

            def emit_bad(ec, firth_str="N"):
                fcol = f"{firth_str}\t" if firth_col else ""
                for tname in tests:
                    f.write(f"{meta}\t{fcol}{tname}\t{nm}\tNA\tNA\tNA\tNA\t{ec}\n")

            if nm <= d:
                emit_bad("SAMPLE_CT<=PREDICTOR_CT")
                continue
            if gvar[i] <= 1e-12:
                emit_bad("CONST_OMITTED_ALLELE")
                continue

            def design(i=i):
                gi = _g64(U[i])
                val = np.isfinite(gi)
                return np.column_stack([c[val], gi[val]]), val

            def exact_s(i=i):
                X, _ = design(i)
                return X.T @ X

            ce = _collinearity_err_checked(xtx_a[i], float(nm), exact_s)
            if ce is not None:
                emit_bad(ce)
                continue
            if not is_cc:
                if mac[i] < 30.0 or not np.all(np.isfinite(xty_a[i])) or nm < 4096:
                    X, val = design()
                    s, xty, yy = X.T @ X, X.T @ y[val], float(y[val] @ y[val])
                else:
                    s, xty, yy = xtx_a[i], xty_a[i], float(yy_a[i])
                try:
                    inv = np.linalg.inv(s)
                except np.linalg.LinAlgError:
                    emit_bad("RANK_DEFICIENT")
                    continue
                bvec = inv @ xty
                rss = float(yy - bvec @ xty)
                dof = nm - d
                sigma2 = rss / dof
                diag = np.diag(inv)
                if sigma2 < 0 or (diag <= 0).any():
                    emit_bad("INVALID_RESULT")
                    continue
                se = np.sqrt(sigma2 * diag)
                tstat = bvec / se
                logp = np.asarray(t_logp_2sided(tstat, np.full(d, float(dof))))
                add_results.append((v, float(logp[dc])))
                for tname in tests:
                    pi = test_pred[tname]
                    f.write(f"{meta}\t{tname}\t{nm}\t{g6(bvec[pi])}\t{g6(se[pi])}\t"
                            f"{g6(tstat[pi])}\t{_p_str(logp[pi], log10)}\t.\n")
                continue
            # logistic / firth
            sep_i = g_case[i] <= 0.0 or g_case[i] >= g_tot[i]
            if no_firth and sep_i:
                emit_bad("SEPARATION")
                continue
            uf = bool(used_firth[i]) if not no_firth else False
            bvec, sev = beta_a[i], se_a[i]
            conv_i, fail_i, unf_i, inval_i = (bool(conv_a[i]), bool(fail_a[i]),
                                              bool(unf_a[i]), bool(invalid_a[i]))
            with np.errstate(invalid="ignore"):
                ext = (not conv_i or fail_i or unf_i or mac[i] < 30.0
                       or np.abs(bvec[dc:]).max() > 5.0 or sev[dc:].max() > 5.0
                       or nm < 4096)
            if ext:
                X, val = design()
                yv = y[val]
                res = None
                uf = always_firth
                if not always_firth and not sep_i:
                    res = _logistic_f64(X, yv)
                if res is None and not always_firth:
                    if no_firth:
                        emit_bad("SEPARATION" if sep_i else "LOGISTIC_CONVERGE_FAIL")
                        continue
                    uf = True
                if uf:
                    res = _firth_f64(X, yv)
                    if res is None:
                        emit_bad("FIRTH_CONVERGE_FAIL", "Y" if firth_col else "N")
                        continue
                bvec, sev, hinv_, conv_i, unf_i = res
                inval_i = _invalid_params(hinv_, d)
            elif fail_i:
                emit_bad("FIRTH_CONVERGE_FAIL" if uf or always_firth
                         else "LOGISTIC_CONVERGE_FAIL",
                         "Y" if (uf and firth_col) else "N")
                continue
            if inval_i:
                emit_bad("INVALID_RESULT", "Y" if uf and firth_col else "N")
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                z = np.where(sev > 0, bvec / sev, np.nan)
            logp = np.asarray(zstat_logp_2sided(np.nan_to_num(z)))
            add_results.append((v, float(logp[dc])))
            ok_err = "UNFINISHED" if unf_i else ERR_OK
            fcol = (("Y" if uf else "N") + "\t") if firth_col else ""
            for tname in tests:
                pi = test_pred[tname]
                if not np.isfinite(bvec[pi]) or not np.isfinite(sev[pi]):
                    f.write(f"{meta}\t{fcol}{tname}\t{nm}\tNA\tNA\tNA\tNA\t"
                            "INVALID_RESULT\n")
                else:
                    f.write(f"{meta}\t{fcol}{tname}\t{nm}\t"
                            f"{g6(np.exp(bvec[pi]))}\t{g6(sev[pi])}\t{g6(z[pi])}\t"
                            f"{_p_str(logp[pi], log10)}\t{ok_err}\n")
        mark("host postprocess+emit")
    f.close()
    log.log(f"Results written to {path} .")
    _write_adjusted(ds, cfg, log, pheno_name, suffix, add_results, a1_is_alt)


def _geno_dosage_cols(gv, geno_preds):
    """plink2's piecewise dosage codings (GlmLogisticThreadF,
    2.0/plink2_glm_logistic.cc:2110-2155): DOM 0..1..1, REC / HOM 0..0..1,
    HET / DOMDEV the 0..1..0 triangle."""
    tri = np.where(gv > 1.0, 2.0 - gv, gv)
    cols = []
    for nm_, _wa, _wr in geno_preds:
        if nm_ == "ADD":
            cols.append(gv)
        elif nm_ == "DOM":
            cols.append(np.minimum(gv, 1.0))
        elif nm_ in ("REC", "HOM"):
            cols.append(np.maximum(gv - 1.0, 0.0))
        else:  # HET / DOMDEV
            cols.append(tri)
    return cols


def glm_dosage_host(ds, cfg, log, pheno_name, ydata, smask, cov_names,
                    cov_data, a1_is_alt, hide_covar, kind, always_firth,
                    no_firth, local_info=None):
    """plink_tpu `_glm_dosage_host`: the genotype models, `interaction` and
    local covariates on dosages (or hard calls), one f64 fit a variant on
    the host.  With `local_info` (glm._load_local_covars) the samples are
    restricted to the local .psam's, the variants to the local .pvar's,
    and each variant's design takes its local-covar line's K columns
    (LOCAL1..LOCALK) after the file covariates; their TEST rows come
    before the file covariates' (ref GlmLocalOpen, 2.0/plink2_glm.cc:751)."""
    mods = set(cfg.glm_modifiers)
    geno_preds, joint_name = _geno_predictors(mods)
    interaction = "interaction" in mods
    log10 = "log10" in mods
    intercept = "intercept" in mods
    lvals = lline_of = None
    n_local = 0
    if local_info is not None:
        lvals, lline_of, loc_raw_idx, n_local = local_info
        member = np.zeros(ds.raw_sample_ct, bool)
        member[loc_raw_idx[loc_raw_idx >= 0]] = True
        smask = smask & member
        locpos_of_raw = np.full(ds.raw_sample_ct, -1)
        for p_, r_ in enumerate(loc_raw_idx):
            if r_ >= 0:
                locpos_of_raw[r_] = p_
    inc = np.flatnonzero(smask)
    y = ydata[inc].astype(np.float64)
    k = len(cov_names)
    dc = k + 1 + n_local
    P = len(geno_preds)
    n_int = P * k if interaction else 0
    d = dc + P + n_int
    c = np.concatenate([np.ones((len(inc), 1)), cov_data[inc]], axis=1)
    if n_local:
        loc_cols = locpos_of_raw[inc]

    chrom, provref, a1, omitted = _row_meta(ds, a1_is_alt)
    vi = ds.vi
    is_cc = kind == "cc"
    path, suffix, firth_col, f = _report(cfg, pheno_name, kind, always_firth,
                                         no_firth, joint=bool(joint_name))
    add_results: list[tuple[int, float]] = []
    local_names = [f"LOCAL{j + 1}" for j in range(n_local)]
    geno_names = [g[0] for g in geno_preds]
    int_names = [f"{gn}x{cn}" for gn in geno_names
                 for cn in cov_names] if interaction else []
    tests = (["INTERCEPT"] if intercept else []) + list(geno_names)
    if not hide_covar:
        # the reference's TEST order: local covariates before the file's
        tests += local_names + list(cov_names)
    tests += int_names
    if joint_name:
        tests.append(joint_name)
    test_pred = {"INTERCEPT": 0}
    for p_, gn in enumerate(geno_names):
        test_pred[gn] = dc + p_
    for p_, gn in enumerate(int_names):
        test_pred[gn] = dc + P + p_
    for j, cn in enumerate(cov_names):
        test_pred[cn] = 1 + j
    for j, cn in enumerate(local_names):
        test_pred[cn] = 1 + k + j

    vsel = np.flatnonzero(ds.variant_mask)
    if lline_of is not None:
        vsel = np.array([v for v in vsel if int(v) in lline_of], dtype=int)
    for v in vsel:
        g = _g64(a1_dosages(ds, [v], inc, a1_is_alt)[0])
        val = np.isfinite(g)
        nm = int(val.sum())
        gv = g[val]
        cv = c[val]
        if n_local:
            cv = np.concatenate([cv, lvals[lline_of[int(v)]][loc_cols[val]]],
                                axis=1)
        yv = y[val]
        meta = (f"{chrom[v]}\t{vi.pos[v]}\t{vi.vid[v]}\t{vi.ref[v]}\t"
                f"{vi.alt[v]}\t{provref[v]}\t{a1[v]}\t{omitted[v]}\t"
                f"{g6(gv.sum() / (2 * nm)) if nm else 'NA'}")

        def emit_bad(ec, firth_str="N"):
            fcol = f"{firth_str}\t" if firth_col else ""
            for tname in tests:
                f.write(f"{meta}\t{fcol}{tname}\t{nm}\tNA\tNA\tNA\tNA\t{ec}\n")

        if nm <= d:
            emit_bad("SAMPLE_CT<=PREDICTOR_CT")
            continue
        gvar = float((gv * gv).sum() - gv.sum() ** 2 / nm)
        if gvar <= 1e-12:
            emit_bad("CONST_OMITTED_ALLELE")
            continue
        gcols = _geno_dosage_cols(gv, geno_preds)
        if interaction:
            gcols = gcols + [gk * cv[:, 1 + j] for gk in list(gcols)
                             for j in range(k)]
        X = np.column_stack([cv] + gcols)
        s = X.T @ X
        ce = _collinearity_err(s, float(nm))[0]
        if ce is not None:
            emit_bad(ce)
            continue
        if not is_cc:
            try:
                inv = np.linalg.inv(s)
            except np.linalg.LinAlgError:
                emit_bad("RANK_DEFICIENT")
                continue
            xty = X.T @ yv
            bvec = inv @ xty
            rss = float(yv @ yv - bvec @ xty)
            dof = nm - d
            sigma2 = rss / dof
            diag = np.diag(inv)
            if sigma2 < 0 or (diag <= 0).any():
                emit_bad("INVALID_RESULT")
                continue
            se = np.sqrt(sigma2 * diag)
            tstat = bvec / se
            logp = np.asarray(t_logp_2sided(tstat, np.full(d, float(dof))))
            add_results.append((int(v), float(logp[dc])))
            fstat_j = logp_j = np.nan
            if joint_name:
                keep = [p_ for p_ in range(d) if not dc <= p_ < dc + P]
                try:
                    inv0 = np.linalg.inv(s[np.ix_(keep, keep)])
                    b0 = inv0 @ xty[keep]
                    rss0 = float(yv @ yv - b0 @ xty[keep])
                    fstat_j = ((rss0 - rss) / P) / sigma2
                    # second dof = sample_obs_ct, NOT nm - d (the reference
                    # feeds FstatToLnP(chisq/ct, ct, sample_obs_ct))
                    logp_j = float(f_logsf(np.array([fstat_j]), float(P),
                                           float(nm))[0])
                except np.linalg.LinAlgError:
                    pass
            for tname in tests:
                if tname == joint_name:
                    if np.isfinite(fstat_j):
                        f.write(f"{meta}\t{tname}\t{nm}\tNA\tNA\t{g6(fstat_j)}\t"
                                f"{_p_str(logp_j, log10)}\t.\n")
                    else:
                        f.write(f"{meta}\t{tname}\t{nm}\tNA\tNA\tNA\tNA"
                                "\tINVALID_RESULT\n")
                    continue
                pi = test_pred[tname]
                f.write(f"{meta}\t{tname}\t{nm}\t{g6(bvec[pi])}\t{g6(se[pi])}\t"
                        f"{g6(tstat[pi])}\t{_p_str(logp[pi], log10)}\t.\n")
            continue
        # logistic / firth
        used_firth = always_firth
        res = None
        if not always_firth:
            sep = float(gv @ yv) <= 0.0 or float(gv @ yv) >= float(gv.sum())
            if not sep:
                res = _logistic_f64(X, yv)
            if res is None:
                if no_firth:
                    emit_bad("SEPARATION" if sep else "LOGISTIC_CONVERGE_FAIL")
                    continue
                used_firth = True
        if used_firth:
            res = _firth_f64(X, yv)
            if res is None:
                emit_bad("FIRTH_CONVERGE_FAIL", "Y" if firth_col else "N")
                continue
        bvec, se, hinv, conv, unf = res
        if _invalid_params(hinv, d):
            emit_bad("INVALID_RESULT", "Y" if used_firth and firth_col else "N")
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(se > 0, bvec / se, np.nan)
        logp = np.asarray(zstat_logp_2sided(np.nan_to_num(z)))
        add_results.append((int(v), float(logp[dc])))
        ok_err = "UNFINISHED" if unf else ERR_OK
        fcol = (("Y" if used_firth else "N") + "\t") if firth_col else ""
        fstat_j = logp_j = np.nan
        if joint_name:
            bg = bvec[dc:dc + P]
            try:
                w_ = float(bg @ np.linalg.inv(hinv[dc:dc + P, dc:dc + P]) @ bg)
                if w_ >= 0:
                    fstat_j = w_ / P
                    logp_j = float(f_logsf(np.array([fstat_j]), float(P),
                                           float(nm))[0])
            except np.linalg.LinAlgError:
                pass
        for tname in tests:
            if tname == joint_name:
                if np.isfinite(fstat_j):
                    f.write(f"{meta}\t{fcol}{tname}\t{nm}\tNA\tNA\t{g6(fstat_j)}\t"
                            f"{_p_str(logp_j, log10)}\t{ok_err}\n")
                else:
                    f.write(f"{meta}\t{fcol}{tname}\t{nm}\tNA\tNA\tNA\t"
                            "NA\tINVALID_RESULT\n")
                continue
            pi = test_pred[tname]
            if not np.isfinite(bvec[pi]) or not np.isfinite(se[pi]):
                f.write(f"{meta}\t{fcol}{tname}\t{nm}\tNA\tNA\tNA\tNA\t"
                        "INVALID_RESULT\n")
            else:
                f.write(f"{meta}\t{fcol}{tname}\t{nm}\t"
                        f"{g6(np.exp(bvec[pi]))}\t{g6(se[pi])}\t{g6(z[pi])}\t"
                        f"{_p_str(logp[pi], log10)}\t{ok_err}\n")
    f.close()
    log.log(f"Results written to {path} .")
    _write_adjusted(ds, cfg, log, pheno_name, suffix, add_results, a1_is_alt)

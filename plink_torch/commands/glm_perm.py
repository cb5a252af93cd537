"""--glm permutation tests: 'mperm=N' (max(T)) and 'aperm' (adaptive).

Port of plink_tpu/commands/glm.py `_perm_spec_fn`, `_perm_group_setups`,
`_glm_linear_perm` and `_glm_firth_perm`.  Behaviour reference:
GlmLinearPerm (2.0/plink2_glm_linear.cc:4940) and GlmLogisticPerm
(2.0/plink2_glm_logistic.cc:6342); the counting, adaptive pruning and
report are commands/perm_report.py's.

The phenotype is permuted over the union sample set with numpy's
default_rng(--seed), one `permutation` a column, in batches of B columns
(the same stream and batches as plink_tpu, so both packages permute
identically).  Each ploidy group scans its own packed block layout against
its samples' rows of the batch:
- quantitative phenotypes: the design [c | G_1..G_P] is fixed across
  permutations, so X^T X is inverted once per block (K2 / K15 and K4, kept
  for every batch) while K19 forms X^T y_b and y_b^T y_b of the whole
  batch and K20 the t (or joint F) of each (variant, permutation);
- case/control phenotypes (which need 'firth'): one Firth fit of the
  block's tested rows per permuted column (K3 / K16 in logistic and firth2
  modes, K4; plink_tpu fits every row and keeps the tested ones), and the
  statistic (|z|, or the joint Wald chisq / q with its q x q solve on K4)
  as tensor ops.
Within a variant the degrees of freedom do not change between
permutations, so EMP1 compares the raw statistics; ln p is formed on the
host only for max(T)'s per-permutation best (EMP2), and there only for the
variants that can hold that best (`_min_lnp`), where plink_tpu evaluates
the incomplete-beta continued fraction for every (variant, permutation).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pairwise import PackedDevice
from ..stats.distributions import f_logsf, norm_ppf, t_logp_2sided
from .glm import _auto_vb, _drop_const_covars, _geno_predictors, _row_meta
from .perm_report import AdaptiveState, emp2_from_best, write_perm_report

# plink2's --aperm defaults (min, max, alpha, beta, init interval, slope)
_APERM_DEFAULT = (6, 1000000, 0.0, 0.0001, 1.0, 0.001 * (1 + 2 ** -44))
_MIN_LNP_TOP = 8  # statistics a column whose ln p _min_lnp evaluates first


def _min_lnp(stat, dof, lnp):
    """np.min(lnp(stat, dof[:, None]), axis=0) for stat f64 [T, B] (|t|, F
    or chisq / q, NaN-free; ln p falls as it grows) and the variants' dof
    [T] (or obs).  Per column, ln p is taken on its _MIN_LNP_TOP largest
    statistics; every other variant's statistic is at most the next one,
    so its ln p is at least that statistic's ln p at whichever end of the
    dof range gives the smaller (ln p is monotone in the dof there).  A
    column whose bound does not clear its minimum is evaluated in full."""
    T = stat.shape[0]
    if T <= _MIN_LNP_TOP:
        return np.min(lnp(stat, dof[:, None]), axis=0)
    order = np.argsort(-stat, axis=0, kind="stable")
    top = order[:_MIN_LNP_TOP]
    best = np.min(lnp(np.take_along_axis(stat, top, 0), dof[top]), axis=0)
    nxt = np.take_along_axis(stat, order[_MIN_LNP_TOP:_MIN_LNP_TOP + 1], 0)[0]
    bound = np.minimum(lnp(nxt, np.full_like(nxt, dof.min())),
                       lnp(nxt, np.full_like(nxt, dof.max())))
    redo = ~(bound > best)
    if redo.any():
        best[redo] = np.min(lnp(stat[:, redo], dof[:, None]), axis=0)
    return best


def _perm_spec_fn(mods):
    """The genotype-derived predictor columns of the permutation scans:
    spec_fn(group covariate names) -> ([(w_alt, w_ref, covar_idx), ...],
    joint-test q (0 when the primary test is a single effect)).
    `interaction` replicates each genotype predictor against every
    covariate column of the group (ploidy groups may drop constant
    covariates), in the main report's order."""
    geno_preds, joint_name = _geno_predictors(mods)
    interaction = "interaction" in mods

    def spec_fn(group_cov_names):
        specs = [(wa, wr, 0) for _n, wa, wr in geno_preds]
        if interaction:
            for _n, wa, wr in geno_preds:
                for j in range(len(group_cov_names)):
                    specs.append((wa, wr, j + 1))
        return specs, (len(geno_preds) if joint_name else 0)

    return spec_fn


def _perm_group_setups(ds, smask, groups, cov_names, cov_data, a1_is_alt,
                       spec_fn, capture):
    """Per ploidy group, its device state for the scans: the group's packed
    blocks (compacted to its samples on the device), padded covariates,
    mask, plane weights and genotype multiplier, and `sel`, the positions
    of its samples within the union ordering the phenotype is permuted
    over (ref GlmFirthPerm sample_include_union,
    2.0/plink2_glm_logistic.cc:6086-6104)."""
    dev = ds.device
    if groups is None:
        groups = [(ds.variant_mask, smask, cov_names, cov_data)]
    inc_u = np.flatnonzero(smask)
    pos_u = np.full(ds.raw_sample_ct, -1, np.int64)
    pos_u[inc_u] = np.arange(inc_u.size)
    M = ds.raw_variant_ct
    valid_all = capture["valid"] & ds.variant_mask
    test_rows = np.flatnonzero(valid_all)
    row_pos = np.full(M, -1, np.int64)
    row_pos[test_rows] = np.arange(test_rows.size)

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    setups = []
    q_joint = 0
    for grp in groups:
        vm_g, sm_g, nm_g, dt_g = grp[:4]
        gmul_g = grp[4] if len(grp) > 4 else None
        if not vm_g.any() or not sm_g.any():
            continue
        rows_g = np.flatnonzero(valid_all & vm_g)
        if rows_g.size == 0:
            continue
        nm_g, dt_g = _drop_const_covars(sm_g, nm_g, dt_g)
        specs, q_joint = spec_fn(nm_g)
        wa_all = np.asarray([s[0] for s in specs], np.float32)  # [NP, 3]
        wr_all = np.asarray([s[1] for s in specs], np.float32)
        inc_g = np.flatnonzero(sm_g)
        n_g = inc_g.size
        dc_g = len(nm_g) + 1
        pd_g = PackedDevice(ds, vm_g, vb=_auto_vb(-(-n_g // 4) * 4),
                            sample_mask=sm_g)
        npad_g = pd_g.npad
        mask_g = np.zeros(npad_g, np.float32)
        mask_g[:n_g] = 1.0
        cpad = np.zeros((npad_g, dc_g), np.float32)
        cpad[:n_g, 0] = 1.0
        cpad[:n_g, 1:] = dt_g[inc_g]
        alt_pad = np.zeros(pd_g.nblocks * pd_g.vb, bool)
        alt_pad[:M] = a1_is_alt
        alt_b = alt_pad.reshape(pd_g.nblocks, pd_g.vb)
        gw = np.where(alt_b[:, :, None, None], wa_all[None, None],
                      wr_all[None, None])  # [nb, vb, NP, 3]
        ss = None
        if gmul_g is not None:
            sp_ = np.ones(npad_g, np.float32)
            sp_[:n_g] = gmul_g[inc_g]
            ss = dev32(sp_)
        setups.append({
            "pd": pd_g, "dc": dc_g, "c": dev32(cpad), "mask": dev32(mask_g),
            "gw": dev32(gw), "sscale": ss, "n": n_g, "npad": npad_g,
            "sel": torch.from_numpy(pos_u[inc_g]).to(dev), "rows": rows_g,
            "row_pos": row_pos[rows_g], "covj": tuple(int(s[2]) for s in specs),
            "tested": torch.from_numpy(np.isin(
                np.arange(pd_g.nblocks * pd_g.vb), rows_g)
                .reshape(pd_g.nblocks, pd_g.vb)).to(dev),
        })
    return setups, test_rows, q_joint


def _batch_on_device(st, Yt, width=None):
    """The group's rows of the permuted batch Yt f32 [Bc, n_union] (on the
    device) as the scans take it: f32 [npad, width] (Bc columns unless
    given), padding rows and columns 0."""
    Bc = Yt.shape[0]
    Yb = torch.zeros((st["npad"], width or Bc), dtype=torch.float32,
                     device=Yt.device)
    Yb[: st["n"], :Bc] = Yt[:, st["sel"]].t()
    return Yb


def _adaptive_state(ds, aperm, T, perms_total):
    state = AdaptiveState(T, tuple(float(x) for x in aperm[:6]), perms_total)
    # the reference's zt takes the ORIGINAL allele-test count, not just the
    # valid tests (GlmLinearPerm adaptive_ci_zt, plink2_glm_linear.cc:5462)
    n_orig = int(np.count_nonzero(ds.variant_mask))
    state.zt = float(norm_ppf(1.0 - float(aperm[3]) / (2.0 * max(n_orig, 1))))
    return state


def _write_report(ds, cfg, log, path, a1_is_alt, valid, test_rows, adaptive,
                  state, ctx2, emp2, done):
    _chrom, provref, a1, omitted = _row_meta(ds, a1_is_alt)
    test_idx = np.full(ds.raw_variant_ct, -1, np.int64)
    test_idx[test_rows] = np.arange(test_rows.size)
    perm_count = "perm-count" in set(cfg.glm_modifiers)
    if adaptive:
        state.finish()
        write_perm_report(path, ds, ds.variant_mask, a1, omitted, provref, valid,
                          test_idx, True, state.ctx2, state.denom, done,
                          perm_count=perm_count, log=log)
    else:
        denom = np.full(test_rows.size, done + 1, np.int64)
        write_perm_report(path, ds, ds.variant_mask, a1, omitted, provref, valid,
                          test_idx, False, ctx2, denom, done, emp2_ctx2=emp2,
                          perm_count=perm_count, log=log)


def glm_linear_perm(ds, cfg, log, pheno_name, ydata, smask, cov_names,
                    cov_data, a1_is_alt, capture, perm_mode, mperm_ct,
                    groups=None):
    """The linear --glm permutation test (plink_tpu _glm_linear_perm):
    <out>.<pheno>.glm.linear.{mperm,aperm}.  EMP1 compares |t| (the joint
    F for genotypic / hethom) with the original report's; max(T)'s EMP2
    compares ln p."""
    from ..ops.glm import linear_perm_multi_scan, perm_batch_width, perm_inverses

    adaptive = perm_mode == "adaptive"
    aperm = cfg.aperm or _APERM_DEFAULT
    perms_total = int(aperm[1]) if adaptive else int(mperm_ct)
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float64)
    setups, test_rows, q_joint = _perm_group_setups(
        ds, smask, groups, cov_names, cov_data, a1_is_alt,
        _perm_spec_fn(set(cfg.glm_modifiers)), capture)
    valid = capture["valid"] & ds.variant_mask
    T = test_rows.size
    t_orig = np.abs(capture["t"][test_rows])
    lnp_orig = capture["lnp"][test_rows]
    dof = capture["dof"][test_rows]
    for st in setups:  # X^T X inverses, kept for every batch
        st["inv"] = perm_inverses(st["pd"].packed, st["gw"], st["c"], st["mask"],
                                  st["covj"], q_joint, st["sscale"])

    rng = np.random.default_rng(cfg.seed)
    B = min(max(16, min(256, (1 << 26) // max(n, 1))), perms_total)
    log.log(
        f"Starting {'adaptive' if adaptive else 'max(T)'} permutation for "
        f"phenotype '{pheno_name}' ({T} allele tests, "
        f"{'all' if T == np.count_nonzero(ds.variant_mask) else T} valid)."
    )
    state = _adaptive_state(ds, aperm, T, perms_total) if adaptive else None
    ctx2 = np.zeros(T, np.int64)
    best_lnp: list[np.ndarray] = []
    ys = y.astype(np.float32)
    done = 0
    while done < perms_total:
        if adaptive and state.remaining() == 0:
            break
        Bc = min(B, perms_total - done)
        Yt = np.empty((Bc, n), np.float32)
        for p in range(Bc):
            Yt[p] = rng.permutation(ys)
        Yt = torch.from_numpy(Yt).to(ds.device)
        # on the card, zero columns up to the width K19 reads without a
        # copy; their statistics are dropped
        width = perm_batch_width(Bc) if Yt.device.type == "cuda" else Bc
        tp = np.zeros((T, Bc), np.float64)
        for st in setups:
            pd_g = st["pd"]
            t_all = linear_perm_multi_scan(
                pd_g.packed, st["gw"], st["c"], _batch_on_device(st, Yt, width),
                st["mask"], st["dc"], st["covj"], q_joint, st["sscale"],
                inverses=st["inv"])[..., :Bc].cpu().numpy()
            sf = t_all.reshape(pd_g.nblocks * pd_g.vb, Bc)[st["rows"]]
            sf = sf.astype(np.float64)
            # joint models compare raw F (one-sided); single effects |t|
            tp[st["row_pos"]] = sf if q_joint else np.abs(sf)
        tp = np.nan_to_num(tp, nan=0.0, posinf=np.inf)
        cnt = ((tp > t_orig[:, None]).astype(np.int8) * 2
               + (tp == t_orig[:, None]).astype(np.int8))
        if adaptive:
            state.update(cnt)
        else:
            ctx2 += cnt.astype(np.int64).sum(axis=1)
            # per-permutation best ln p across the valid tests
            if q_joint:
                def lnp(s_, d_):
                    return np.asarray(f_logsf(np.maximum(s_, 0.0), float(q_joint),
                                              d_))
            else:
                def lnp(s_, d_):
                    return np.asarray(t_logp_2sided(s_, d_))
            best_lnp.append(_min_lnp(tp, dof, lnp) if T else np.full(Bc, np.inf))
        done += Bc

    emp2 = None
    if not adaptive:
        best = np.concatenate(best_lnp) if best_lnp else np.zeros(0)
        emp2 = emp2_from_best(lnp_orig, best, lower_is_extreme=True)
    suffix = "aperm" if adaptive else "mperm"
    _write_report(ds, cfg, log, f"{cfg.out}.{pheno_name}.glm.linear.{suffix}",
                  a1_is_alt, valid, test_rows, adaptive, state, ctx2, emp2, done)


def glm_firth_perm(ds, cfg, log, pheno_name, ydata, smask, cov_names,
                   cov_data, a1_is_alt, capture, perm_mode, mperm_ct,
                   groups=None):
    """The case/control (Firth) permutation test (plink_tpu
    _glm_firth_perm; ref GlmLogisticPerm, plink2_glm_logistic.cc:6342):
    <out>.<pheno>.glm.firth.{mperm,aperm}.  The statistic is |z| of the
    primary term (the joint Wald chisq / q for genotypic / hethom); ties
    count half; EMP2 from the per-permutation best."""
    from ..ops.glm import firth_perm_multi_scan

    adaptive = perm_mode == "adaptive"
    aperm = cfg.aperm or _APERM_DEFAULT
    perms_total = int(aperm[1]) if adaptive else int(mperm_ct)
    inc = np.flatnonzero(smask)
    n = inc.size
    y = ydata[inc].astype(np.float32)
    setups, test_rows, q_joint = _perm_group_setups(
        ds, smask, groups, cov_names, cov_data, a1_is_alt,
        _perm_spec_fn(set(cfg.glm_modifiers)), capture)
    valid = capture["valid"] & ds.variant_mask
    T = test_rows.size
    z_orig = capture["t"][test_rows]  # |z|, or joint chisq / q
    obs_orig = capture["dof"][test_rows]  # per-variant obs (joint EMP2)
    lnp_orig = capture["lnp"][test_rows]

    rng = np.random.default_rng(cfg.seed)
    B = min(max(4, min(64, (1 << 24) // max(n, 1))), perms_total)
    log.log(
        f"Starting {'adaptive' if adaptive else 'max(T)'} permutation for "
        f"phenotype '{pheno_name}' ({T} allele tests)."
    )
    state = _adaptive_state(ds, aperm, T, perms_total) if adaptive else None
    ctx2 = np.zeros(T, np.int64)
    best_z: list[np.ndarray] = []
    done = 0
    while done < perms_total:
        if adaptive and state.remaining() == 0:
            break
        Bc = min(B, perms_total - done)
        Yt = np.empty((Bc, n), np.float32)
        for p in range(Bc):
            Yt[p] = rng.permutation(y)
        Yt = torch.from_numpy(Yt).to(ds.device)
        sp = np.full((T, Bc), -1.0, np.float64)
        for st in setups:
            pd_g = st["pd"]
            stats = firth_perm_multi_scan(
                pd_g.packed, st["gw"], st["c"], _batch_on_device(st, Yt),
                st["mask"], st["dc"], st["covj"], q_joint, st["sscale"],
                rows=st["tested"]).cpu().numpy()  # [Bc, nb, vb]
            s_flat = stats.reshape(Bc, pd_g.nblocks * pd_g.vb).T
            sp[st["row_pos"]] = s_flat[st["rows"]].astype(np.float64)
        # 0/1 phenotypes make the statistic's distribution discrete: values
        # equal in the reference's f64 arithmetic land within f32 noise
        # here, so near-equality counts as a tie (the reference's
        # tie-as-half rule, plink2_glm_logistic.cc:6704)
        tol = 2e-3 * np.maximum(1.0, z_orig[:, None])
        cnt = ((sp > z_orig[:, None] + tol).astype(np.int8) * 2
               + (np.abs(sp - z_orig[:, None]) <= tol).astype(np.int8))
        if adaptive:
            state.update(cnt)
        else:
            ctx2 += cnt.astype(np.int64).sum(axis=1)
            if q_joint:
                # joint statistics: the variants' obs differ, so the best
                # across variants compares ln p (ref FstatToLnP permstat)
                def lnp(s_, d_):
                    out = np.asarray(f_logsf(np.maximum(s_, 0.0), float(q_joint),
                                             d_))
                    return np.where(s_ < 0.0, np.inf, out)  # failed fits

                best_z.append(_min_lnp(sp, np.maximum(obs_orig, 1.0), lnp)
                              if T else np.full(Bc, np.inf))
            else:
                best_z.append(np.max(sp, axis=0) if T else np.full(Bc, -1.0))
        done += Bc

    emp2 = None
    if not adaptive:
        best = np.concatenate(best_z) if best_z else np.zeros(0)
        if q_joint:
            emp2 = emp2_from_best(lnp_orig, best, lower_is_extreme=True)
        else:
            emp2 = emp2_from_best(z_orig, best, lower_is_extreme=False)
    suffix = "aperm" if adaptive else "mperm"
    _write_report(ds, cfg, log, f"{cfg.out}.{pheno_name}.glm.firth.{suffix}",
                  a1_is_alt, valid, test_rows, adaptive, state, ctx2, emp2, done)

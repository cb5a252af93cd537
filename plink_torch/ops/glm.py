"""GLM on the device: the linear sums (K6), kernels K2-K4 and K15-K16 with
the logistic-hybrid IRLS around them, the dosage kernels K17-K18, and the
--xchr-model 1 statistics (K14).

Counterparts of plink_tpu/ops/glm.py:
- `linear_sums` (K6, csrc/linear_sums.cu) for `_linear_sums_body`, and
  `linear_sums_scan` for `linear_sums_scan`;
- `glm_moments` (K2, csrc/glm_moments*.cu; K15, csrc/glm_wide.cu) for
  `_plane_cols` + `_moments_from_cols`, with P predictor columns, the
  covariate factors `covj` and the per-sample multiplier `sscale`;
- `glm_irls_pass` (K3, csrc/glm_irls*.cu; K16, csrc/glm_wide.cu) for the
  `_design_ops` contractions of one logistic or Firth IRLS evaluation,
  over the design [c | G_1..G_P] (each G_p optionally times a covariate
  column and s) or the residualized [G'_1..G'_P] of `_resid_body` with its
  fixed offset;
- `chol_small` (K4, csrc/chol_small.cu) for `_chol_small`,
  `_solve_psd`, `_inv_psd` and the Cholesky log-determinant;
- `glm_logistic_scan` / `firth_irls_block` / `design_moments_block` /
  `logistic_irls_block` for the entry points of the same names, with
  `_valid_params_flags` and `_collin_screen_device` as tensor ops on the
  device (no sample axis);
- `glm_resid_scan` / `resid_irls_block` for the cc-/firth-residualize
  entry points of the same names;
- `xm1_stats` (K14, csrc/xm1_stats.cu) and `xm1_stats_scan` for
  `xm1_stats_scan`;
- `glm_dense_moments` (K17) and `glm_dense_irls` (K18, csrc/glm_dense.cu)
  under `dense_qt_block` / `dense_cc_block` / `dense_firth_block`, the
  dosage GLM's blocks of the same names: the genotype column is a
  fractional A1 dosage, read as uint16 in 1/16384 units.

Each kernel wrapper takes the plain PyTorch version beside it for CPU
tensors and launches the kernel for CUDA tensors.  The logistic design is
[c (dc covariates incl. intercept) | G_1..G_P] with P genotype predictors
(1 for the additive, dominant, recessive and hetonly models, 2 for
genotypic and hethom, P (1 + k) under `interaction`, whose G x C columns
carry the covariate index `covj`); per-sample inputs travel as one table
feat = [c | y | mask] of shape [npad, dc + 2] (dc = 0 in the residualized
design: [y | mask]), and the optional per-sample multiplier s and offset as
f32 [npad] beside it.  Which kernel a design runs on is a rule on (P,
covj, d): `_register_kernel`.
"""

from __future__ import annotations

import numpy as np
import torch

from functools import partial

from . import _cuda
from .counts import geno_counts
from .planes import planes, unpack_codes

_GLM_MAXIT = 25  # ref: plink2_glm_logistic.cc "maxit = 25"
_FIRTH_MAXIT = 25
_Z_INIT = 4.863891244002886  # IRLS start: OLS on z = 4.8639 * (y - 0.5)
MAX_DC = 16  # widest covariate block K2 / K3 / K17 / K18 are instantiated for
# widest covariate block sent to the P = 2 register kernels (K2 at D = dc +
# 4, K3 at d = dc + 2): ptxas (sm_90a) gives every P = 2 instantiation up
# to dc = 14 <= 255 registers and no spill, K3 firth2 spills at dc = 15 and
# K3 at dc = 16; wider designs run on K15 / K16
P2_MAX_DC = 14


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask, device):
    """The numpy arrays `plink_tpu.ops.glm.glm_logistic_scan` takes, as the
    port's tensors on `device`: (blocks uint8 [nb, vb, NB], gws f32
    [nb, vb, 1, 3], gwms f32 [nb, vb, 2, 3], feat f32 [npad, dc + 2])."""
    c = np.asarray(c, np.float32)
    cy = np.asarray(cy, np.float32)
    if not np.array_equal(cy[:, : c.shape[1]], c):
        raise ValueError("cy must be [c | y]")
    feat = np.concatenate([cy, np.asarray(mask, np.float32)[:, None]], axis=1)

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    return (t(blocks, np.uint8), t(gws, np.float32), t(gwms, np.float32),
            t(feat, np.float32))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# Samples per split of the K2/K3 sample axis: each split's f32 accumulators
# sum at most this many samples (a sequential f32 sum of n positive terms
# drifts by ~n * eps: 4e-5 relative over 15,232 IRLS weights, ~5e-6 over
# 2,048), and a second pass adds the splits in f64.  A constant, so the
# summation order, hence every output byte, is the same on any card.
_SPLIT = 2048
# Samples per f32 run of K19 (csrc/linear_perm.cu), a quarter of _SPLIT: the
# tensor cores truncate as they accumulate, so a run of positive terms (the
# yy row) drifts low in proportion to its length, and at 2,048 samples that
# drift comes within a factor of two of chip_smoke's f64 tolerance (2e-5)
# (tools/k19_breakdown.py measures it); a run's end only adds each
# thread's sums into f64.
_PERM_RUN = 512


def _splits(npad: int) -> tuple[int, int]:
    """(samples per split, split count) for K2/K3; a split is whole
    128-sample shared-memory tiles."""
    split_len = min(_SPLIT, -(-npad // 128) * 128)
    return split_len, -(-npad // split_len)


# ---------------------------------------------------------------------------
# K6: linear sums
# ---------------------------------------------------------------------------


def linear_sums_plain(packed, ccfl, cy, y2, a1_ref=None):
    """Plain version of K6 (plink_tpu `_linear_sums_body`): the het,
    hom-A1 and missing planes of packed uint8 [vb, NB] against ccfl
    [npad, dc*dc] (c_j c_k), cy [npad, dc] (c_j y) and y2 [npad] (y^2),
    npad = 4*NB, in their float type.  The hom-A1 plane is the hom-ALT
    one, or the hom-REF one for the variants flagged in a1_ref bool [vb]
    (plink_tpu sums hom-ALT only; see csrc/linear_sums.cu for why the port
    orients).  Returns hcc/acc/mcc [vb, dc*dc], hcy/acy/mcy [vb, dc], myy
    [vb]."""
    codes = unpack_codes(packed)
    if a1_ref is not None:  # swap codes 0 and 2 of the flagged variants
        codes = torch.where(a1_ref[:, None] & (codes % 2 == 0), 2 - codes, codes)
    het, homa1, miss = ((codes == c).to(ccfl.dtype) for c in (1, 2, 3))
    return {"hcc": het @ ccfl, "acc": homa1 @ ccfl, "mcc": miss @ ccfl,
            "hcy": het @ cy, "acy": homa1 @ cy, "mcy": miss @ cy,
            "myy": miss @ y2}


def _linear_feat(ccfl, cy, y2):
    """K6's per-sample table [npad, nf]: c_j c_k for j <= k (row-major),
    then c_j y, then y^2; nf = dc(dc+1)/2 + dc + 1."""
    dc = cy.shape[1]
    j, k = torch.triu_indices(dc, dc, device=ccfl.device)
    return torch.cat([ccfl[:, j * dc + k], cy, y2[:, None]], dim=1).contiguous()


def linear_sums(packed, ccfl, cy, y2, a1_ref=None):
    """K6: the plane sums of `linear_sums_plain` for one variant block.
    packed uint8 [vb, NB], ccfl f32 [npad, dc*dc], cy f32 [npad, dc], y2 f32
    [npad], with padding samples zero in all three; a1_ref bool [vb] or
    None (no variant flagged).  CPU tensors take the plain version (in
    their float type); CUDA tensors launch the kernel, which sums at most
    2,048 samples per f32 accumulator, adds the splits in f64 and returns
    f64."""
    vb, nb = packed.shape
    dc = cy.shape[1]
    dev = packed.device
    _check("linear_sums packed", packed, torch.uint8, (vb, nb), dev)
    _check("linear_sums ccfl", ccfl, torch.float32, (4 * nb, dc * dc), dev)
    _check("linear_sums cy", cy, torch.float32, (4 * nb, dc), dev)
    _check("linear_sums y2", y2, torch.float32, (4 * nb,), dev)
    if a1_ref is not None:
        _check("linear_sums a1_ref", a1_ref, torch.bool, (vb,), dev)
    if dev.type == "cpu":
        return linear_sums_plain(packed, ccfl, cy, y2, a1_ref)
    if dev.type != "cuda" or dc < 1:
        raise ValueError(f"linear_sums: {dev}, {dc} covariate columns")
    feat = _linear_feat(ccfl, cy, y2)
    split_len, splits = _splits(4 * nb)
    part = torch.empty((splits, 3, vb, feat.shape[1]), dtype=torch.float32,
                       device=dev)
    out = torch.empty((3, vb, dc * dc + dc + 1), dtype=torch.float64, device=dev)
    flags = None if a1_ref is None else a1_ref.to(torch.uint8)
    _cuda.launch("linear_sums", packed.data_ptr(), nb, vb, _cuda.ptr(flags),
                 feat.data_ptr(), dc, split_len, splits, part.data_ptr(),
                 out.data_ptr())
    d2 = dc * dc
    return {"hcc": out[0, :, :d2], "acc": out[1, :, :d2], "mcc": out[2, :, :d2],
            "hcy": out[0, :, d2:d2 + dc], "acy": out[1, :, d2:d2 + dc],
            "mcy": out[2, :, d2:d2 + dc], "myy": out[2, :, -1]}


def linear_sums_scan(blocks, ccfl, cy, y2, a1_ref=None):
    """Whole-dataset linear sums (plink_tpu `linear_sums_scan`): K6 per
    block of blocks uint8 [nb, vb, NB], with a1_ref bool [nb, vb] or None;
    returns the dict of `linear_sums` stacked to [nb, vb, ...]."""
    outs = [linear_sums(blocks[bi], ccfl, cy, y2,
                        None if a1_ref is None else a1_ref[bi])
            for bi in range(blocks.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# predictor columns and the kernel each design runs on
# ---------------------------------------------------------------------------


def _gw3(gw):
    """Plane weights as [vb, P, 3] (a [vb, 3] tensor is the one-column
    design)."""
    return gw[:, None, :] if gw.dim() == 2 else gw


def _covj(covj, npr):
    """The per-predictor covariate column of `_plane_cols` as a tuple of
    npr ints (0: no covariate factor)."""
    covj = tuple(int(j) for j in covj) if covj else (0,) * npr
    if len(covj) != npr:
        raise ValueError(f"covj has {len(covj)} entries for {npr} predictors")
    return covj


def _plane_cols(packed, gw3, table, mask, covj, sscale=None):
    """Plain decode (plink_tpu `_plane_cols`): the valid plane and the
    predictor columns G_p = (wH het + wA homalt + wV valid) * table[:,
    covj_p] (when covj_p > 0) * sscale, each [vb, npad]."""
    valid, het, homalt = planes(packed, mask)
    gcols = []
    for p in range(gw3.shape[1]):
        g = (gw3[:, p, 0:1] * het + gw3[:, p, 1:2] * homalt
             + gw3[:, p, 2:3] * valid)
        if covj[p]:
            g = g * table[None, :, covj[p]]
        if sscale is not None:
            g = g * sscale[None, :]
        gcols.append(g)
    return valid, gcols


def _register_kernel(P, covj, dc, sscale):
    """Whether the thread-per-variant K2 / K3 take a design of P genotype
    columns over dc covariate columns (`dc` counts y for K2): P = 1 at
    1 <= dc <= MAX_DC (also scaled), P = 2 unscaled at 1 <= dc <=
    P2_MAX_DC; no covariate factor.  Everything else runs on K15 / K16."""
    if any(covj):
        return False
    if P == 1:
        return 1 <= dc <= MAX_DC
    return P == 2 and sscale is None and 1 <= dc <= P2_MAX_DC


# ---------------------------------------------------------------------------
# K2 / K15: moments
# ---------------------------------------------------------------------------


def _moments_from_cols(gcols, valid, cy):
    """Per-variant X^T X over valid samples of [cy | G_1..G_P] from decoded
    predictor columns -> [vb, D, D] (plain matmul form)."""
    vb, n = valid.shape
    nc = cy.shape[1]
    D = nc + len(gcols)
    ccfl = (cy[:, :, None] * cy[:, None, :]).reshape(n, nc * nc)
    h = torch.zeros((vb, D, D), dtype=valid.dtype, device=valid.device)
    h[:, :nc, :nc] = (valid @ ccfl).reshape(vb, nc, nc)
    for p, gp in enumerate(gcols):
        cg = gp @ cy
        h[:, :nc, nc + p] = cg
        h[:, nc + p, :nc] = cg
        for q in range(p, len(gcols)):
            gg = (gp * gcols[q]).sum(dim=1)
            h[:, nc + p, nc + q] = gg
            h[:, nc + q, nc + p] = gg
    return h


def glm_moments_plain(packed, gwm, feat, sscale=None, covj=None):
    dc = feat.shape[1] - 2
    cy = feat[:, : dc + 1]
    valid, gcols = _plane_cols(packed, gwm, cy, feat[:, dc + 1],
                               _covj(covj, gwm.shape[1]), sscale)
    return _moments_from_cols(gcols, valid, cy)


def glm_moments(packed, gwm, feat, sscale=None, covj=None):
    """K2 / K15: packed uint8 [vb, NB], gwm f32 [vb, NP, 3] (the model's
    predictors, then ADD), feat f32 [4*NB, dc+2] -> momy f32 [vb, D, D],
    D = dc + 1 + NP, over the design [c | y | G_1 .. G_NP]; with sscale f32
    [4*NB] (the scaled mode) every predictor column is multiplied by it, and
    covj (NP ints) multiplies column p by feat[:, covj[p]] when covj[p] > 0.
    K2 (csrc/glm_moments.cu, glm_moments_p2.cu) takes NP = 2, and NP = 3
    unscaled, with no covariate factor; K15 (csrc/glm_wide.cu) takes the
    rest, at any width."""
    vb, nb = packed.shape
    dc = feat.shape[1] - 2
    dev = packed.device
    npr = gwm.shape[1]
    _check("glm_moments packed", packed, torch.uint8, (vb, nb), dev)
    _check("glm_moments gwm", gwm, torch.float32, (vb, npr, 3), dev)
    _check("glm_moments feat", feat, torch.float32, (4 * nb, dc + 2), dev)
    if sscale is not None:
        _check("glm_moments sscale", sscale, torch.float32, (4 * nb,), dev)
    covj = _covj(covj, npr)
    if max(covj) > dc:
        raise ValueError(f"glm_moments: covj {covj} beyond the {dc} covariates")
    if dev.type == "cpu":
        return glm_moments_plain(packed, gwm, feat, sscale, covj)
    if dev.type != "cuda":
        raise ValueError(f"glm_moments: unsupported device {dev}")
    D = dc + 1 + npr
    split_len, splits = _splits(4 * nb)
    out = torch.empty((vb, D, D), dtype=torch.float32, device=dev)
    if _register_kernel(npr - 1, covj, dc, sscale):
        part = torch.empty((splits, D * (D + 1) // 2, vb), dtype=torch.float32,
                           device=dev)
        if npr == 3:
            _cuda.launch("glm_moments_p2", packed.data_ptr(), nb, vb,
                         feat.data_ptr(), 4 * nb, dc, split_len, splits,
                         gwm.data_ptr(), part.data_ptr(), out.data_ptr())
        else:
            _cuda.launch("glm_moments" if sscale is None else "glm_moments_scaled",
                         packed.data_ptr(), nb, vb, feat.data_ptr(), 4 * nb, dc,
                         split_len, splits, gwm.data_ptr(), _cuda.ptr(sscale),
                         part.data_ptr(), out.data_ptr())
        return out
    _wide(2, packed, feat, dc + 1, gwm, covj, split_len, splits, sscale=sscale,
          out_mat=out)
    return out


def _wide(mode, packed, feat, nc, gw3, covj, split_len, splits, beta=None,
          hinv=None, active=None, sscale=None, out_mat=None, out_vec=None,
          out_ll=None, dos=None):
    """One K15 (mode 2) or K16 (0 logistic, 1 firth2) launch; with dos u16
    [vb, npad] (and packed None) their dense mode."""
    vb = dos.shape[0] if packed is None else packed.shape[0]
    nb = dos.shape[1] // 4 if packed is None else packed.shape[1]
    np_ = gw3.shape[1]
    D = nc + np_
    nt = D * (D + 1) // 2 + (0 if mode == 2 else D)
    dev = feat.device
    part = torch.empty((splits, nt, vb), dtype=torch.float32, device=dev)
    part_ll = torch.empty((splits, vb), dtype=torch.float64, device=dev) \
        if mode == 0 else None
    cj = torch.tensor(covj, dtype=torch.int32, device=dev)
    act = None if active is None else active.to(torch.uint8)
    _cuda.launch("glm_moments_wide" if mode == 2 else "glm_irls_wide",
                 _cuda.ptr(packed), nb, vb, feat.data_ptr(), feat.shape[0], nc,
                 np_, cj.data_ptr(), mode, split_len, splits, gw3.data_ptr(),
                 _cuda.ptr(beta), _cuda.ptr(hinv), _cuda.ptr(act),
                 _cuda.ptr(sscale), _cuda.ptr(dos), part.data_ptr(),
                 _cuda.ptr(part_ll), out_mat.data_ptr(), _cuda.ptr(out_vec),
                 _cuda.ptr(out_ll))


# ---------------------------------------------------------------------------
# K3 / K16: one IRLS evaluation
# ---------------------------------------------------------------------------


def _softplus(x):
    # jax.nn.softplus = logaddexp(x, 0); torch's softplus has a threshold
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _loglik(yv, valid, eta):
    """sum_s [yv log p + (valid - yv) log(1 - p)] in f64: the per-sample
    terms in the input's type, added and returned in f64 as K3 does (see
    csrc/glm_irls.cu for why not plink_tpu's f32 128-sample chunks)."""
    ll = yv * (-_softplus(-eta)) + (valid - yv) * (-_softplus(eta))
    return ll.to(torch.float64).sum(dim=1)


def _hessian(w, c, gcols):
    """sum_s w x x^T over [c | G_1..G_P] -> [vb, d, d]."""
    vb, n = w.shape
    dc = c.shape[1]
    d = dc + len(gcols)
    ccfl = (c[:, :, None] * c[:, None, :]).reshape(n, dc * dc)
    h = torch.empty((vb, d, d), dtype=w.dtype, device=w.device)
    h[:, :dc, :dc] = (w @ ccfl).reshape(vb, dc, dc)
    P = len(gcols)
    # G columns a step of the G block takes: a [vb, step, n] temporary of at
    # most 2^22 entries, cache-sized (one column at a time at biobank n)
    step = max(1, (1 << 22) // max(vb * n, 1))
    for p, g in enumerate(gcols):
        wg = w * g
        cg = wg @ c
        h[:, :dc, dc + p] = cg
        h[:, dc + p, :dc] = cg
        for q0 in range(p, P, step):  # entry (p, q): (wg * G_q).sum(dim=1)
            q1 = min(P, q0 + step)
            gg = (wg[:, None, :] * torch.stack(gcols[q0:q1], 1)).sum(dim=2)
            h[:, dc + p, dc + q0:dc + q1] = gg
            h[:, dc + q0:dc + q1, dc + p] = gg
    return h


def _xtv(r, c, gcols):
    return torch.cat([r @ c] + [(r * g).sum(dim=1, keepdim=True) for g in gcols],
                     dim=1)


def glm_irls_pass_plain(packed, gw, feat, beta, active, hinv=None,
                        sscale=None, offset=None, gmean=None, covj=None):
    gw3 = _gw3(gw)
    P = gw3.shape[1]
    dc = feat.shape[1] - 2
    c, y = feat[:, :dc], feat[:, dc]
    valid, gcols = _plane_cols(packed, gw3, c, feat[:, dc + 1], _covj(covj, P),
                               sscale)
    if gmean is not None:
        gm = gmean.reshape(-1, P)
        gcols = [(g - gm[:, p, None]) * valid for p, g in enumerate(gcols)]
    return _irls_plain(valid, gcols, c, y, beta, active, hinv, offset)


def _irls_plain(valid, gcols, c, y, beta, active, hinv=None, offset=None):
    """One IRLS evaluation over [c | G_1..G_P] from decoded columns (the
    plain versions of K3 / K16 / K18)."""
    dc = c.shape[1]
    eta = beta[:, :dc] @ c.t()
    for p, g in enumerate(gcols):
        eta = eta + beta[:, dc + p : dc + p + 1] * g
    if offset is not None:
        eta = eta + offset[None, :]
    eta = eta * valid
    yv = y[None, :] * valid
    # 1 - p as sigmoid(-eta) (no cancellation at large |eta|); y is 0/1
    sg, q = torch.sigmoid(eta), torch.sigmoid(-eta)
    p_ = sg * valid
    y_minus_p = torch.where(yv != 0, q * valid, -p_)
    ll = None
    if hinv is None:
        ll = _loglik(yv, valid, eta)
        w = sg * q * valid
        r = -y_minus_p
    else:
        v = sg * q * valid
        # h_s = v_s x_s^T Hinv x_s without materialising [vb, n, d]
        ccfl = (c[:, :, None] * c[:, None, :]).reshape(c.shape[0], dc * dc)
        quad = hinv[:, :dc, :dc].reshape(hinv.shape[0], dc * dc) @ ccfl.t()
        for p, g in enumerate(gcols):
            quad = quad + 2.0 * g * (hinv[:, :dc, dc + p] @ c.t())
        for p, g in enumerate(gcols):  # the symmetric G block, once a pair
            for q2 in range(p, len(gcols)):
                quad = quad + ((1.0 if q2 == p else 2.0) * g * gcols[q2]
                               * hinv[:, dc + p, dc + q2 : dc + q2 + 1])
        hd = v * quad
        r = (y_minus_p + hd * (0.5 - p_)) * valid
        w = (1.0 + hd) * v
    mat, vec = _hessian(w, c, gcols), _xtv(r, c, gcols)
    on = active.to(torch.bool)
    mat = torch.where(on[:, None, None], mat, torch.zeros_like(mat))
    vec = torch.where(on[:, None], vec, torch.zeros_like(vec))
    if ll is not None:
        ll = torch.where(on, ll, torch.zeros_like(ll))
    return mat, vec, ll


def glm_irls_pass(packed, gw, feat, beta, active, hinv=None, sscale=None,
                  offset=None, gmean=None, covj=None):
    """K3 / K16: one fused IRLS evaluation at `beta` for the rows with
    `active`.

    packed uint8 [vb, NB], gw f32 [vb, 3] or [vb, P, 3] (P genotype
    columns), feat f32 [4*NB, dc+2], beta f32 [vb, d], active bool [vb];
    d = dc + P.  Logistic mode (hinv None): returns (H = X^T W X,
    X^T (p - y), loglik f64).  firth2 mode (hinv = H0^-1 [vb, d, d]): returns
    (X^T diag((1+h) v) X, ustar, None).  Inactive rows come back as zeros.

    sscale f32 [4*NB] multiplies every G (scaled design); covj (P ints)
    multiplies G_p by feat[:, covj[p]] when covj[p] > 0 (interaction terms).
    gmean f32 [vb, P] (or [vb] for P = 1) selects the residualized design
    (feat = [y | mask], dc = 0, d = P): the columns are (G_p - gmean_p) *
    valid and offset f32 [4*NB], which it requires, enters the linear
    predictor.  K3 (csrc/glm_irls*.cu) takes P = 1 and, unscaled, P = 2
    with no covariate factor, and the residualized designs; K16
    (csrc/glm_wide.cu) the rest, at any width."""
    vb, nb = packed.shape
    gw3 = _gw3(gw)
    P = gw3.shape[1]
    dc = feat.shape[1] - 2
    d = dc + P
    dev = packed.device
    resid = gmean is not None
    _check("glm_irls_pass packed", packed, torch.uint8, (vb, nb), dev)
    _check("glm_irls_pass gw", gw3, torch.float32, (vb, P, 3), dev)
    _check("glm_irls_pass feat", feat, torch.float32, (4 * nb, dc + 2), dev)
    _check("glm_irls_pass beta", beta, torch.float32, (vb, d), dev)
    _check("glm_irls_pass active", active, torch.bool, (vb,), dev)
    if hinv is not None:
        _check("glm_irls_pass hinv", hinv, torch.float32, (vb, d, d), dev)
    if sscale is not None:
        _check("glm_irls_pass sscale", sscale, torch.float32, (4 * nb,), dev)
    covj = _covj(covj, P)
    if max(covj) >= max(dc, 1):
        raise ValueError(f"glm_irls_pass: covj {covj} beyond the {dc} covariates")
    if resid != (offset is not None) or (resid and (dc != 0 or any(covj)
                                                    or P > 2)):
        raise ValueError("glm_irls_pass: gmean and offset go together, in the "
                         "residualized design (feat = [y | mask], P <= 2, no "
                         "covariate factor)")
    if resid:
        _check("glm_irls_pass gmean", gmean.reshape(vb, P), torch.float32,
               (vb, P), dev)
        _check("glm_irls_pass offset", offset, torch.float32, (4 * nb,), dev)
    if dev.type == "cpu":
        return glm_irls_pass_plain(packed, gw3, feat, beta, active, hinv,
                                   sscale, offset, gmean, covj)
    if dev.type != "cuda":
        raise ValueError(f"glm_irls_pass: unsupported device {dev}")
    mode = 0 if hinv is None else 1
    split_len, splits = _splits(4 * nb)
    mat = torch.empty((vb, d, d), dtype=torch.float32, device=dev)
    vec = torch.empty((vb, d), dtype=torch.float32, device=dev)
    ll = torch.empty(vb, dtype=torch.float64, device=dev) if mode == 0 else None
    if not resid and not _register_kernel(P, covj, dc, sscale):
        _wide(mode, packed, feat, dc, gw3, covj, split_len, splits, beta=beta,
              hinv=hinv, active=active, sscale=sscale, out_mat=mat,
              out_vec=vec, out_ll=ll)
        return mat, vec, ll
    nt = d * (d + 1) // 2 + d
    part = torch.empty((splits, nt, vb), dtype=torch.float32, device=dev)
    part_ll = torch.empty((splits, vb), dtype=torch.float64, device=dev) \
        if mode == 0 else None
    act = active.to(torch.uint8)
    if P == 1 and sscale is None and not resid:
        _cuda.launch("glm_irls", packed.data_ptr(), nb, vb, feat.data_ptr(),
                     4 * nb, dc, mode, split_len, splits, gw3.data_ptr(),
                     beta.data_ptr(), _cuda.ptr(hinv), act.data_ptr(),
                     part.data_ptr(), _cuda.ptr(part_ll), mat.data_ptr(),
                     vec.data_ptr(), _cuda.ptr(ll))
        return mat, vec, ll
    flags = (1 if sscale is not None else 0) | (2 if resid else 0)
    if P == 1:
        name = "glm_irls_resid" if resid else "glm_irls_scaled"
    else:
        name = "glm_irls_resid_p2" if resid else "glm_irls_p2"
    _cuda.launch(name, packed.data_ptr(), nb, vb, feat.data_ptr(), 4 * nb, dc,
                 mode, flags, split_len, splits, gw3.data_ptr(),
                 beta.data_ptr(), _cuda.ptr(hinv), act.data_ptr(),
                 _cuda.ptr(sscale), _cuda.ptr(offset), _cuda.ptr(gmean),
                 part.data_ptr(), _cuda.ptr(part_ll), mat.data_ptr(),
                 vec.data_ptr(), _cuda.ptr(ll))
    return mat, vec, ll


# ---------------------------------------------------------------------------
# K17 / K18: the dosage design
# ---------------------------------------------------------------------------

DOSAGE_MISSING = 65535  # the uint16 dosage of a missing call (and padding)


def _dense_cols(dos, mask):
    """valid [vb, npad] and the A1 dosage column g = u / 16384 * valid from
    the uint16 dosages, in f32 (exact)."""
    valid = (dos != DOSAGE_MISSING).to(torch.float32) * mask[None, :]
    return valid, dos.to(torch.float32) * (1.0 / 16384.0) * valid


def _check_dense(name, dos, feat):
    vb, npad = dos.shape
    dev = dos.device
    _check(f"{name} dos", dos, torch.uint16, (vb, npad), dev)
    _check(f"{name} feat", feat, torch.float32, (npad, feat.shape[1]), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return vb, npad, feat.shape[1] - 2


def glm_dense_moments_plain(dos, feat):
    dc = feat.shape[1] - 2
    valid, g = _dense_cols(dos, feat[:, dc + 1])
    return _moments_from_cols([g], valid, feat[:, : dc + 1])


def glm_dense_moments(dos, feat):
    """K17: per variant the moments sum_s valid x x^T over x = [c | y | g]
    -> f32 [vb, dc+2, dc+2], from dos uint16 [vb, npad] (A1 dosage in
    1/16384 units, DOSAGE_MISSING where missing and in the padding) and feat
    f32 [npad, dc+2] = [c | y | mask].  CPU tensors take the plain version;
    CUDA tensors launch K17 (csrc/glm_dense.cu) at dc <= MAX_DC and K15's
    dense mode above."""
    vb, npad, dc = _check_dense("glm_dense_moments", dos, feat)
    if dos.device.type == "cpu":
        return glm_dense_moments_plain(dos, feat)
    D = dc + 2
    split_len, splits = _splits(npad)
    out = torch.empty((vb, D, D), dtype=torch.float32, device=dos.device)
    if dc > MAX_DC:
        _wide(2, None, feat, dc + 1, _dense_gw(vb, dos.device), (0,), split_len,
              splits, out_mat=out, dos=dos)
        return out
    part = torch.empty((splits, D * (D + 1) // 2, vb), dtype=torch.float32,
                       device=dos.device)
    _cuda.launch("glm_dense_moments", dos.data_ptr(), vb, feat.data_ptr(), npad,
                 dc, split_len, splits, part.data_ptr(), out.data_ptr())
    return out


def _dense_gw(vb, dev):
    """K15 / K16's plane weights of the dense mode: g enters as the het
    plane."""
    return torch.tensor([1.0, 0.0, 0.0], device=dev).expand(vb, 1, 3).contiguous()


def glm_dense_irls_plain(dos, feat, beta, active, hinv=None):
    dc = feat.shape[1] - 2
    valid, g = _dense_cols(dos, feat[:, dc + 1])
    return _irls_plain(valid, [g], feat[:, :dc], feat[:, dc], beta, active, hinv)


def glm_dense_irls(dos, feat, beta, active, hinv=None):
    """K18: one logistic (hinv None) or firth2 IRLS evaluation over the
    dosage design [c | g], as glm_irls_pass over [c | G]: dos and feat as in
    glm_dense_moments, beta f32 [vb, dc+1], active bool [vb], hinv f32
    [vb, d, d].  CPU tensors take the plain version; CUDA tensors launch
    K18 (csrc/glm_dense.cu; firth2 counted as glm_dense_firth) at dc <=
    MAX_DC and K16's dense mode above."""
    vb, npad, dc = _check_dense("glm_dense_irls", dos, feat)
    d = dc + 1
    dev = dos.device
    _check("glm_dense_irls beta", beta, torch.float32, (vb, d), dev)
    _check("glm_dense_irls active", active, torch.bool, (vb,), dev)
    if hinv is not None:
        _check("glm_dense_irls hinv", hinv, torch.float32, (vb, d, d), dev)
    if dev.type == "cpu":
        return glm_dense_irls_plain(dos, feat, beta, active, hinv)
    mode = 0 if hinv is None else 1
    split_len, splits = _splits(npad)
    mat = torch.empty((vb, d, d), dtype=torch.float32, device=dev)
    vec = torch.empty((vb, d), dtype=torch.float32, device=dev)
    ll = torch.empty(vb, dtype=torch.float64, device=dev) if mode == 0 else None
    if dc > MAX_DC:
        _wide(mode, None, feat, dc, _dense_gw(vb, dev), (0,), split_len, splits,
              beta=beta, hinv=hinv, active=active, out_mat=mat, out_vec=vec,
              out_ll=ll, dos=dos)
        return mat, vec, ll
    part = torch.empty((splits, d * (d + 1) // 2 + d, vb), dtype=torch.float32,
                       device=dev)
    part_ll = torch.empty((splits, vb), dtype=torch.float64, device=dev) \
        if mode == 0 else None
    _cuda.launch("glm_dense_irls" if mode == 0 else "glm_dense_firth",
                 dos.data_ptr(), vb, feat.data_ptr(), npad, dc, mode, split_len,
                 splits, beta.data_ptr(), _cuda.ptr(hinv),
                 active.to(torch.uint8).data_ptr(), part.data_ptr(),
                 _cuda.ptr(part_ll), mat.data_ptr(), vec.data_ptr(),
                 _cuda.ptr(ll))
    return mat, vec, ll


def _dense_obs(dos, feat):
    """Valid samples per variant (a tensor op: the count is exact)."""
    return ((dos != DOSAGE_MISSING) & (feat[:, -1] > 0)[None, :]).sum(
        dim=1).to(torch.float32)


def dense_qt_block(dos, feat):
    """plink_tpu dense_qt_block: per variant of a dosage block the OLS
    sufficient statistics (X^T X [vb, d, d] over [c | g], X^T y [vb, d],
    y'y, sum g, sum g^2, obs), all read from one K17 pass; c[:, 0] is the
    intercept."""
    dc = feat.shape[1] - 2
    m = glm_dense_moments(dos, feat)
    idx = list(range(dc)) + [dc + 1]
    return (m[:, idx][:, :, idx].contiguous(), m[:, idx, dc].contiguous(),
            m[:, dc, dc], m[:, 0, dc + 1], m[:, dc + 1, dc + 1], m[:, 0, 0])


def dense_cc_block(dos, feat, firth=False):
    """plink_tpu dense_cc_block: one dosage case/control block.  K17 gives
    X^T X over [c | g], sum g y, sum g, sum g^2 and the OLS start; the
    logistic (with `firth`, the Firth) IRLS runs on K18 and K4.  Returns
    (xtx, g_case, g_tot, g_ssq, beta, se, conv, fail, unf, obs, invalid)."""
    vb = dos.shape[0]
    dc = feat.shape[1] - 2
    d = dc + 1
    m = glm_dense_moments(dos, feat)
    idx = list(range(dc)) + [dc + 1]
    active = torch.ones(vb, dtype=torch.bool, device=dos.device)
    irls = partial(glm_dense_irls, dos, feat)
    if firth:
        res = _firth_core(irls, vb, d, active)
    else:
        h0, rhs0 = _ols_start(m, dc, 1)
        res = _logistic_core(irls, h0, rhs0, active)
    beta, se, _ll, conv, fail, unf, hinv = res
    return (m[:, idx][:, :, idx].contiguous(), m[:, dc, dc + 1], m[:, 0, dc + 1],
            m[:, dc + 1, dc + 1], beta, se, conv, fail, unf, m[:, 0, 0],
            _valid_params_flags(hinv, d))


def dense_firth_block(dos, feat, active=None):
    """plink_tpu dense_firth_block: Firth regression over a dosage block
    (the hybrid's second pass) for the rows in `active` (all when None), on
    K18 and K4.  Returns (beta, se, conv, fail, unf, obs, invalid)."""
    vb = dos.shape[0]
    d = feat.shape[1] - 1
    if active is None:
        active = torch.ones(vb, dtype=torch.bool, device=dos.device)
    beta, se, _pll, conv, fail, unf, h2inv = _firth_core(
        partial(glm_dense_irls, dos, feat), vb, d, active)
    return (beta, se, conv, fail, unf, _dense_obs(dos, feat),
            _valid_params_flags(h2inv, d))


# ---------------------------------------------------------------------------
# K4: batched small Cholesky
# ---------------------------------------------------------------------------


def chol_small_plain(h, rhs=None, inverse=False, logdet=False):
    vb, d, _ = h.shape
    L = torch.zeros_like(h)
    ok = torch.ones(vb, dtype=torch.bool, device=h.device)
    one = torch.ones(vb, dtype=h.dtype, device=h.device)
    for j in range(d):
        s = h[:, j, j] - (L[:, j, :j] * L[:, j, :j]).sum(dim=1)
        ok &= s > 0
        ljj = torch.sqrt(torch.where(s > 0, s, one))
        L[:, j, j] = ljj
        if j + 1 < d:
            t = h[:, j + 1:, j] - (L[:, j + 1:, :j] @ L[:, j, :j, None])[..., 0]
            L[:, j + 1:, j] = t * (1.0 / ljj)[:, None]
    diag = torch.diagonal(L, dim1=1, dim2=2)
    nan = torch.tensor(float("nan"), dtype=h.dtype, device=h.device)
    x = inv = ld = None
    if rhs is not None:
        y = torch.zeros_like(rhs)
        for i in range(d):
            y[:, i] = (rhs[:, i] - (L[:, i, :i] * y[:, :i]).sum(dim=1)) / diag[:, i]
        for i in reversed(range(d)):
            y[:, i] = (y[:, i] - (L[:, i + 1:, i] * y[:, i + 1:]).sum(dim=1)) \
                / diag[:, i]
        x = torch.where(ok[:, None], y, nan)
    if inverse:
        M = torch.zeros_like(h)  # L^-1, row by row
        for i in range(d):
            M[:, i, i] = 1.0 / diag[:, i]
            if i:
                M[:, i, :i] = -(L[:, i, None, :i] @ M[:, :i, :i])[:, 0] \
                    / diag[:, i, None]
        inv = torch.where(ok[:, None, None], M.transpose(1, 2) @ M, nan)
    if logdet:
        ld = torch.where(ok, 2.0 * torch.log(diag).sum(dim=1), nan)
    return x, inv, ld


# bytes of shared memory K4's block mode may hold a matrix in
# (csrc/chol_small.cu kCholSmemMax); above, it works in device memory
_CHOL_SMEM_MAX = 227 * 1024 - 64


def chol_small(h, rhs=None, inverse=False, logdet=False):
    """K4: batched Cholesky of SPD h f32 [vb, d, d] (any d: one thread per
    matrix up to d = 48, one block per matrix above, counted as mode
    chol_small_wide, with a device-memory workspace above d = 240).
    Returns (h^-1 rhs [vb, d] if rhs is given, h^-1 [vb, d, d] if inverse,
    log det h [vb] if logdet), None for what was not asked; rows that are
    not positive definite come back NaN."""
    vb, d, _ = h.shape
    dev = h.device
    _check("chol_small h", h, torch.float32, (vb, d, d), dev)
    if rhs is not None:
        _check("chol_small rhs", rhs, torch.float32, (vb, d), dev)
    if dev.type == "cpu":
        return chol_small_plain(h, rhs, inverse, logdet)
    if dev.type != "cuda":
        raise ValueError(f"chol_small: unsupported device {dev}")
    x = torch.empty((vb, d), dtype=torch.float32, device=dev) \
        if rhs is not None else None
    inv = torch.empty((vb, d, d), dtype=torch.float32, device=dev) \
        if inverse else None
    ld = torch.empty(vb, dtype=torch.float32, device=dev) if logdet else None
    per = d * (d + 1) + d  # one matrix's L, L^-1 and solve vector
    ws = torch.empty((vb, per), dtype=torch.float32, device=dev) \
        if d > 48 and 4 * per > _CHOL_SMEM_MAX else None
    _cuda.launch("chol_small" if d <= 48 else "chol_small_wide", h.data_ptr(),
                 vb, d, _cuda.ptr(rhs), _cuda.ptr(x), _cuda.ptr(inv),
                 _cuda.ptr(ld), _cuda.ptr(ws))
    return x, inv, ld


# ---------------------------------------------------------------------------
# IRLS loops
# ---------------------------------------------------------------------------


def _diag(m):
    return torch.diagonal(m, dim1=1, dim2=2)


def _logistic_core(irls, h0, rhs0, active):
    """Batched logistic IRLS (plink_tpu _logistic_core) from the normal
    equations (h0, rhs0) of the OLS start.  Each call irls(beta, active)
    (K3 / K16 / K18 logistic mode: glm_irls_pass or glm_dense_irls with the
    design bound) at beta_k gives H_k, the gradient and ll_k; convergence
    compares ll_{k+1} with ll_k, with the step-size fallback, and the
    reported SE comes from H of the last solve.  Returns (beta, se, ll,
    conv, failed, unfinished, hinv)."""
    vb, d = rhs0.shape
    dev = rhs0.device
    beta, _, _ = chol_small(h0, rhs=rhs0)
    H, g, ll_old = irls(beta, active)
    failed = torch.isnan(ll_old)
    done = failed | ~active
    conv = torch.zeros_like(done)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    h_last = eye.expand(vb, d, d).clone()
    it = 1
    while it < _GLM_MAXIT and not bool(done.all()):
        dbeta, _, _ = chol_small(H, rhs=g)
        beta_new = beta - dbeta
        upd = ~done
        Hn, gn, ll = irls(beta_new, upd)
        new_failed = torch.isnan(ll) | torch.isnan(dbeta).any(dim=1)
        new_conv = ((ll - ll_old).abs() < 1e-8 * (0.05 + ll.abs())) | (
            dbeta.abs().amax(dim=1)
            < 1e-6 * torch.clamp(beta_new.abs().amax(dim=1), min=1.0))
        beta = torch.where(upd[:, None], beta_new, beta)
        ll_old = torch.where(upd, ll, ll_old)
        conv = conv | (upd & new_conv & ~new_failed)
        failed = failed | (upd & new_failed)
        done = done | new_conv | new_failed
        h_last = torch.where(upd[:, None, None], H, h_last)
        H = torch.where(upd[:, None, None], Hn, H)
        g = torch.where(upd[:, None], gn, g)
        it += 1
    _, hinv, _ = chol_small(h_last, inverse=True)
    se = torch.sqrt(torch.maximum(_diag(hinv), torch.zeros(1, device=dev)))
    return beta, se, ll_old, conv, failed, ~conv & ~failed, hinv


def _firth_core(irls, vb, d, active):
    """Batched Firth-penalised IRLS (plink_tpu _firth_core) of vb rows of
    width d.  Per iteration: irls logistic (v, H0, loglik) -> K4 (H0^-1, log
    det) -> irls firth2 (ustar, H2, with hinv=H0^-1) -> K4 (H2^-1), irls as
    in _logistic_core (K3, K16 on the wide designs, K18 on dosages); with
    d = 1 (the residualized design) K4 runs on 1 x 1 matrices.  Returns
    (beta, se, pll, conv, failed, unfinished, h2inv)."""
    dev = active.device
    beta = torch.zeros((vb, d), dtype=torch.float32, device=dev)
    pll_old = torch.zeros(vb, dtype=torch.float64, device=dev)
    delta_max = torch.zeros(vb, dtype=torch.float32, device=dev)
    done = ~active
    conv = torch.zeros_like(done)
    failed = torch.zeros_like(done)
    h2inv_last = torch.eye(d, dtype=torch.float32, device=dev).expand(vb, d, d)
    it = 0
    while it <= _FIRTH_MAXIT and not bool(done.all()):
        live = ~done
        h0, _, ll = irls(beta, live)
        _, h0inv, logdet = chol_small(h0, inverse=True, logdet=True)
        pll = ll + 0.5 * logdet
        h2, ustar, _ = irls(beta, live, hinv=h0inv)
        new_failed = torch.isnan(pll)
        new_conv = ((it > 0) & (delta_max <= 1e-5)
                    & (ustar.abs().amax(dim=1) < 1e-5)
                    & ((pll - pll_old) < 1e-5))
        _, h2inv, _ = chol_small(h2, inverse=True)
        dbeta = (h2inv * ustar[:, None, :]).sum(dim=2)  # no matmul: no TF32
        new_failed = new_failed | torch.isnan(dbeta).any(dim=1)
        dmax = dbeta.abs().amax(dim=1)
        scale = torch.clamp(5.0 / torch.clamp(dmax, min=1e-30), max=1.0)
        dbeta = dbeta * scale[:, None]
        dmax = torch.clamp(dmax, max=5.0)
        upd = live & ~new_conv & ~new_failed
        beta = torch.where(upd[:, None], beta + dbeta, beta)
        pll_old = torch.where(live, pll, pll_old)
        delta_max = torch.where(upd, dmax, delta_max)
        conv = conv | (live & new_conv)
        failed = failed | (live & new_failed)
        done = done | new_conv | new_failed
        h2inv_last = torch.where(upd[:, None, None], h2inv, h2inv_last)
        it += 1
    se = torch.sqrt(torch.maximum(_diag(h2inv_last), torch.zeros(1, device=dev)))
    return beta, se, pll_old, conv, failed, ~conv & ~failed, h2inv_last


def _valid_params_flags(hinv, d):
    """validParameters() (ref plink2_glm_logistic.cc:4871-4893): a
    non-intercept covariance diagonal < 1e-20 or non-finite, or any estimate
    pair correlated > 0.99999, invalidates the row."""
    dg = _diag(hinv)
    bad = ((dg[:, 1:] < 1e-20) | ~torch.isfinite(dg[:, 1:])).any(dim=1)
    sd = torch.sqrt(dg)
    tril = torch.tril(torch.ones((d, d), dtype=torch.bool, device=hinv.device), -1)
    corr_bad = (hinv > 0.99999 * sd[:, :, None] * sd[:, None, :]) & tril[None]
    return bad | corr_bad.flatten(1).any(dim=1)


def _collin_screen_device(momy, dc, np_=1):
    """Rows whose covariate + genotype correlation structure is clearly fine
    (plink_tpu _collin_screen_device: max |corr| < 0.985 and a Gershgorin
    bound on the smallest eigenvalue >= 1/39), so the host never fetches
    their moments; rows with nm <= d need no check.  ok [vb] bool."""
    d = dc + np_
    kidx = list(range(dc)) + [dc + 1 + p for p in range(np_)]
    s = momy[:, kidx][:, :, kidx]
    nm = s[:, 0, 0]
    k = d - 1
    if k < 2:
        return torch.ones(momy.shape[0], dtype=torch.bool, device=momy.device)
    sums = s[:, 0, 1:]
    nm_safe = torch.clamp(nm, min=2.0)
    covm = (s[:, 1:, 1:] - sums[:, :, None] * sums[:, None, :]
            / nm_safe[:, None, None]) / (nm_safe - 1.0)[:, None, None]
    var = _diag(covm)
    istd = torch.where(var > 0, torch.rsqrt(torch.clamp(var, min=1e-30)),
                       torch.full_like(var, float("nan")))
    corr = covm * istd[:, :, None] * istd[:, None, :]
    eye = torch.eye(k, dtype=torch.bool, device=momy.device)[None]
    od = torch.where(eye, torch.zeros_like(corr), corr).abs()
    max_od = od.flatten(1).amax(dim=1)
    cm = torch.where(eye, torch.ones_like(corr), corr)
    finite = torch.isfinite(cm).flatten(1).all(dim=1)
    wmin_lb = 1.0 - od.sum(dim=2).amax(dim=1)
    ok = finite & (max_od < 0.985) & (wmin_lb >= 1.0 / 39.0)
    return ok | (nm <= d)


def _mstats(momy, dc, np_=1):
    """Per-variant scalars of the moments [c | y | G_1..G_P | ADD]: ADD sum,
    ADD sum of squares, ADD sum over cases, obs, cases."""
    addc = dc + 1 + np_
    return torch.stack([momy[:, 0, addc], momy[:, addc, addc], momy[:, dc, addc],
                        momy[:, 0, 0], momy[:, 0, dc]], dim=1)


def _ols_start(momy, dc, np_):
    """The IRLS start's normal equations from the moments (plink_tpu
    `_glm_scan_body`): h0 = X^T X over valid samples, rhs0 = X^T z with
    z = 4.8639 (y - 0.5)."""
    idx = list(range(dc)) + [dc + 1 + p for p in range(np_)]
    h0 = momy[:, idx][:, :, idx].contiguous()
    rhs0 = (_Z_INIT * (momy[:, idx, dc] - 0.5 * momy[:, idx, 0])).contiguous()
    return h0, rhs0


def _with_add(gw3):
    """The moments pass's weights: the model's predictors, then a last
    column (its values only fill momy's last row and column)."""
    return torch.cat([gw3, gw3[:, :1]], dim=1).contiguous()


def glm_logistic_scan(blocks, gws, gwms, feat, firth=False, sscale=None,
                      covj=None):
    """Whole-dataset hybrid-GLM pass (plink_tpu glm_logistic_scan): per
    variant block the moments matrix (K2 / K15), then the logistic (or, with
    `firth`, the Firth) IRLS from it (K3 / K16, K4).  blocks uint8
    [nb, vb, NB], gws f32 [nb, vb, P, 3], gwms f32 [nb, vb, P+1, 3] (the
    model's predictors, then ADD), feat f32 [npad, dc+2]; sscale f32 [npad]
    multiplies every predictor column; covj (P ints) multiplies G_p by
    covariate column covj[p] (interaction terms; ADD takes none).

    Returns, stacked over blocks: (momy [nb, vb, D, D] with D = dc + P + 2,
    mstats [nb, vb, 5], screen_ok, beta [nb, vb, d], se, conv, fail, unf,
    obs, invalid, hinv [nb, vb, d, d]) with d = dc + P."""
    dc = feat.shape[1] - 2
    P = gws.shape[2]
    d = dc + P
    covj = _covj(covj, P)
    outs = []
    for bi in range(blocks.shape[0]):
        pk = blocks[bi]
        gw = gws[bi].contiguous()
        momy = glm_moments(pk, gwms[bi].contiguous(), feat, sscale, covj + (0,))
        active = torch.ones(pk.shape[0], dtype=torch.bool, device=pk.device)
        irls = partial(glm_irls_pass, pk, gw, feat, sscale=sscale, covj=covj)
        if firth:
            res = _firth_core(irls, pk.shape[0], d, active)
        else:
            h0, rhs0 = _ols_start(momy, dc, P)
            res = _logistic_core(irls, h0, rhs0, active)
        beta, se, _ll, conv, fail, unf, hinv = res
        outs.append((momy, _mstats(momy, dc, P), _collin_screen_device(momy, dc, P),
                     beta, se, conv, fail, unf, momy[:, 0, 0],
                     _valid_params_flags(hinv, d), hinv))
    return tuple(torch.stack(x) for x in zip(*outs))


def firth_irls_block(packed, gw, feat, active=None, sscale=None, covj=None):
    """Firth regression over one block (plink_tpu firth_irls_block) for the
    rows in `active` (all rows when None).  packed uint8 [vb, NB], gw f32
    [vb, P, 3], covj as in glm_logistic_scan.  Returns (beta [vb, d], se,
    pll, conv, fail, unf, obs, h2inv [vb, d, d])."""
    vb, nb = packed.shape
    if active is None:
        active = torch.ones(vb, dtype=torch.bool, device=packed.device)
    irls = partial(glm_irls_pass, packed, gw.contiguous(), feat, sscale=sscale,
                   covj=_covj(covj, gw.shape[1]))
    beta, se, pll, conv, fail, unf, h2inv = _firth_core(
        irls, vb, feat.shape[1] - 2 + gw.shape[1], active)
    cts = geno_counts(packed, feat[:, -1:].contiguous())[0]
    obs = (cts[:, :3].sum(dim=1)).to(torch.float32)
    return beta, se, pll, conv, fail, unf, obs, h2inv


def design_moments_block(packed, gw, feat, covj=None, sscale=None):
    """plink_tpu design_moments_block: X^T X over the valid samples of
    [c | G_1..G_P] for one block -> f32 [vb, d, d].  feat is [c | mask]
    (dc = feat.shape[1] - 1 columns of c), gw f32 [vb, P, 3].  One K2 / K15
    pass (the table's last c column stands in K2's y slot, and the moments'
    ADD column is dropped)."""
    d = feat.shape[1] - 1 + gw.shape[1]
    mom = glm_moments(packed, _with_add(gw), feat, sscale,
                      _covj(covj, gw.shape[1]) + (0,))
    return mom[:, :d, :d].contiguous()


def logistic_irls_block(packed, gw, feat, covj=None, sscale=None):
    """plink_tpu logistic_irls_block: the logistic IRLS of one block over
    [c | G_1..G_P] from the OLS start (one K2 / K15 pass for it, then K3 /
    K16 and K4 per iteration).  feat f32 [npad, dc+2] = [c | y | mask], gw
    f32 [vb, P, 3].  Returns (beta, se, ll f64, conv, fail, unf, obs,
    hinv)."""
    dc = feat.shape[1] - 2
    P = gw.shape[1]
    covj = _covj(covj, P)
    momy = glm_moments(packed, _with_add(gw), feat, sscale, covj + (0,))
    h0, rhs0 = _ols_start(momy, dc, P)
    active = torch.ones(packed.shape[0], dtype=torch.bool, device=packed.device)
    irls = partial(glm_irls_pass, packed, gw.contiguous(), feat, sscale=sscale,
                   covj=covj)
    beta, se, ll, conv, fail, unf, hinv = _logistic_core(irls, h0, rhs0, active)
    return beta, se, ll, conv, fail, unf, momy[:, 0, 0], hinv


# ---------------------------------------------------------------------------
# cc-residualize / firth-residualize (the residualized K3 design)
# ---------------------------------------------------------------------------


def _resid_start(momy, dc, np_=1):
    """The residualized design's per-variant means and IRLS start from the
    moments [c | y | G_1..G_P | ADD] (c[:, 0] the intercept).

    plink_tpu's `_resid_body` takes mean_vp = sum_valid(G_p s) / max(obs, 1)
    in f32 over the samples, centres G'_p = (G_p s - mean_vp) valid, and
    starts the logistic IRLS from OLS on z = 4.8639 (y - 0.5) over the valid
    samples: h0 = sum valid G' G'^T, rhs0 = sum z G' (`_logistic_core` with
    init=None; the offset is not in that start).  Here both come in closed
    form from K2's sums instead of a separate pass over the samples:
        h0_pq = S2_pq - (m_p S1_q + S1_p m_q) + m_p m_q obs,
        rhs0_p = 4.8639 ((S_yG_p - m_p S_y) - 0.5 (S1_p - m_p obs)),
    S1_p = sum v G_p s, S2_pq = sum v G_p G_q s^2, S_yG_p = sum v y G_p s,
    S_y = sum v y, computed in f64 from K2's f32 moments (the mean therefore
    differs from plink_tpu's f32 sample sum in the last bits; the fits agree
    within the GLM rule).  Returns (mean f32 [vb, P], h0 f32 [vb, P, P],
    rhs0 f32 [vb, P])."""
    m64 = momy.to(torch.float64)
    gi = [dc + 1 + p for p in range(np_)]
    obs, s1, s2 = m64[:, 0, 0], m64[:, 0, gi], m64[:, gi][:, :, gi]
    sy, syg = m64[:, 0, dc], m64[:, dc, gi]
    mean = s1 / torch.clamp(obs, min=1.0)[:, None]
    h0 = (s2 - (mean[:, :, None] * s1[:, None, :] + s1[:, :, None] * mean[:, None, :])
          + mean[:, :, None] * mean[:, None, :] * obs[:, None, None])
    rhs0 = _Z_INIT * ((syg - mean * sy[:, None]) - 0.5 * (s1 - mean * obs[:, None]))
    return (mean.to(torch.float32).contiguous(), h0.to(torch.float32).contiguous(),
            rhs0.to(torch.float32).contiguous())


def glm_resid_scan(blocks, gws, gwms, feat, offset, firth=False, sscale=None):
    """Residualized whole-dataset pass (plink_tpu glm_resid_scan): per block
    the moments of the full design [c | y | G_1..G_P | ADD] (K2, scaled by
    sscale when given; the host's separation and A1 statistics are
    unchanged), then the logistic (Firth with `firth`) IRLS of the
    residualized design (K3 with dc = 0, d = P) with the null model's linear
    predictor `offset` f32 [npad] as a fixed term.  Returns the tuple of
    glm_logistic_scan with d = P in beta / se / hinv; `invalid` is the
    diagonal-only check of the residualized fit (a variance < 1e-20 or not
    finite)."""
    dc = feat.shape[1] - 2
    P = gws.shape[2]
    feat_r = feat[:, dc:].contiguous()  # [y | mask]
    outs = []
    for bi in range(blocks.shape[0]):
        pk = blocks[bi]
        gw = gws[bi].contiguous()
        momy = glm_moments(pk, gwms[bi].contiguous(), feat, sscale)
        mean, h0, rhs0 = _resid_start(momy, dc, P)
        active = torch.ones(pk.shape[0], dtype=torch.bool, device=pk.device)
        irls = partial(glm_irls_pass, pk, gw, feat_r, sscale=sscale,
                       offset=offset, gmean=mean)
        if firth:
            res = _firth_core(irls, pk.shape[0], P, active)
        else:
            res = _logistic_core(irls, h0, rhs0, active)
        beta, se, _ll, conv, fail, unf, hinv = res
        dg = _diag(hinv)
        invalid = ((dg < 1e-20) | ~torch.isfinite(dg)).any(dim=1)
        outs.append((momy, _mstats(momy, dc, P), _collin_screen_device(momy, dc, P),
                     beta, se, conv, fail, unf, momy[:, 0, 0], invalid, hinv))
    return tuple(torch.stack(x) for x in zip(*outs))


def resid_irls_block(packed, gw, feat, offset, active=None, sscale=None):
    """Residualized Firth over one block (plink_tpu resid_irls_block with
    firth=True: the hybrid's Firth fallback under cc-residualize) for the
    rows in `active`.  gw f32 [vb, P, 3] (P <= 2); feat is the [c | y | mask]
    table (c[:, 0] the intercept); the per-variant means come from one K2
    pass over [1 | y | mask].  Returns (beta [vb, P], se, pll, conv, fail,
    unf, obs, h2inv [vb, P, P])."""
    vb = packed.shape[0]
    dc = feat.shape[1] - 2
    P = gw.shape[1]
    if active is None:
        active = torch.ones(vb, dtype=torch.bool, device=packed.device)
    momy = glm_moments(packed, _with_add(gw), feat[:, [0, dc, dc + 1]].contiguous(),
                       sscale)
    mean, _, _ = _resid_start(momy, 1, P)
    irls = partial(glm_irls_pass, packed, gw.contiguous(),
                   feat[:, dc:].contiguous(), sscale=sscale, offset=offset,
                   gmean=mean)
    beta, se, pll, conv, fail, unf, h2inv = _firth_core(irls, vb, P, active)
    return beta, se, pll, conv, fail, unf, momy[:, 0, 0], h2inv


# ---------------------------------------------------------------------------
# K14: --xchr-model 1 statistics
# ---------------------------------------------------------------------------


def xm1_stats_plain(packed, w, mask):
    """Plain version of K14 (plink_tpu xm1_stats_scan's body): over the valid
    samples (call not missing, mask) of each variant of packed uint8
    [V, NB], the float32 product of the valid plane with w f32 [4*NB, 2],
    the het count and the hom-ALT count -> f32 [4, V]."""
    valid, het, homalt = planes(packed, mask)
    sv = valid @ w
    return torch.stack([sv[:, 0], sv[:, 1], het.sum(dim=1), homalt.sum(dim=1)])


_XM1_SPLIT_WORDS = 256  # 32-bit words per K14 sample split (csrc/xm1_stats.cu)


def xm1_stats(packed, w, mask):
    """K14: per variant of packed uint8 [V, NB], (sum w0, sum w1, het count,
    hom-ALT count) over its valid samples -> f32 [4, V]; w f32 [4*NB, 2],
    mask f32 [4*NB] (0/1).  Exact, and equal to the plain version, when w
    takes values in {0, 0.5, 1}."""
    V, nb = packed.shape
    dev = packed.device
    _check("xm1_stats packed", packed, torch.uint8, (V, nb), dev)
    _check("xm1_stats w", w, torch.float32, (4 * nb, 2), dev)
    _check("xm1_stats mask", mask, torch.float32, (4 * nb,), dev)
    if dev.type == "cpu":
        return xm1_stats_plain(packed, w, mask)
    if dev.type != "cuda":
        raise ValueError(f"xm1_stats: unsupported device {dev}")
    splits = -(-(-(-nb // 4)) // _XM1_SPLIT_WORDS)  # ceil(ceil(nb / 4) / 256)
    ns = splits * _XM1_SPLIT_WORDS * 16
    mw = torch.zeros((ns, 2), dtype=torch.float32, device=dev)
    mw[: 4 * nb] = w * mask[:, None]
    # [split][stat][sample in word][word]: the kernel's shared-memory layout
    wt = mw.reshape(splits, _XM1_SPLIT_WORDS, 16, 2).permute(0, 3, 2, 1).contiguous()
    inm = torch.zeros(ns, dtype=torch.uint8, device=dev)
    inm[: 4 * nb] = (mask > 0).to(torch.uint8) * 3
    inm = inm.reshape(-1, 4)
    mask2 = (inm[:, 0] | (inm[:, 1] << 2) | (inm[:, 2] << 4)
             | (inm[:, 3] << 6)).contiguous().view(torch.int32)
    part = torch.empty((splits, 4, V), dtype=torch.float32, device=dev)
    out = torch.empty((4, V), dtype=torch.float32, device=dev)
    _cuda.launch("xm1_stats", packed.data_ptr(), nb, V, mask2.data_ptr(),
                 wt.data_ptr(), splits, part.data_ptr(), out.data_ptr())
    return out


def xm1_stats_scan(blocks, w, mask):
    """plink_tpu xm1_stats_scan: K14 over every block of blocks uint8
    [nb, vb, NB] in one launch -> four f32 [nb, vb] (sum_valid s, sum_valid
    s*y, het count, hom-ALT count) for w = [s, s*y] f32 [npad, 2]."""
    nbk, vb, nb = blocks.shape
    out = xm1_stats(blocks.reshape(nbk * vb, nb), w, mask)
    return tuple(out[i].reshape(nbk, vb) for i in range(4))


# ---------------------------------------------------------------------------
# K19 / K20: the permuted linear scan; the Firth permutation scans
# ---------------------------------------------------------------------------


def linear_perm_xty_plain(packed, gw, c, Y, mask, covj=None, sscale=None):
    """Plain version of K19 (plink_tpu `_linear_perm_body` /
    `_linear_perm_multi_body`'s right-hand sides): over packed uint8
    [vb, NB] with gw [vb, P, 3], c [npad, dc], Y [npad, B] and mask
    [npad], xty [vb, dc + P, B] (valid c_j against Y, then G_p against Y)
    and yy [vb, B] (valid against Y^2), in the inputs' float type."""
    gw3 = _gw3(gw)
    valid, gcols = _plane_cols(packed, gw3, c, mask, _covj(covj, gw3.shape[1]),
                               sscale)
    parts = [valid @ (c[:, j:j + 1] * Y) for j in range(c.shape[1])]
    parts += [g @ Y for g in gcols]
    return torch.stack(parts, dim=1), valid @ (Y * Y)


def perm_code_weights(gw):
    """The weight of each genotype code that K19 decodes into a bf16
    operand of the tensor cores, from plane weights gw [vb, P, 3] (het,
    hom-ALT, valid): [vb, P, 3] for codes 0, 1, 2 (wV, wH + wV, wA + wV; a
    missing call weighs 0).  Raises ValueError unless gw and these are
    finite and exact in bf16, as the small integers of every model the
    permutation paths build are (commands/glm.py `_geno_predictors`)."""
    w = torch.stack([gw[..., 2], gw[..., 0] + gw[..., 2], gw[..., 1] + gw[..., 2]],
                    dim=-1)
    both = torch.cat([gw, w], dim=-1)
    if not (bool(torch.isfinite(both).all())
            and torch.equal(both.to(torch.bfloat16).to(both.dtype), both)):
        raise ValueError("linear_perm_xty: genotype plane weights (and their "
                         "per-code sums) must be finite and exact in bf16")
    return w


def perm_batch_width(B: int) -> int:
    """The width of Y that K19 reads without a copy: B permutations
    rounded up to a multiple of 4 (zero columns past B)."""
    return -(-B // 4) * 4


def linear_perm_xty(packed, gw, c, Y, mask, covj=None, sscale=None):
    """K19: the permuted right-hand sides of one block's linear designs
    (`linear_perm_xty_plain`).  packed uint8 [vb, NB], gw f32 [vb, P, 3]
    (or [vb, 3]), c f32 [4*NB, dc], Y f32 [4*NB, B], mask f32 [4*NB]; covj
    (P ints) multiplies G_p by c[:, covj[p]] when covj[p] > 0; sscale f32
    [4*NB] multiplies every G.  CUDA tensors launch csrc/linear_perm.cu on
    the tensor cores (each f32 product split exactly into three bf16
    parts; f32 within runs of _PERM_RUN samples, f64 across them), after
    `perm_code_weights` has checked gw."""
    vb, nb = packed.shape
    gw3 = _gw3(gw)
    P = gw3.shape[1]
    dc = c.shape[1]
    B = Y.shape[1]
    dev = packed.device
    _check("linear_perm_xty packed", packed, torch.uint8, (vb, nb), dev)
    _check("linear_perm_xty gw", gw3, torch.float32, (vb, P, 3), dev)
    _check("linear_perm_xty c", c, torch.float32, (4 * nb, dc), dev)
    _check("linear_perm_xty Y", Y, torch.float32, (4 * nb, B), dev)
    _check("linear_perm_xty mask", mask, torch.float32, (4 * nb,), dev)
    if sscale is not None:
        _check("linear_perm_xty sscale", sscale, torch.float32, (4 * nb,), dev)
    covj = _covj(covj, P)
    if max(covj) >= dc:
        raise ValueError(f"linear_perm_xty: covj {covj} beyond the {dc} columns")
    if dev.type == "cpu":
        return linear_perm_xty_plain(packed, gw3, c, Y, mask, covj, sscale)
    if dev.type != "cuda":
        raise ValueError(f"linear_perm_xty: unsupported device {dev}")
    perm_code_weights(gw3)
    # the kernel copies 16-byte pieces of Y's and c's rows: a Y of another
    # width or alignment (the permutation paths build theirs at
    # `perm_batch_width`) goes through a zero-padded copy, whose extra
    # columns' sums are dropped
    Bp = perm_batch_width(B)
    Yp = Y
    if Bp != B or Y.data_ptr() % 16:
        Yp = torch.zeros((4 * nb, Bp), dtype=torch.float32, device=dev)
        Yp[:, :B] = Y
    if c.data_ptr() % 16:
        c = c.clone()
    xty = torch.empty((vb, dc + P, Bp), dtype=torch.float32, device=dev)
    yy = torch.empty((vb, Bp), dtype=torch.float32, device=dev)
    cj = torch.tensor([j if j else -1 for j in covj], dtype=torch.int32, device=dev)
    _cuda.launch("linear_perm_xty", packed.data_ptr(), nb, vb, gw3.data_ptr(), P,
                 c.data_ptr(), dc, Yp.data_ptr(), Bp, mask.data_ptr(),
                 cj.data_ptr(), _cuda.ptr(sscale), _PERM_RUN, xty.data_ptr(),
                 yy.data_ptr())
    if Bp != B:
        xty, yy = xty[..., :B].contiguous(), yy[:, :B].contiguous()
    return xty, yy


def _kept(d, tc, q):
    """The reduced design's columns: all but the q constrained ones from
    tc."""
    return list(range(tc)) + list(range(tc + q, d))


def linear_perm_stat_plain(inv, xty, yy, nm, tc, q=0, inv0=None):
    """Plain version of K20 (the statistic of plink_tpu `_linear_perm_body`
    / `_linear_perm_multi_body`): from the design inverse inv [vb, d, d],
    xty [vb, d, B], yy [vb, B] and nm [vb], t of column tc (q = 0) or the
    joint F of the q columns from tc over the reduced inverse inv0 (q >
    0) -> [vb, B]; NaN where an inverse is."""
    d = inv.shape[1]
    beta = torch.einsum("vij,vjb->vib", inv, xty)
    rss = yy - (beta * xty).sum(dim=1)
    dof = torch.clamp(nm - d, min=1.0)
    sigma2 = rss / dof[:, None]
    if q == 0:
        se2 = sigma2 * inv[:, tc, tc][:, None]
        return beta[:, tc] / torch.sqrt(torch.clamp(se2, min=0.0))
    xty0 = xty[:, _kept(d, tc, q)]
    b0 = torch.einsum("vij,vjb->vib", inv0, xty0)
    rss0 = yy - (b0 * xty0).sum(dim=1)
    return ((rss0 - rss) / float(q)) / torch.clamp(sigma2, min=1e-30)


def linear_perm_stat(inv, xty, yy, nm, tc, q=0, inv0=None):
    """K20: `linear_perm_stat_plain` for f32 inv [vb, d, d], xty
    [vb, d, B], yy [vb, B], nm [vb] and, with q > 0, inv0 [vb, d - q,
    d - q]; one CUDA block per variant, a thread per permutation (two at
    16 < d <= 32), the arithmetic in f64."""
    vb, d, _ = inv.shape
    B = yy.shape[1]
    dev = inv.device
    _check("linear_perm_stat inv", inv, torch.float32, (vb, d, d), dev)
    _check("linear_perm_stat xty", xty, torch.float32, (vb, d, B), dev)
    _check("linear_perm_stat yy", yy, torch.float32, (vb, B), dev)
    _check("linear_perm_stat nm", nm, torch.float32, (vb,), dev)
    if not 0 <= tc < d or q < 0 or tc + q > d or (q > 0) != (inv0 is not None):
        raise ValueError(f"linear_perm_stat: tc {tc}, q {q} at d = {d}")
    if q:
        _check("linear_perm_stat inv0", inv0, torch.float32, (vb, d - q, d - q), dev)
    if dev.type == "cpu":
        return linear_perm_stat_plain(inv, xty, yy, nm, tc, q, inv0)
    if dev.type != "cuda":
        raise ValueError(f"linear_perm_stat: unsupported device {dev}")
    out = torch.empty((vb, B), dtype=torch.float32, device=dev)
    _cuda.launch("linear_perm_stat", inv.data_ptr(), xty.data_ptr(), yy.data_ptr(),
                 nm.data_ptr(), _cuda.ptr(inv0), vb, d, tc, q, B, out.data_ptr())
    return out


def perm_inverses(blocks, gws, c, mask, covj=None, q=0, sscale=None):
    """What the permuted linear scan keeps across permutation batches, per
    block of blocks uint8 [nb, vb, NB] with gws f32 [nb, vb, P, 3]: (inv,
    inv0 or None, nm) -- the inverse of X^T X over [c | G_1..G_P] (one
    `design_moments_block` pass, K2 / K15, then K4), with q > 0 that of the
    design without the q genotype main effects, and the valid count.
    plink_tpu forms them anew for every batch from the same inputs."""
    feat = torch.cat([c, mask[:, None]], dim=1).contiguous()
    dc = c.shape[1]
    out = []
    for bi in range(blocks.shape[0]):
        h = design_moments_block(blocks[bi], gws[bi].contiguous(), feat, covj,
                                 sscale)
        _, inv, _ = chol_small(h, inverse=True)
        inv0 = None
        if q:
            keep = _kept(h.shape[1], dc, q)
            _, inv0, _ = chol_small(h[:, keep][:, :, keep].contiguous(),
                                    inverse=True)
        out.append((inv, inv0, h[:, 0, 0].contiguous()))
    return out


def linear_perm_multi_scan(blocks, gws, c, Y, mask, dc, covj, q, sscale=None,
                           inverses=None):
    """plink_tpu linear_perm_multi_scan: per block of blocks uint8
    [nb, vb, NB] (gws f32 [nb, vb, P, 3]) and permuted phenotype column of
    Y f32 [npad, B], the joint F over the first q genotype columns (q > 0)
    or the t of the first one (q = 0) -> [nb, vb, B] f32, NaN on singular
    fits.  K19 and K20 per block, over `inverses` (`perm_inverses`, formed
    here when None)."""
    if c.shape[1] != dc:
        raise ValueError(f"linear perm scan: c has {c.shape[1]} columns, dc {dc}")
    if inverses is None:
        inverses = perm_inverses(blocks, gws, c, mask, covj, q, sscale)
    outs = []
    for bi in range(blocks.shape[0]):
        inv, inv0, nm = inverses[bi]
        xty, yy = linear_perm_xty(blocks[bi], gws[bi].contiguous(), c, Y, mask,
                                  covj, sscale)
        outs.append(linear_perm_stat(inv, xty, yy, nm, dc, q, inv0))
    return torch.stack(outs)


def linear_perm_scan(blocks, gws, c, Y, mask, dc, covj=(), sscale=None,
                     inverses=None):
    """plink_tpu linear_perm_scan: the single-predictor t statistics
    [nb, vb, B] (gws f32 [nb, vb, 1, 3]); see linear_perm_multi_scan."""
    return linear_perm_multi_scan(blocks, gws, c, Y, mask, dc, covj, 0, sscale,
                                  inverses)


def _firth_fit(packed, gw, c, yb, mask, covj, sscale, active):
    """One Firth fit of the `active` rows of a block against phenotype
    column yb (plink_tpu `_firth_body`): K3 / K16 in logistic and firth2
    modes and K4 per iteration.  Returns (beta, se, failed, h2inv)."""
    feat = torch.cat([c, yb[:, None], mask[:, None]], dim=1).contiguous()
    irls = partial(glm_irls_pass, packed, gw, feat, sscale=sscale,
                   covj=_covj(covj, gw.shape[1]))
    beta, se, _pll, _conv, fail, _unf, h2inv = _firth_core(
        irls, packed.shape[0], c.shape[1] + gw.shape[1], active)
    return beta, se, fail, h2inv


def _abs_z(bg, sg):
    """The Firth permutation statistic of plink_tpu firth_perm_scan (ref
    GlmLogisticPerm, plink2_glm_logistic.cc:6690-6697): |beta / se|, 0 at
    beta = 0, +inf at se = 0."""
    stat = (bg / sg).abs()
    stat = torch.where(bg == 0.0, torch.zeros_like(stat), stat)
    return torch.where((sg == 0.0) & (bg != 0.0), torch.full_like(stat, np.inf),
                       stat)


def firth_perm_multi_scan(blocks, gws, c, Y, mask, dc, covj, q, sscale=None,
                          rows=None):
    """plink_tpu firth_perm_multi_scan: per permuted column of Y f32
    [npad, B] and block, the Firth fit of [c | G_1..G_P] and the joint Wald
    chisq / q over the first q genotype columns from the Firth Hessian
    inverse (q > 0; its q x q solve on K4), or |z| of the first one (q =
    0); -1 marks a failed fit.  Returns [B, nb, vb] f32.  With rows bool
    [nb, vb] only those rows are fitted (the others read -1): a row's fit
    does not depend on the others, and the IRLS loop then ends when they
    are done (K3 skips a 64-variant tile with no active row)."""
    if c.shape[1] != dc:
        raise ValueError(f"Firth perm scan: c has {c.shape[1]} columns, dc {dc}")
    if rows is None:
        rows = torch.ones(blocks.shape[:2], dtype=torch.bool, device=blocks.device)
    per_perm = []
    for b in range(Y.shape[1]):
        yb = Y[:, b].contiguous()
        stats = []
        for bi in range(blocks.shape[0]):
            beta, se, failed, hinv = _firth_fit(blocks[bi], gws[bi].contiguous(),
                                                c, yb, mask, covj, sscale, rows[bi])
            if q == 0:
                stat = _abs_z(beta[:, dc], se[:, dc])
            else:
                bg = beta[:, dc:dc + q].contiguous()
                x, _, _ = chol_small(hinv[:, dc:dc + q, dc:dc + q].contiguous(),
                                     rhs=bg)
                stat = (bg * x).sum(dim=1) / float(q)
                stat = torch.where(stat < 0.0, torch.full_like(stat, -1.0), stat)
            stats.append(torch.where(failed | torch.isnan(stat) | ~rows[bi],
                                     torch.full_like(stat, -1.0), stat))
        per_perm.append(torch.stack(stats))
    return torch.stack(per_perm)


def firth_perm_scan(blocks, gws, c, Y, mask, dc, covj=(), sscale=None,
                    rows=None):
    """plink_tpu firth_perm_scan: the Firth |z| of the single genotype
    column per (permutation, block, variant) -> [B, nb, vb] f32; -1 on a
    failed fit, 0 at beta = 0, +inf at se = 0."""
    return firth_perm_multi_scan(blocks, gws, c, Y, mask, dc, covj, 0, sscale,
                                 rows)

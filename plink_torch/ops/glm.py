"""GLM on the device: the linear sums (K6), and kernels K2-K4 with the
logistic-hybrid IRLS around them.

Counterparts of plink_tpu/ops/glm.py:
- `linear_sums` (K6, csrc/linear_sums.cu) for `_linear_sums_body`, and
  `linear_sums_scan` for `linear_sums_scan`;
- `glm_moments` (K2, csrc/glm_moments.cu) for `_plane_cols` +
  `_moments_from_cols`;
- `glm_irls_pass` (K3, csrc/glm_irls.cu) for the `_design_ops`
  contractions of one logistic or Firth IRLS evaluation;
- `chol_small` (K4, csrc/chol_small.cu) for `_chol_small`,
  `_solve_psd`, `_inv_psd` and the Cholesky log-determinant;
- `glm_logistic_scan` / `firth_irls_block` for `glm_logistic_scan` /
  `firth_irls_block`, with `_valid_params_flags` and
  `_collin_screen_device` as tensor ops on the device (no sample axis).

Each kernel wrapper takes the plain PyTorch version beside it for CPU
tensors and launches the kernel for CUDA tensors.  The logistic design is
[c (dc covariates incl. intercept) | G] with one additive genotype
predictor (P = 1); per-sample inputs travel as one table
feat = [c | y | mask] of shape [npad, dc + 2].
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .counts import geno_counts
from .planes import planes, unpack_codes

_GLM_MAXIT = 25  # ref: plink2_glm_logistic.cc "maxit = 25"
_FIRTH_MAXIT = 25
_Z_INIT = 4.863891244002886  # IRLS start: OLS on z = 4.8639 * (y - 0.5)
MAX_DC = 16  # widest covariate block the CUDA kernels are instantiated for


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


def _kernel_device(name, packed, dc):
    if packed.device.type == "cpu":
        return False
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {packed.device}")
    if not 1 <= dc <= MAX_DC:
        raise ValueError(f"{name}: the CUDA kernel takes 1..{MAX_DC} "
                         f"covariate columns (got {dc})")
    return True


# Samples per split of the K2/K3 sample axis: each split's f32 accumulators
# sum at most this many samples (a sequential f32 sum of n positive terms
# drifts by ~n * eps: 4e-5 relative over 15,232 IRLS weights, ~5e-6 over
# 2,048), and a second pass adds the splits in f64.  A constant, so the
# summation order, hence every output byte, is the same on any card.
_SPLIT = 2048


def _splits(npad: int) -> tuple[int, int]:
    """(samples per split, split count) for K2/K3; a split is whole
    128-sample shared-memory tiles."""
    split_len = min(_SPLIT, -(-npad // 128) * 128)
    return split_len, -(-npad // split_len)


# ---------------------------------------------------------------------------
# K6: linear sums
# ---------------------------------------------------------------------------


def linear_sums_plain(packed, ccfl, cy, y2):
    """Plain version of K6 (plink_tpu `_linear_sums_body`): the het,
    hom-ALT and missing planes of packed uint8 [vb, NB] against ccfl
    [npad, dc*dc] (c_j c_k), cy [npad, dc] (c_j y) and y2 [npad] (y^2),
    npad = 4*NB, in their float type.  Returns hcc/acc/mcc [vb, dc*dc],
    hcy/acy/mcy [vb, dc], myy [vb]."""
    codes = unpack_codes(packed)
    het, homalt, miss = ((codes == c).to(ccfl.dtype) for c in (1, 2, 3))
    return {"hcc": het @ ccfl, "acc": homalt @ ccfl, "mcc": miss @ ccfl,
            "hcy": het @ cy, "acy": homalt @ cy, "mcy": miss @ cy,
            "myy": miss @ y2}


def _linear_feat(ccfl, cy, y2):
    """K6's per-sample table [npad, nf]: c_j c_k for j <= k (row-major),
    then c_j y, then y^2; nf = dc(dc+1)/2 + dc + 1."""
    dc = cy.shape[1]
    j, k = torch.triu_indices(dc, dc, device=ccfl.device)
    return torch.cat([ccfl[:, j * dc + k], cy, y2[:, None]], dim=1).contiguous()


def linear_sums(packed, ccfl, cy, y2):
    """K6: the plane sums of `linear_sums_plain` for one variant block.
    packed uint8 [vb, NB], ccfl f32 [npad, dc*dc], cy f32 [npad, dc], y2 f32
    [npad], with padding samples zero in all three.  CPU tensors take the
    plain version (in their float type); CUDA tensors launch the kernel,
    which sums at most 2,048 samples per f32 accumulator, adds the splits in
    f64 and returns f64."""
    vb, nb = packed.shape
    dc = cy.shape[1]
    dev = packed.device
    _check("linear_sums packed", packed, torch.uint8, (vb, nb), dev)
    _check("linear_sums ccfl", ccfl, torch.float32, (4 * nb, dc * dc), dev)
    _check("linear_sums cy", cy, torch.float32, (4 * nb, dc), dev)
    _check("linear_sums y2", y2, torch.float32, (4 * nb,), dev)
    if not _kernel_device("linear_sums", packed, dc):
        return linear_sums_plain(packed, ccfl, cy, y2)
    feat = _linear_feat(ccfl, cy, y2)
    split_len, splits = _splits(4 * nb)
    part = torch.empty((splits, 3, vb, feat.shape[1]), dtype=torch.float32,
                       device=dev)
    out = torch.empty((3, vb, dc * dc + dc + 1), dtype=torch.float64, device=dev)
    _cuda.launch("linear_sums", packed.data_ptr(), nb, vb, feat.data_ptr(), dc,
                 split_len, splits, part.data_ptr(), out.data_ptr())
    d2 = dc * dc
    return {"hcc": out[0, :, :d2], "acc": out[1, :, :d2], "mcc": out[2, :, :d2],
            "hcy": out[0, :, d2:d2 + dc], "acy": out[1, :, d2:d2 + dc],
            "mcy": out[2, :, d2:d2 + dc], "myy": out[2, :, -1]}


def linear_sums_scan(blocks, ccfl, cy, y2):
    """Whole-dataset linear sums (plink_tpu `linear_sums_scan`): K6 per
    block of blocks uint8 [nb, vb, NB]; returns the dict of
    `linear_sums` stacked to [nb, vb, ...]."""
    outs = [linear_sums(blocks[bi], ccfl, cy, y2) for bi in range(blocks.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# K2: moments
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


def glm_moments_plain(packed, gwm, feat):
    dc = feat.shape[1] - 2
    valid, het, homalt = planes(packed, feat[:, dc + 1])
    gcols = [gwm[:, p, 0:1] * het + gwm[:, p, 1:2] * homalt
             + gwm[:, p, 2:3] * valid for p in range(2)]
    return _moments_from_cols(gcols, valid, feat[:, : dc + 1])


def glm_moments(packed, gwm, feat):
    """K2: packed uint8 [vb, NB], gwm f32 [vb, 2, 3] (model predictor, ADD),
    feat f32 [4*NB, dc+2] -> momy f32 [vb, dc+3, dc+3] over the design
    [c | y | G | ADD]."""
    vb, nb = packed.shape
    dc = feat.shape[1] - 2
    _check("glm_moments packed", packed, torch.uint8, (vb, nb), packed.device)
    _check("glm_moments gwm", gwm, torch.float32, (vb, 2, 3), packed.device)
    _check("glm_moments feat", feat, torch.float32, (4 * nb, dc + 2),
           packed.device)
    if not _kernel_device("glm_moments", packed, dc):
        return glm_moments_plain(packed, gwm, feat)
    D = dc + 3
    split_len, splits = _splits(4 * nb)
    part = torch.empty((splits, D * (D + 1) // 2, vb), dtype=torch.float32,
                       device=packed.device)
    out = torch.empty((vb, D, D), dtype=torch.float32, device=packed.device)
    _cuda.launch("glm_moments", packed.data_ptr(), nb, vb, feat.data_ptr(),
                 4 * nb, dc, split_len, splits, gwm.data_ptr(),
                 part.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K3: one IRLS evaluation
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


def _hessian(w, c, g):
    """sum_s w x x^T over [c | g] -> [vb, d, d]."""
    vb, n = w.shape
    dc = c.shape[1]
    ccfl = (c[:, :, None] * c[:, None, :]).reshape(n, dc * dc)
    h = torch.empty((vb, dc + 1, dc + 1), dtype=w.dtype, device=w.device)
    h[:, :dc, :dc] = (w @ ccfl).reshape(vb, dc, dc)
    wg = w * g
    cg = wg @ c
    h[:, :dc, dc] = cg
    h[:, dc, :dc] = cg
    h[:, dc, dc] = (wg * g).sum(dim=1)
    return h


def _xtv(r, c, g):
    return torch.cat([r @ c, (r * g).sum(dim=1, keepdim=True)], dim=1)


def glm_irls_pass_plain(packed, gw, feat, beta, active, hinv=None):
    dc = feat.shape[1] - 2
    c, y = feat[:, :dc], feat[:, dc]
    valid, het, homalt = planes(packed, feat[:, dc + 1])
    g = gw[:, 0:1] * het + gw[:, 1:2] * homalt + gw[:, 2:3] * valid
    eta = (beta[:, :dc] @ c.t() + beta[:, dc:] * g) * valid
    yv = y[None, :] * valid
    # 1 - p as sigmoid(-eta) (no cancellation at large |eta|); y is 0/1
    sg, q = torch.sigmoid(eta), torch.sigmoid(-eta)
    p = sg * valid
    y_minus_p = torch.where(yv != 0, q * valid, -p)
    ll = None
    if hinv is None:
        ll = _loglik(yv, valid, eta)
        w = sg * q * valid
        r = -y_minus_p
    else:
        v = sg * q * valid
        # h_s = v_s x_s^T Hinv x_s without materialising [vb, n, d]
        ccfl = (c[:, :, None] * c[:, None, :]).reshape(c.shape[0], dc * dc)
        quad = (hinv[:, :dc, :dc].reshape(-1, dc * dc) @ ccfl.t()
                + 2.0 * g * (hinv[:, :dc, dc] @ c.t())
                + g * g * hinv[:, dc, dc:])
        hd = v * quad
        r = (y_minus_p + hd * (0.5 - p)) * valid
        w = (1.0 + hd) * v
    mat, vec = _hessian(w, c, g), _xtv(r, c, g)
    on = active.to(torch.bool)
    mat = torch.where(on[:, None, None], mat, torch.zeros_like(mat))
    vec = torch.where(on[:, None], vec, torch.zeros_like(vec))
    if ll is not None:
        ll = torch.where(on, ll, torch.zeros_like(ll))
    return mat, vec, ll


def glm_irls_pass(packed, gw, feat, beta, active, hinv=None):
    """K3: one fused IRLS evaluation at `beta` for the rows with `active`.

    packed uint8 [vb, NB], gw f32 [vb, 3], feat f32 [4*NB, dc+2], beta f32
    [vb, d], active bool [vb]; d = dc + 1.  Logistic mode (hinv None):
    returns (H = X^T W X, X^T (p - y), loglik f64).  firth2 mode (hinv = H0^-1
    [vb, d, d]): returns (X^T diag((1+h) v) X, ustar, None).  Inactive rows
    come back as zeros."""
    vb, nb = packed.shape
    dc = feat.shape[1] - 2
    d = dc + 1
    dev = packed.device
    _check("glm_irls_pass packed", packed, torch.uint8, (vb, nb), dev)
    _check("glm_irls_pass gw", gw, torch.float32, (vb, 3), dev)
    _check("glm_irls_pass feat", feat, torch.float32, (4 * nb, dc + 2), dev)
    _check("glm_irls_pass beta", beta, torch.float32, (vb, d), dev)
    _check("glm_irls_pass active", active, torch.bool, (vb,), dev)
    if hinv is not None:
        _check("glm_irls_pass hinv", hinv, torch.float32, (vb, d, d), dev)
    if not _kernel_device("glm_irls_pass", packed, dc):
        return glm_irls_pass_plain(packed, gw, feat, beta, active, hinv)
    mode = 0 if hinv is None else 1
    split_len, splits = _splits(4 * nb)
    nt = d * (d + 1) // 2 + d
    part = torch.empty((splits, nt, vb), dtype=torch.float32, device=dev)
    part_ll = torch.empty((splits, vb), dtype=torch.float64, device=dev) \
        if mode == 0 else None
    mat = torch.empty((vb, d, d), dtype=torch.float32, device=dev)
    vec = torch.empty((vb, d), dtype=torch.float32, device=dev)
    ll = torch.empty(vb, dtype=torch.float64, device=dev) if mode == 0 else None
    act = active.to(torch.uint8)
    _cuda.launch("glm_irls", packed.data_ptr(), nb, vb, feat.data_ptr(),
                 4 * nb, dc, mode, split_len, splits, gw.data_ptr(),
                 beta.data_ptr(), _cuda.ptr(hinv), act.data_ptr(),
                 part.data_ptr(), _cuda.ptr(part_ll), mat.data_ptr(),
                 vec.data_ptr(), _cuda.ptr(ll))
    return mat, vec, ll


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


def chol_small(h, rhs=None, inverse=False, logdet=False):
    """K4: batched Cholesky of SPD h f32 [vb, d, d] (d <= 48).  Returns
    (h^-1 rhs [vb, d] if rhs is given, h^-1 [vb, d, d] if inverse,
    log det h [vb] if logdet), None for what was not asked; rows that are not
    positive definite come back NaN."""
    vb, d, _ = h.shape
    dev = h.device
    _check("chol_small h", h, torch.float32, (vb, d, d), dev)
    if rhs is not None:
        _check("chol_small rhs", rhs, torch.float32, (vb, d), dev)
    if dev.type == "cpu":
        return chol_small_plain(h, rhs, inverse, logdet)
    if dev.type != "cuda" or d > 48:
        raise ValueError(f"chol_small: unsupported device {dev} or d={d} > 48")
    x = torch.empty((vb, d), dtype=torch.float32, device=dev) \
        if rhs is not None else None
    inv = torch.empty((vb, d, d), dtype=torch.float32, device=dev) \
        if inverse else None
    ld = torch.empty(vb, dtype=torch.float32, device=dev) if logdet else None
    _cuda.launch("chol_small", h.data_ptr(), vb, d, _cuda.ptr(rhs),
                 _cuda.ptr(x), _cuda.ptr(inv), _cuda.ptr(ld))
    return x, inv, ld


# ---------------------------------------------------------------------------
# IRLS loops
# ---------------------------------------------------------------------------


def _diag(m):
    return torch.diagonal(m, dim1=1, dim2=2)


def _logistic_core(pk, gw, feat, h0, rhs0, active):
    """Batched logistic IRLS (plink_tpu _logistic_core) from the normal
    equations (h0, rhs0) of the OLS start.  Each K3 call at beta_k gives
    ll_k, H_k and the gradient; convergence compares ll_{k+1} with ll_k,
    with the step-size fallback, and the reported SE comes from H of the
    last solve.  Returns (beta, se, ll, conv, failed, unfinished, hinv)."""
    vb = pk.shape[0]
    d = h0.shape[1]
    beta, _, _ = chol_small(h0, rhs=rhs0)
    H, g, ll_old = glm_irls_pass(pk, gw, feat, beta, active)
    failed = torch.isnan(ll_old)
    done = failed | ~active
    conv = torch.zeros_like(done)
    eye = torch.eye(d, dtype=torch.float32, device=pk.device)
    h_last = eye.expand(vb, d, d).clone()
    it = 1
    while it < _GLM_MAXIT and not bool(done.all()):
        dbeta, _, _ = chol_small(H, rhs=g)
        beta_new = beta - dbeta
        upd = ~done
        Hn, gn, ll = glm_irls_pass(pk, gw, feat, beta_new, upd)
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
    se = torch.sqrt(torch.maximum(_diag(hinv), torch.zeros(1, device=pk.device)))
    return beta, se, ll_old, conv, failed, ~conv & ~failed, hinv


def _firth_core(pk, gw, feat, active):
    """Batched Firth-penalised IRLS (plink_tpu _firth_core).  Per iteration:
    K3 logistic (v, H0, loglik) -> K4 (H0^-1, log det) -> K3 firth2
    (ustar, H2) -> K4 (H2^-1).  Returns (beta, se, pll, conv, failed,
    unfinished, h2inv)."""
    vb = pk.shape[0]
    d = feat.shape[1] - 1
    dev = pk.device
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
        h0, _, ll = glm_irls_pass(pk, gw, feat, beta, live)
        _, h0inv, logdet = chol_small(h0, inverse=True, logdet=True)
        pll = ll + 0.5 * logdet
        h2, ustar, _ = glm_irls_pass(pk, gw, feat, beta, live, hinv=h0inv)
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


def glm_logistic_scan(blocks, gws, gwms, feat, firth=False):
    """Whole-dataset hybrid-GLM pass (plink_tpu glm_logistic_scan, ADD model):
    per variant block the moments matrix (K2), then the logistic (or, with
    `firth`, the Firth) IRLS from it.  blocks uint8 [nb, vb, NB], gws f32
    [nb, vb, 1, 3], gwms f32 [nb, vb, 2, 3], feat f32 [npad, dc+2].

    Returns, stacked over blocks: (momy [nb, vb, dc+3, dc+3], mstats
    [nb, vb, 5], screen_ok, beta [nb, vb, d], se, conv, fail, unf, obs,
    invalid, hinv [nb, vb, d, d]) with d = dc + 1."""
    dc = feat.shape[1] - 2
    d = dc + 1
    if gws.shape[2] != 1:
        raise ValueError("glm_logistic_scan: one genotype predictor (ADD) only")
    idx = list(range(dc)) + [dc + 1]
    addc = dc + 2
    outs = []
    for bi in range(blocks.shape[0]):
        pk = blocks[bi]
        gw = gws[bi, :, 0, :].contiguous()
        momy = glm_moments(pk, gwms[bi].contiguous(), feat)
        active = torch.ones(pk.shape[0], dtype=torch.bool, device=pk.device)
        if firth:
            res = _firth_core(pk, gw, feat, active)
        else:
            h0 = momy[:, idx][:, :, idx].contiguous()
            rhs0 = (_Z_INIT * (momy[:, idx, dc] - 0.5 * momy[:, idx, 0])).contiguous()
            res = _logistic_core(pk, gw, feat, h0, rhs0, active)
        beta, se, _ll, conv, fail, unf, hinv = res
        mstats = torch.stack(
            [momy[:, 0, addc], momy[:, addc, addc], momy[:, dc, addc],
             momy[:, 0, 0], momy[:, 0, dc]], dim=1)
        outs.append((momy, mstats, _collin_screen_device(momy, dc), beta, se,
                     conv, fail, unf, momy[:, 0, 0], _valid_params_flags(hinv, d),
                     hinv))
    return tuple(torch.stack(x) for x in zip(*outs))


def firth_irls_block(packed, gw, feat, active=None):
    """Firth regression over one block (plink_tpu firth_irls_block, ADD
    model) for the rows in `active` (all rows when None).  packed uint8
    [vb, NB], gw f32 [vb, 1, 3].  Returns (beta, se, pll, conv, fail, unf,
    obs, h2inv)."""
    vb, nb = packed.shape
    if active is None:
        active = torch.ones(vb, dtype=torch.bool, device=packed.device)
    beta, se, pll, conv, fail, unf, h2inv = _firth_core(
        packed, gw[:, 0, :].contiguous(), feat, active)
    cts = geno_counts(packed, feat[:, -1:].contiguous())[0]
    obs = (cts[:, :3].sum(dim=1)).to(torch.float32)
    return beta, se, pll, conv, fail, unf, obs, h2inv

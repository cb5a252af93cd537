"""plink_torch's CUDA kernels against their plain PyTorch versions at awkward
small shapes: sample counts that leave a ragged last byte (the unaligned
decode path) or a ragged tile, variant counts that are not a multiple of the
64-variant block (or of K5's 256-row chunk), every covariate width the
kernels are built for, inactive rows and masked-out variants, the designs
with two genotype columns (K2 / K3) and with G x covariate columns (K15 /
K16), the dosage kernels K17 / K18 (and K15 / K16's dense mode above 16
covariate columns), and matrix sizes past every shared-memory layout of
chol_small (d = 250 works in device memory) and of K15 / K16 (d = 128
splits a variant's tiles over CTAs), the permuted linear scan's K19 /
K20 at every design (P = 1, two columns, G x covariate columns, scaled),
batches of 1, 5, 70, 134 and 256 permutations, sample and variant counts
off K19's tiles, 70 covariate columns, code rows off alignment, the
layouts its entry point refuses and its bf16 weight check, the weighted plane sums K21 / K22 (f64, f32
selectors, non-finite weights; 1 to 17 weight sets), the weighted
joint-missing Gram K23 on every lower tile of ragged
layouts (tiles not a multiple of 64, weights 2^32 - 1, a sample missing at
every variant), and the --fast-epistasis joint tables K24 (groups not a
multiple of 32 samples, one and two groups, a ragged row block, rows out
of order, both A1 orientations).

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  On the card, from the
repository root (the repo's conftest imports jax, which that machine lacks):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 2e-5  # f32 sums of <= 4,099 terms in another order, normalised


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from plink_torch import resolve_device
    from plink_torch.ops import _cuda

    _cuda.build_all()
    return resolve_device()


def _inputs(n, vb, dc, seed):
    rng = np.random.default_rng(seed)
    npad = -(-n // 4) * 4
    maf = rng.uniform(0.01, 0.5, size=(vb, 1))
    codes = (rng.random((vb, n)) < maf).astype(np.uint8) + (rng.random((vb, n)) < maf)
    codes[rng.random((vb, n)) < 0.05] = 3
    buf = np.zeros((vb, npad), np.uint8)
    buf[:, :n] = codes
    buf = buf.reshape(vb, npad // 4, 4)
    packed = buf[..., 0] | buf[..., 1] << 2 | buf[..., 2] << 4 | buf[..., 3] << 6
    feat = np.zeros((npad, dc + 2), np.float32)
    feat[:n, 0] = 1.0
    feat[:n, 1:dc] = rng.normal(size=(n, dc - 1))
    feat[:n, dc] = rng.random(n) < 0.4
    feat[:n, dc + 1] = rng.random(n) < 0.95  # some samples out of the set
    alt = rng.random(vb) < 0.5
    gw = np.where(alt[:, None], [1.0, 2.0, 0.0], [-1.0, -2.0, 2.0]).astype(np.float32)
    return packed.astype(np.uint8), feat, gw


def _mat_err(k, p):
    dg = torch.diagonal(p, dim1=-2, dim2=-1).abs().clamp(min=1e-30)
    return float(((k - p).abs() / torch.sqrt(dg[..., :, None] * dg[..., None, :])).max())


SHAPES = [(203, 70, 1), (1000, 64, 4), (4099, 130, 12), (517, 9, 16)]


@pytest.mark.parametrize("n,vb,dc", SHAPES)
def test_geno_counts_kernel(dev, n, vb, dc):
    from plink_torch.ops.counts import geno_counts, geno_counts_plain

    packed, feat, _ = _inputs(n, vb, dc, 1)
    pk = torch.from_numpy(packed).to(dev)
    masks = torch.from_numpy(np.stack([feat[:, -1], feat[:, 1] > 0,
                                       feat[:, 1] <= 0], 1).astype(np.float32)).to(dev)
    for G in (1, 2, 3):
        m = masks[:, :G].contiguous()
        assert torch.equal(geno_counts(pk, m), geno_counts_plain(pk, m))


@pytest.mark.parametrize("n,vb,dc", SHAPES)
def test_glm_moments_kernel(dev, n, vb, dc):
    from plink_torch.ops.glm import glm_moments, glm_moments_plain

    packed, feat, gw = _inputs(n, vb, dc, 2)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    gwm = torch.from_numpy(np.stack([0.5 * gw, gw], 1)).to(dev)
    k = glm_moments(pk, gwm, f)
    assert _mat_err(k, glm_moments_plain(pk, gwm, f)) <= TOL
    assert torch.equal(k, glm_moments(pk, gwm, f))  # no atomics


@pytest.mark.parametrize("n,vb,dc", SHAPES)
@pytest.mark.parametrize("mode", ["logistic", "firth2"])
def test_glm_irls_pass_kernel(dev, n, vb, dc, mode):
    from plink_torch.ops.glm import chol_small, glm_irls_pass, glm_irls_pass_plain

    packed, feat, gw = _inputs(n, vb, dc, 3)
    rng = np.random.default_rng(4)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g = torch.from_numpy(gw).to(dev)
    beta = torch.from_numpy(rng.normal(scale=0.3, size=(vb, dc + 1))
                            .astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_irls_pass(pk, g, f, beta, torch.ones_like(active))
        _, hinv, _ = chol_small(h, inverse=True)
    km, kv, kl = glm_irls_pass(pk, g, f, beta, active, hinv)
    pm, pv, pl = glm_irls_pass_plain(pk, g, f, beta, active, hinv)
    on = active
    assert _mat_err(km[on], pm[on]) <= TOL
    scale = torch.sqrt(torch.diagonal(pm, dim1=1, dim2=2).clamp(min=1e-30) * n)
    assert float(((kv - pv).abs() / scale.clamp(min=1e-30))[on].max()) <= TOL
    assert not km[~on].any() and not kv[~on].any()
    if mode == "logistic":
        assert float(((kl - pl).abs() / pl.abs().clamp(min=1.0))[on].max()) <= 1e-6
        assert not kl[~on].any()
    again = glm_irls_pass(pk, g, f, beta, active, hinv)
    assert torch.equal(km, again[0]) and torch.equal(kv, again[1])


def _sscale(n, npad, seed):
    """--xchr-model 1 multiplier: 0.5 for a random half of the samples."""
    s = np.ones(npad, np.float32)
    s[:n] = np.where(np.random.default_rng(seed).random(n) < 0.5, 0.5, 1.0)
    return s


@pytest.mark.parametrize("n,vb,dc", SHAPES)
def test_glm_moments_scaled_kernel(dev, n, vb, dc):
    """K2's scaled mode (sscale) against its plain version; no atomics."""
    from plink_torch.ops.glm import glm_moments, glm_moments_plain

    packed, feat, gw = _inputs(n, vb, dc, 12)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    gwm = torch.from_numpy(np.stack([0.5 * gw, gw], 1)).to(dev)
    s = torch.from_numpy(_sscale(n, feat.shape[0], 13)).to(dev)
    k = glm_moments(pk, gwm, f, s)
    assert _mat_err(k, glm_moments_plain(pk, gwm, f, s)) <= TOL
    assert torch.equal(k, glm_moments(pk, gwm, f, s))


def _k3_compare(km, kv, kl, pm, pv, pl, on, n):
    assert _mat_err(km[on], pm[on]) <= TOL
    scale = torch.sqrt(torch.diagonal(pm, dim1=1, dim2=2).clamp(min=1e-30) * n)
    assert float(((kv - pv).abs() / scale.clamp(min=1e-30))[on].max()) <= TOL
    assert not km[~on].any() and not kv[~on].any()
    if kl is not None:
        assert float(((kl - pl).abs() / pl.abs().clamp(min=1.0))[on].max()) <= 1e-6
        assert not kl[~on].any()


@pytest.mark.parametrize("n,vb,dc", SHAPES)
@pytest.mark.parametrize("mode", ["logistic", "firth2"])
def test_glm_irls_pass_scaled_kernel(dev, n, vb, dc, mode):
    """K3's scaled design [c | G s] against its plain version."""
    from plink_torch.ops.glm import chol_small, glm_irls_pass, glm_irls_pass_plain

    packed, feat, gw = _inputs(n, vb, dc, 14)
    rng = np.random.default_rng(15)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g = torch.from_numpy(gw).to(dev)
    s = torch.from_numpy(_sscale(n, feat.shape[0], 16)).to(dev)
    beta = torch.from_numpy(rng.normal(scale=0.3, size=(vb, dc + 1))
                            .astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_irls_pass(pk, g, f, beta, torch.ones_like(active), sscale=s)
        _, hinv, _ = chol_small(h, inverse=True)
    k = glm_irls_pass(pk, g, f, beta, active, hinv, sscale=s)
    p = glm_irls_pass_plain(pk, g, f, beta, active, hinv, sscale=s)
    _k3_compare(*k, *p, active, n)
    again = glm_irls_pass(pk, g, f, beta, active, hinv, sscale=s)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])


@pytest.mark.parametrize("n,vb", [(203, 70), (1000, 64), (4099, 130), (517, 9)])
@pytest.mark.parametrize("mode", ["logistic", "firth2"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "sscale"])
def test_glm_irls_pass_resid_kernel(dev, n, vb, mode, scaled):
    """K3's residualized design (dc = 0: the centred column, a fixed
    offset) against its plain version, the mean from K2's sums as
    glm_resid_scan takes it."""
    from plink_torch.ops.glm import (_resid_start, chol_small, glm_irls_pass,
                                     glm_irls_pass_plain, glm_moments)

    packed, feat, gw = _inputs(n, vb, 1, 17)
    rng = np.random.default_rng(18)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g = torch.from_numpy(gw).to(dev)
    s = torch.from_numpy(_sscale(n, feat.shape[0], 19)).to(dev) if scaled else None
    off = np.zeros(feat.shape[0], np.float32)
    off[:n] = rng.normal(scale=0.5, size=n)
    off = torch.from_numpy(off).to(dev)
    mean, _, _ = _resid_start(glm_moments(pk, torch.stack([g, g], 1), f, s), 1)
    fr = f[:, 1:].contiguous()  # [y | mask]
    beta = torch.from_numpy(rng.normal(scale=0.3, size=(vb, 1))
                            .astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    design = dict(sscale=s, offset=off, gmean=mean)
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_irls_pass(pk, g, fr, beta, torch.ones_like(active), **design)
        _, hinv, _ = chol_small(h, inverse=True)
    k = glm_irls_pass(pk, g, fr, beta, active, hinv, **design)
    p = glm_irls_pass_plain(pk, g, fr, beta, active, hinv, **design)
    assert k[0].shape == (vb, 1, 1)
    _k3_compare(*k, *p, active, n)
    again = glm_irls_pass(pk, g, fr, beta, active, hinv, **design)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])


@pytest.mark.parametrize("n,V", [(203, 70), (1000, 64), (4099, 130), (9001, 65),
                                 (20000, 3)])
def test_xm1_stats_kernel(dev, n, V):
    """K14 equals its plain version exactly (w in {0, 0.5, 1}), including a
    ragged last byte, sample counts that span several 4,096-sample splits
    and samples outside the mask."""
    from plink_torch.ops.glm import xm1_stats, xm1_stats_plain

    packed, feat, _ = _inputs(n, V, 1, 20)
    npad = feat.shape[0]
    pk = torch.from_numpy(packed).to(dev)
    s = _sscale(n, npad, 21)
    w = np.stack([s, s * feat[:, 1]], 1).astype(np.float32)
    w[n:] = 0.0
    wt = torch.from_numpy(w).to(dev)
    mask = torch.from_numpy(np.ascontiguousarray(feat[:, 2])).to(dev)
    k = xm1_stats(pk, wt, mask)
    assert torch.equal(k, xm1_stats_plain(pk, wt, mask))
    assert torch.equal(k, xm1_stats(pk, wt, mask))


@pytest.mark.parametrize("d", [1, 2, 5, 13, 17, 30, 48, 49, 64, 96, 128, 250])
def test_chol_small_kernel(dev, d):
    from plink_torch.ops.glm import chol_small, chol_small_plain

    rng = np.random.default_rng(d)
    vb = 300
    a = rng.normal(size=(vb, d, d))
    h = a @ a.transpose(0, 2, 1) / d + np.eye(d)
    h[7] = -np.eye(d)  # not positive definite -> NaN
    h = torch.from_numpy(h.astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.normal(size=(vb, d)).astype(np.float32)).to(dev)
    kx, ki, kd = chol_small(h, rhs, inverse=True, logdet=True)
    px, pi, pd = chol_small_plain(h, rhs, True, True)
    good = torch.arange(vb, device=dev) != 7
    assert torch.isnan(kx[7]).all() and torch.isnan(ki[7]).all()
    assert torch.isnan(kd[7])
    rel = lambda k, p: float(((k - p).abs().flatten(1).amax(1)  # noqa: E731
                              / p.abs().flatten(1).amax(1))[good].max())
    assert rel(kx, px) <= 1e-4 and rel(ki, pi) <= 1e-4
    assert float((kd - pd)[good].abs().max()) <= 1e-4 * d
    only_x, none_i, none_d = chol_small(h, rhs)
    assert none_i is None and none_d is None
    assert torch.equal(only_x[good], kx[good]) and torch.isnan(only_x[7]).all()


@pytest.mark.parametrize("n,vb,dc", SHAPES + [(2001, 600, 2)])
def test_sample_counts_kernel(dev, n, vb, dc):
    """K5 equals its plain version exactly: one and two variant masks, the
    missing and the (het, hom-ALT, missing) modes."""
    from plink_torch.ops.counts import sample_counts, sample_counts_plain

    packed, _, _ = _inputs(n, vb, dc, 5)
    rng = np.random.default_rng(6)
    pk = torch.from_numpy(packed).to(dev)
    vm = torch.from_numpy((rng.random((vb, 2)) < 0.7).astype(np.float32)).to(dev)
    for G in (1, 2):
        m = vm[:, :G].contiguous()
        for het_hom in (False, True):
            k = sample_counts(pk, m, het_hom)
            assert torch.equal(k, sample_counts_plain(pk, m, het_hom))
            assert torch.equal(k, sample_counts(pk, m, het_hom))


@pytest.mark.parametrize("swap", [False, True], ids=["alt", "a1_ref"])
@pytest.mark.parametrize("n,vb,dc", SHAPES + [(1000, 40, 49)])  # 49: chunked rows
def test_linear_sums_kernel(dev, n, vb, dc, swap):
    """K6 against its plain version run in f64, each entry normalised by a
    Cauchy-Schwarz bound on its plane sum; two runs give identical bytes.
    With `swap`, a seeded half of the variants have A1 = REF (their hom-REF
    plane summed in place of hom-ALT)."""
    from plink_torch.ops.glm import linear_sums, linear_sums_plain
    from plink_torch.ops.planes import unpack_codes

    packed, feat, _ = _inputs(n, vb, dc, 7)
    pk = torch.from_numpy(packed).to(dev)
    c = feat[:, :dc].astype(np.float64)
    y = (feat[:, dc] + np.random.default_rng(8).normal(size=feat.shape[0])) \
        * feat[:, 0]
    ccfl = (c[:, :, None] * c[:, None, :]).reshape(-1, dc * dc)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (ccfl, c * y[:, None], y * y)]
    a1r = torch.from_numpy(np.random.default_rng(9).random(vb) < 0.5).to(dev) \
        if swap else None
    k = linear_sums(pk, *(t.float() for t in ins), a1r)
    again = linear_sums(pk, *(t.float() for t in ins), a1r)
    r = linear_sums_plain(pk, *ins, a1r)
    codes = unpack_codes(pk)
    if swap:
        codes = torch.where(a1r[:, None] & (codes % 2 == 0), 2 - codes, codes)
    for code, p_ in ((1, "h"), (2, "a"), (3, "m")):
        dg = torch.diagonal(r[p_ + "cc"].reshape(vb, dc, dc), dim1=1,
                            dim2=2).clamp(min=1e-30)
        sc = torch.sqrt(dg[:, :, None] * dg[:, None, :]).reshape(vb, -1)
        assert float(((k[p_ + "cc"] - r[p_ + "cc"]).abs() / sc).max()) <= TOL
        yy = ((codes == code).double() @ ins[2]).clamp(min=1e-30)
        sy = torch.sqrt(dg * yy[:, None])
        assert float(((k[p_ + "cy"] - r[p_ + "cy"]).abs() / sy).max()) <= TOL
    assert float(((k["myy"] - r["myy"]).abs()
                  / r["myy"].clamp(min=1e-30)).max()) <= TOL
    for key in k:
        assert k[key].dtype == torch.float64
        assert torch.equal(k[key], again[key])


# the last: a 40 x 40 tile below one 64 x 64 block, 20 variants below one
# 128-variant stage of K7
PAIR_SHAPES = [(150, 5, 64), (1001, 3, 700), (2300, 2, 2048), (40, 1, 20)]


def _pair_inputs(n, nb, vb, seed):
    """Packed [nb, vb, NB] codes of n samples (NB padded to a multiple of 4
    samples), an int8 variant mask with zeros, and GRM coefficients."""
    rng = np.random.default_rng(seed)
    packed, _, _ = _inputs(n, nb * vb, 2, seed)
    vmask = (rng.random((nb, vb)) < 0.9).astype(np.int8)
    coef = (rng.normal(size=(nb, vb, 3)) * vmask[..., None]).astype(np.float32)
    return packed.reshape(nb, vb, -1), vmask, coef


def _pair_tiles(npad):
    """The whole panel as one diagonal tile, and an off-diagonal tile whose
    sides are not multiples of the kernels' 64 / 128-sample blocks."""
    s = (npad // 3) // 4 * 4
    return [(0, 0, npad, npad), (npad - s, 4, s, s - 8)]


@pytest.mark.parametrize("n,nb,vb", PAIR_SHAPES)
def test_king_gram_kernel(dev, n, nb, vb):
    """K7 equals its plain version exactly: the six counters, and kin (bit
    for bit), nsnp / hethet / ibs0, the pass mask and count; twice."""
    from plink_torch.ops.pairwise import (king_gram, king_gram_plain,
                                          pairwise_inputs_from_numpy)

    packed, vmask, _ = _pair_inputs(n, nb, vb, 11)
    pk, vm = pairwise_inputs_from_numpy(packed, vmask, device=dev)
    for r0, c0, s, t in _pair_tiles(pk.shape[2] * 4):
        k = king_gram(pk, vm, r0, c0, s, t, counts=True)
        assert torch.equal(k, king_gram_plain(pk, vm, r0, c0, s, t, counts=True))
        for thresh in (-np.inf, 0.02):
            k = king_gram(pk, vm, r0, c0, s, t, n=n, thresh=thresh)
            p = king_gram_plain(pk, vm, r0, c0, s, t, n=n, thresh=thresh)
            assert k[0].cpu().numpy().tobytes() == p[0].cpu().numpy().tobytes()
            assert all(torch.equal(a, b) for a, b in zip(k[1:], p[1:]))
            again = king_gram(pk, vm, r0, c0, s, t, n=n, thresh=thresh)
            assert all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                       for a, b in zip(k, again))


# K8's CTA is 128 rows x 64 columns streaming 128-variant stages in f32 runs
# of ops.pairwise._K8_RUN variants: tiles off both (ragged rows and columns,
# row0 != col0, the last anchor pulled back inside npad), variant counts off
# a stage and spanning several runs, code rows a multiple of 16 bytes with
# row0 and col0 on 64-sample boundaries (16-byte cp.async copies) and not
# (plain loads)
K8_SHAPES = [(1000, 3, 203), (1024, 2, 300), (300, 1, 31), (2048, 5, 128)]
TOL_K8 = 2e-6  # chip_smoke.TOL_K8, the same normalisation


def _k8_tiles(npad):
    """_pair_tiles, and the tiles off K8's 128 x 64 CTA on both sides that fit
    inside the panel's npad samples."""
    ragged = [(npad - 132, 16, 132, 196), (16, 48, 196, 132), (4, 0, 68, npad - 4),
              (npad - 128, npad - 64, 128, 64)]
    return _pair_tiles(npad) + [(r0, c0, s, t) for r0, c0, s, t in ragged
                                if min(r0, c0) >= 0 and t > 0 and r0 + s <= npad
                                and c0 + t <= npad]


@pytest.mark.parametrize("n,nb,vb", PAIR_SHAPES + K8_SHAPES)
def test_grm_gram_kernel(dev, n, nb, vb):
    """K8 against its plain version and an f64 numpy product, each entry
    normalised by sqrt(sum Z_i^2 sum Z_j^2) (K8 within chip_smoke's TOL_K8,
    the plain version within TOL): tile and chunk modes, the pair counts
    exact, two runs identical."""
    from plink_torch.ops.pairwise import (grm_gram, grm_gram_plain,
                                          pairwise_inputs_from_numpy,
                                          sample_miss_counts)
    from plink_torch.ops.planes import _unpack_np

    packed, vmask, coef = _pair_inputs(n, nb, vb, 12)
    pk, vm, cf = pairwise_inputs_from_numpy(packed, vmask, coef, dev)
    miss = sample_miss_counts(pk, vm)
    mv = int(vmask.sum())
    codes = _unpack_np(packed.reshape(nb * vb, -1)).astype(np.int64)
    z = np.take_along_axis(coef.reshape(-1, 3).astype(np.float64),
                           np.minimum(codes, 2), axis=1)
    z[codes == 3] = 0.0
    for r0, c0, s, t in _k8_tiles(pk.shape[2] * 4):
        ref = z[:, r0 : r0 + s].T @ z[:, c0 : c0 + t]
        d_r = (z[:, r0 : r0 + s] ** 2).sum(0)
        d_c = (z[:, c0 : c0 + t] ** 2).sum(0)
        scale = np.sqrt(np.outer(d_r, d_c)).clip(min=1e-30)
        for fetch32 in (False, True):
            acc, nm = grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t, tile=True,
                               fetch32=fetch32)
            pacc, pnm = grm_gram_plain(pk, cf, vm, miss, mv, r0, c0, s, t,
                                       tile=True, fetch32=fetch32)
            assert torch.equal(nm, pnm)
            for a, tol in ((acc, TOL_K8), (pacc, TOL)):
                err = np.abs(a.double().cpu().numpy() - ref) / scale
                assert float(err.max()) <= tol, (r0, c0, s, t, fetch32, float(err.max()))
            again = grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t, tile=True,
                             fetch32=fetch32)
            assert torch.equal(acc, again[0]) and torch.equal(nm, again[1])
        g, gnm = grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t)
        pg, pgnm = grm_gram_plain(pk, cf, vm, miss, mv, r0, c0, s, t)
        assert gnm.dtype == torch.float32
        assert torch.equal(gnm, pgnm) and torch.equal(gnm, pnm.float())
        nmv = pnm.double().cpu().numpy()
        err = np.abs(g.double().cpu().numpy() - ref / nmv) * nmv / scale
        assert float(np.nanmax(err)) <= TOL_K8, (r0, c0, s, t)
        assert torch.equal(g.nan_to_num(7.0),
                           grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t)[0].nan_to_num(7.0))


PCA_SHAPES = [(150, 3, 64, 3), (4099, 2, 200, 20), (2301, 3, 2048, 37)]


def _pca_inputs(n, nb, vb, L, seed):
    """Packed [nb, vb, NB] codes, GRM-style coefficients with zeroed rows,
    the sample mask of n samples, q [npad, L] and b [nb, vb, L]."""
    rng = np.random.default_rng(seed)
    packed, _, _ = _inputs(n, nb * vb, 2, seed)
    npad = packed.shape[1] * 4
    coef = rng.normal(size=(nb * vb, 3)).astype(np.float32)
    coef[rng.random(nb * vb) < 0.1] = 0.0
    smask = np.zeros(npad, np.float32)
    smask[:n] = 1.0
    q = rng.standard_normal((npad, L)).astype(np.float32) * 1e3
    b = rng.standard_normal((nb, vb, L)).astype(np.float32)
    return packed.reshape(nb, vb, -1), coef.reshape(nb, vb, 3), smask, q, b


@pytest.mark.parametrize("n,nb,vb,L", PCA_SHAPES)
def test_pca_kernels(dev, n, nb, vb, L):
    """K9 (x_apply), K10 (xt_apply) and K9 + K10 (xtx_apply) against their
    plain versions run in f64, each entry normalised by sqrt(sum Z^2 sum
    q^2) over the contracted axis; two runs give identical bytes."""
    from plink_torch.ops import pca as P

    packed, coef, smask, q, b = _pca_inputs(n, nb, vb, L, 13)
    pk, cf, sm, qd = P.pca_inputs_from_numpy(packed, coef, smask, q, dev)
    bd = torch.from_numpy(b).to(dev)
    z = torch.stack([P._normed_block(pk[k], cf[k].double(), sm) for k in range(nb)])
    zf = z.reshape(nb * vb, -1)
    z2v, z2s = (zf ** 2).sum(1), (zf ** 2).sum(0)
    got = P.x_apply(pk, cf, sm, qd)
    ref = P.x_apply_plain(pk, cf.double(), sm, qd.double())
    sc = torch.sqrt(z2v[:, None] * (qd.double() ** 2).sum(0)[None, :])
    assert float(((got.double() - ref).reshape(-1, L).abs() / sc.clamp(min=1e-30)).max()) <= TOL
    assert torch.equal(got, P.x_apply(pk, cf, sm, qd))
    got = P.xt_apply(pk, cf, sm, bd)
    ref = P.xt_apply_plain(pk, cf.double(), sm, bd.double())
    sc = torch.sqrt(z2s[:, None] * (bd.double().reshape(-1, L) ** 2).sum(0)[None, :])
    assert float(((got.double() - ref).abs() / sc.clamp(min=1e-30)).max()) <= TOL
    assert torch.equal(got, P.xt_apply(pk, cf, sm, bd))
    got = P.xtx_apply(pk, cf, sm, qd)
    ref = P.xtx_apply_plain(pk, cf.double(), sm, qd.double())
    t = zf @ qd.double()
    sc = torch.sqrt(z2s[:, None] * (t ** 2).sum(0)[None, :])
    assert float(((got.double() - ref).abs() / sc.clamp(min=1e-30)).max()) <= TOL
    assert torch.equal(got, P.xtx_apply(pk, cf, sm, qd))


LD_SHAPES = [(150, 300, 20), (1001, 700, 200), (77, 130, 129), (2300, 64, 0)]


@pytest.mark.parametrize("n,V,width", LD_SHAPES)
def test_ld_band_bits_kernel(dev, n, V, width):
    """K11 equals its plain version exactly (bits and the three count
    vectors) at thresholds 0.2 and 0.5, with masked samples, LD runs and
    monomorphic variants; the band's edges (d = 0, i + d >= n) are 0."""
    from plink_torch.ops.ld import ld_band_bits, ld_band_bits_plain

    rng = np.random.default_rng(n)
    packed, _, _ = _inputs(n, V, 2, 21)
    for v0 in range(0, V - 4, 11):  # copies of a variant: r^2 near 1
        packed[v0 + 1] = packed[v0]
    packed[3] = 0  # monomorphic hom-REF
    npad = packed.shape[1] * 4
    smask = (rng.random(npad) < 0.9).astype(np.int8)
    smask[n:] = 0
    pk = torch.from_numpy(packed).to(dev)
    sm = torch.from_numpy(smask).to(dev)
    width = min(width, V - 1)
    for r2t in (0.2, 0.5):
        got = ld_band_bits(pk, sm, width, r2t)
        ref = ld_band_bits_plain(pk, sm, width, r2t)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert all(torch.equal(a, b) for a, b in zip(got, ld_band_bits(pk, sm, width, r2t)))
    assert not got[0][:, 0].any()


@pytest.mark.parametrize("n,V,width", LD_SHAPES)
def test_ld_band_stats_kernel(dev, n, V, width):
    """K12 equals its plain version exactly (the six statistics, d = 0
    included, and the three count vectors), 0 past the subcontig's end; its
    counts equal K11's."""
    from plink_torch.ops.ld import ld_band_bits, ld_band_stats, ld_band_stats_plain

    rng = np.random.default_rng(n + 1)
    packed, _, _ = _inputs(n, V, 2, 22)
    for v0 in range(0, V - 4, 13):
        packed[v0 + 1] = packed[v0]
    npad = packed.shape[1] * 4
    smask = (rng.random(npad) < 0.9).astype(np.int8)
    smask[n:] = 0
    pk = torch.from_numpy(packed).to(dev)
    sm = torch.from_numpy(smask).to(dev)
    width = min(width, V - 1)
    got = ld_band_stats(pk, sm, width)
    ref = ld_band_stats_plain(pk, sm, width)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(got, ld_band_stats(pk, sm, width)))
    bits = ld_band_bits(pk, sm, width, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], bits[1:]))
    ii = torch.arange(V, device=dev)[:, None]
    dd = torch.arange(width + 1, device=dev)[None, :]
    assert not got[0][:, ii + dd >= V].any()


# then chunks of 1-63 variants against 64-200, below one k32 step of samples
# (20, 30) and at 10,001, and rows of 512 bytes: K13 copies 16-byte pieces
# when the rows are 16-byte aligned (2,048 samples), windows of them when 4-
# byte aligned (77, 30), bytes otherwise
GRAM_SHAPES = [(150, 70, 45), (1001, 512, 512), (77, 1, 300), (2300, 256, 130),
               (10001, 600, 64), (20, 5, 64), (30, 63, 200), (10001, 1, 200),
               (10001, 37, 130), (2048, 100, 64)]


@pytest.mark.parametrize("n,ca,cb", GRAM_SHAPES)
def test_ld_gram_pair_kernel(dev, n, ca, cb):
    """K13 equals its plain version exactly for chunks of different lengths
    (tiles cut ragged; the samples split over a cluster or not), with a
    chunk against itself, twice."""
    from plink_torch.ops.ld import ld_gram_pair, ld_gram_pair_plain

    rng = np.random.default_rng(ca + cb)
    packed, _, _ = _inputs(n, ca + cb, 2, 23)
    npad = packed.shape[1] * 4
    smask = (rng.random(npad) < 0.85).astype(np.int8)
    smask[n:] = 0
    pa = torch.from_numpy(packed[:ca]).to(dev)
    pb = torch.from_numpy(packed[ca:]).to(dev)
    sm = torch.from_numpy(smask).to(dev)
    for a, b in ((pa, pb), (pa, pa), (pb, pa)):
        got = ld_gram_pair(a, b, sm)
        assert got.shape == (3 * a.shape[0], 3 * b.shape[0])
        assert torch.equal(got, ld_gram_pair_plain(a, b, sm))
        assert torch.equal(got, ld_gram_pair(a, b, sm))


# ---------------------------------------------------------------------------
# several genotype columns: K2 / K3 with P = 2, K15 / K16
# ---------------------------------------------------------------------------


def _design(gw, dc, design):
    """Plane weights [vb, P, 3] and covj of a test design over the dc
    covariates: 'p2' = (ADD, DOMDEV) (K2 / K3 P = 2), 'interaction' = ADD and
    ADD x each non-intercept covariate (K15 / K16 once dc > 1), 'p2_scaled'
    = p2 with a per-sample multiplier (K15 / K16)."""
    g = torch.from_numpy(gw)
    dom = torch.zeros_like(g)
    dom[:, 0] = 1.0
    if design.startswith("p2"):
        return torch.stack([g, dom], 1).contiguous(), (0, 0)
    return torch.stack([g] * dc, 1).contiguous(), tuple(range(dc))


JOINT = ["p2", "interaction", "p2_scaled"]


def _expect_mode(before, kernel, design, dc):
    """The mode a launch of `kernel` ('moments' / 'irls') went to."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import P2_MAX_DC

    wide = design != "p2" or dc > P2_MAX_DC
    if design == "interaction" and dc == 1:
        return  # a single column with no covariate factor: K2 / K3
    name = f"glm_{kernel}_{'wide' if wide else 'p2'}"
    assert _cuda.LAUNCHES[name] > before.get(name, 0), (name, _cuda.LAUNCHES)


@pytest.mark.parametrize("design", JOINT)
@pytest.mark.parametrize("n,vb,dc", SHAPES)
def test_glm_moments_joint_kernel(dev, n, vb, dc, design):
    """K2 with two model columns and K15 (G x covariate columns, scaled)
    against the plain version; no atomics."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import glm_moments, glm_moments_plain

    packed, feat, gw = _inputs(n, vb, dc, 22)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g3, covj = _design(gw, dc, design)
    gwm = torch.cat([g3, g3[:, :1]], 1).contiguous().to(dev)
    s = torch.from_numpy(_sscale(n, feat.shape[0], 23)).to(dev) \
        if design == "p2_scaled" else None
    before = dict(_cuda.LAUNCHES)
    k = glm_moments(pk, gwm, f, s, covj + (0,))
    _expect_mode(before, "moments", design, dc)
    assert _mat_err(k, glm_moments_plain(pk, gwm, f, s, covj + (0,))) <= TOL
    assert torch.equal(k, glm_moments(pk, gwm, f, s, covj + (0,)))


@pytest.mark.parametrize("design", JOINT)
@pytest.mark.parametrize("n,vb,dc", SHAPES)
@pytest.mark.parametrize("mode", ["logistic", "firth2"])
def test_glm_irls_pass_joint_kernel(dev, n, vb, dc, mode, design):
    """K3 with two genotype columns and K16 (G x covariate columns, scaled)
    against the plain version, inactive rows zero, two runs identical."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import chol_small, glm_irls_pass, glm_irls_pass_plain

    packed, feat, gw = _inputs(n, vb, dc, 24)
    rng = np.random.default_rng(25)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g3, covj = _design(gw, dc, design)
    g3 = g3.to(dev)
    d = dc + g3.shape[1]
    s = torch.from_numpy(_sscale(n, feat.shape[0], 26)).to(dev) \
        if design == "p2_scaled" else None
    beta = torch.from_numpy(rng.normal(scale=0.2 / d ** 0.5, size=(vb, d))
                            .astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    design_kw = dict(sscale=s, covj=covj)
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_irls_pass(pk, g3, f, beta, torch.ones_like(active),
                                **design_kw)
        _, hinv, _ = chol_small(h, inverse=True)
        # a variant with no hom-ALT call has DOMDEV = ADD: H is singular, and
        # with few the hat value x^T Hinv x cancels terms of size cond(H), so
        # two f32 evaluations agree to the rule only where cond(H) < 1e4
        active &= torch.linalg.cond(h.double()) < 1e4
    before = dict(_cuda.LAUNCHES)
    k = glm_irls_pass(pk, g3, f, beta, active, hinv, **design_kw)
    _expect_mode(before, "irls", design, dc)
    p = glm_irls_pass_plain(pk, g3, f, beta, active, hinv, **design_kw)
    _k3_compare(*k, *p, active, n)
    again = glm_irls_pass(pk, g3, f, beta, active, hinv, **design_kw)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])


@pytest.mark.parametrize("n,vb,dc", SHAPES)
@pytest.mark.parametrize("mode", [0, 1], ids=["logistic", "firth2"])
def test_glm_irls_wide_equals_k3_on_one_column(dev, n, vb, dc, mode):
    """K16 on the one-column design K3 takes: the same sums to f32 rounding
    (the same per-entry sample order and arithmetic; the f64 loglik is
    added in another order)."""
    from plink_torch.ops.glm import _splits, _wide, chol_small, glm_irls_pass

    packed, feat, gw = _inputs(n, vb, dc, 27)
    rng = np.random.default_rng(28)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g3 = torch.from_numpy(gw)[:, None, :].contiguous().to(dev)
    d = dc + 1
    beta = torch.from_numpy(rng.normal(scale=0.3, size=(vb, d))
                            .astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    hinv = None
    if mode == 1:
        h, _, _ = glm_irls_pass(pk, g3, f, beta, torch.ones_like(active))
        _, hinv, _ = chol_small(h, inverse=True)
    km, kv, kl = glm_irls_pass(pk, g3, f, beta, active, hinv)
    wm = torch.empty_like(km)
    wv = torch.empty_like(kv)
    wl = torch.empty_like(kl) if kl is not None else None
    _wide(mode, pk, f, dc, g3, (0,), *_splits(f.shape[0]), beta=beta, hinv=hinv,
          active=active, out_mat=wm, out_vec=wv, out_ll=wl)
    assert _mat_err(wm[active], km[active]) <= 1e-6
    scale = torch.sqrt(torch.diagonal(km, dim1=1, dim2=2).clamp(min=1e-30) * n)
    assert float(((wv - kv).abs() / scale)[active].max()) <= 1e-6
    if kl is not None:
        assert float(((wl - kl).abs() / kl.abs().clamp(min=1.0))[active].max()) <= 1e-12


@pytest.mark.parametrize("n,vb", [(203, 70), (1000, 64), (4099, 130), (517, 9)])
@pytest.mark.parametrize("mode", ["logistic", "firth2"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "sscale"])
def test_glm_irls_pass_resid_p2_kernel(dev, n, vb, mode, scaled):
    """K3's residualized design with two columns (`genotypic
    cc-residualize`) against its plain version, the means from K2's sums as
    glm_resid_scan takes them."""
    from plink_torch.ops.glm import (_resid_start, chol_small, glm_irls_pass,
                                     glm_irls_pass_plain, glm_moments)

    packed, feat, gw = _inputs(n, vb, 1, 29)
    rng = np.random.default_rng(30)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g3, _ = _design(gw, 1, "p2")
    g3 = g3.to(dev)
    s = torch.from_numpy(_sscale(n, feat.shape[0], 31)).to(dev) if scaled else None
    off = np.zeros(feat.shape[0], np.float32)
    off[:n] = rng.normal(scale=0.5, size=n)
    off = torch.from_numpy(off).to(dev)
    mean, _, _ = _resid_start(glm_moments(pk, torch.cat([g3, g3[:, :1]], 1)
                                          .contiguous(), f, s), 1, 2)
    fr = f[:, 1:].contiguous()  # [y | mask]
    beta = torch.from_numpy(rng.normal(scale=0.3, size=(vb, 2))
                            .astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    design = dict(sscale=s, offset=off, gmean=mean)
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_irls_pass(pk, g3, fr, beta, torch.ones_like(active), **design)
        _, hinv, _ = chol_small(h, inverse=True)
        active &= torch.linalg.cond(h.double()) < 1e4  # as in the joint test
    k = glm_irls_pass(pk, g3, fr, beta, active, hinv, **design)
    p = glm_irls_pass_plain(pk, g3, fr, beta, active, hinv, **design)
    assert k[0].shape == (vb, 2, 2)
    _k3_compare(*k, *p, active, n)


# ---------------------------------------------------------------------------
# the dosage kernels K17 / K18 and the widths past 96
# ---------------------------------------------------------------------------


def _dense_inputs(n, vb, dc, seed):
    """uint16 A1 dosages [vb, npad] (65535 missing and padding; some rows
    hard calls only, some A1 = REF) and the [c | y | mask] table."""
    _, feat, _ = _inputs(n, vb, dc, seed)
    rng = np.random.default_rng(seed + 100)
    npad = feat.shape[0]
    maf = rng.uniform(0.01, 0.5, size=(vb, 1))
    hard = ((rng.random((vb, n)) < maf).astype(np.int64)
            + (rng.random((vb, n)) < maf)) * 16384
    soft = np.clip(hard + rng.integers(-6000, 6001, (vb, n)), 0, 32768)
    u = np.where((rng.random((vb, n)) < 0.7) & (np.arange(vb) % 5 != 0)[:, None],
                 soft, hard)
    u = np.where((np.arange(vb) % 2 == 1)[:, None], 32768 - u, u)
    dos = np.full((vb, npad), 65535, np.uint16)
    dos[:, :n] = np.where(rng.random((vb, n)) < 0.05, 65535, u)
    return dos, feat


DENSE_SHAPES = SHAPES + [(1000, 40, 20)]  # dc = 20: K15 / K16's dense mode


@pytest.mark.parametrize("n,vb,dc", DENSE_SHAPES)
def test_glm_dense_moments_kernel(dev, n, vb, dc):
    """K17 (K15 dense above dc = 16) against its plain version; no
    atomics."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import glm_dense_moments, glm_dense_moments_plain

    dos, feat = _dense_inputs(n, vb, dc, 40)
    u = torch.from_numpy(dos).to(dev)
    f = torch.from_numpy(feat).to(dev)
    before = dict(_cuda.LAUNCHES)
    k = glm_dense_moments(u, f)
    name = "glm_moments_wide" if dc > 16 else "glm_dense_moments"
    assert _cuda.LAUNCHES[name] == before[name] + 1
    assert k.shape == (vb, dc + 2, dc + 2)
    assert _mat_err(k, glm_dense_moments_plain(u, f)) <= TOL
    assert torch.equal(k, glm_dense_moments(u, f))


@pytest.mark.parametrize("n,vb,dc", DENSE_SHAPES)
@pytest.mark.parametrize("mode", ["logistic", "firth2"])
def test_glm_dense_irls_kernel(dev, n, vb, dc, mode):
    """K18 (K16 dense above dc = 16) against its plain version, inactive
    rows zero, two runs identical."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import chol_small, glm_dense_irls, glm_dense_irls_plain

    dos, feat = _dense_inputs(n, vb, dc, 41)
    rng = np.random.default_rng(42)
    u = torch.from_numpy(dos).to(dev)
    f = torch.from_numpy(feat).to(dev)
    beta = torch.from_numpy(rng.normal(scale=0.3 / (dc + 1) ** 0.5,
                                       size=(vb, dc + 1)).astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(vb) < 0.8).to(dev)
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_dense_irls(u, f, beta, torch.ones_like(active))
        _, hinv, _ = chol_small(h, inverse=True)
    before = dict(_cuda.LAUNCHES)
    k = glm_dense_irls(u, f, beta, active, hinv)
    name = "glm_irls_wide" if dc > 16 else \
        "glm_dense_irls" if mode == "logistic" else "glm_dense_firth"
    assert _cuda.LAUNCHES[name] == before[name] + 1
    _k3_compare(*k, *glm_dense_irls_plain(u, f, beta, active, hinv), active, n)
    again = glm_dense_irls(u, f, beta, active, hinv)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])


@pytest.mark.parametrize("mode", ["moments", "logistic", "firth2"])
def test_glm_wide_kernels_at_d128(dev, mode):
    """K15 / K16 at d = 128 (`interaction` over 63 covariates: the tile list
    is split over CTAs) against the plain versions; two runs identical."""
    from plink_torch.ops.glm import (chol_small, glm_irls_pass, glm_irls_pass_plain,
                                     glm_moments, glm_moments_plain)

    n, vb, dc = 3000, 6, 64
    packed, feat, gw = _inputs(n, vb, dc, 43)
    rng = np.random.default_rng(44)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    g3, covj = _design(gw, dc, "interaction")
    g3 = g3.to(dev)
    d = dc + g3.shape[1]
    assert d == 128
    if mode == "moments":
        gwm = torch.cat([g3, g3[:, :1]], 1).contiguous()
        k = glm_moments(pk, gwm, f, None, covj + (0,))
        assert _mat_err(k, glm_moments_plain(pk, gwm, f, None, covj + (0,))) <= TOL
        assert torch.equal(k, glm_moments(pk, gwm, f, None, covj + (0,)))
        return
    beta = torch.from_numpy(rng.normal(scale=0.2 / d ** 0.5, size=(vb, d))
                            .astype(np.float32)).to(dev)
    active = torch.ones(vb, dtype=torch.bool, device=dev)
    active[2] = False
    hinv = None
    if mode == "firth2":
        h, _, _ = glm_irls_pass(pk, g3, f, beta, torch.ones_like(active), covj=covj)
        _, hinv, _ = chol_small(h, inverse=True)
        active &= torch.linalg.cond(h.double()) < 1e4
    k = glm_irls_pass(pk, g3, f, beta, active, hinv, covj=covj)
    _k3_compare(*k, *glm_irls_pass_plain(pk, g3, f, beta, active, hinv, covj=covj),
                active, n)
    again = glm_irls_pass(pk, g3, f, beta, active, hinv, covj=covj)
    assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])


PERM_DESIGNS = ["p1", "p2", "interaction", "p2_scaled"]
# K19's tiles are 128 variants x 32 samples, its f32 runs 512 samples
# (plink_torch.ops.glm._PERM_RUN), and it copies a row's code bytes 8 or 4
# at a time when the row length allows (else byte by byte): 2,085 samples
# (ragged stage, five runs, byte copies) over 300 variants, 4,112 (4-byte
# copies, a ragged ninth run) over 129, 4,128 (8-byte copies, nine runs)
# over 257
PERM_SHAPES = SHAPES + [(2085, 300, 5), (4112, 129, 2), (4128, 257, 12)]


@pytest.mark.parametrize("B", [1, 5, 70, 134, 256])
@pytest.mark.parametrize("design", PERM_DESIGNS)
@pytest.mark.parametrize("n,vb,dc", PERM_SHAPES)
def test_linear_perm_kernels(dev, n, vb, dc, design, B):
    """K19 (the permuted X^T y and y^T y) against its plain version in f64,
    normalised by the sum of the terms' magnitudes, two runs identical; K20
    (t, or the joint F for p2) against its plain version on the K2 / K4
    inverses, NaN where they are."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import (linear_perm_stat, linear_perm_stat_plain,
                                     linear_perm_xty, linear_perm_xty_plain,
                                     perm_inverses)

    packed, feat, gw = _inputs(n, vb, dc, 51)
    rng = np.random.default_rng(52)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    c, mask = f[:, :dc].contiguous(), f[:, dc + 1].contiguous()
    if design == "p1":
        g3, covj = torch.from_numpy(gw)[:, None].contiguous(), (0,)
    else:
        g3, covj = _design(gw, dc, design)
    g3 = g3.to(dev)
    ss = torch.from_numpy(np.where(rng.random(f.shape[0]) < 0.5, 0.5, 1.0)
                          .astype(np.float32)).to(dev) \
        if design == "p2_scaled" else None
    Y = torch.from_numpy(rng.normal(1.0, 2.0, size=(f.shape[0], B))
                         .astype(np.float32)).to(dev) * mask[:, None]
    before = _cuda.LAUNCHES["linear_perm_xty"]
    xty, yy = linear_perm_xty(pk, g3, c, Y, mask, covj, ss)
    assert _cuda.LAUNCHES["linear_perm_xty"] == before + 1
    dbl = (lambda t: None if t is None else t.double())
    p_xty, p_yy = linear_perm_xty_plain(pk, g3.double(), c.double(), Y.double(),
                                        mask.double(), covj, dbl(ss))
    a_xty, a_yy = linear_perm_xty_plain(pk, g3.double().abs(), c.double().abs(),
                                        Y.double().abs(), mask.double(), covj,
                                        dbl(ss))
    assert float(((xty - p_xty).abs() / a_xty.clamp(min=1e-30)).max()) <= TOL
    assert float(((yy - p_yy).abs() / a_yy.clamp(min=1e-30)).max()) <= TOL
    again = linear_perm_xty(pk, g3, c, Y, mask, covj, ss)
    assert torch.equal(xty, again[0]) and torch.equal(yy, again[1])

    # K20 works in f64 on its f32 inputs: held to the plain version run in
    # f64 on them, on the rows whose design an f64 solve resolves
    q = 2 if design.startswith("p2") else 0
    (inv, inv0, nm), = perm_inverses(pk[None], g3[None], c, mask, covj, q, ss)
    k = linear_perm_stat(inv, xty, yy, nm, dc, q, inv0)
    p = linear_perm_stat_plain(inv.double(), xty.double(), yy.double(),
                               nm.double(), dc, q, dbl(inv0))
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    good = (torch.linalg.cond(inv.double()) < 1e6)[:, None] & torch.isfinite(p)
    assert float(good.float().mean()) > 0.5
    assert float(((k - p).abs() / p.abs().clamp(min=1.0))[good].max()) <= 1e-5
    again = linear_perm_stat(inv, xty, yy, nm, dc, q, inv0)
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))  # NaN too


@pytest.mark.parametrize("B", [1, 33, 134, 268])
@pytest.mark.parametrize("d,q", [(13, 0), (14, 2), (24, 0), (24, 12), (51, 5),
                                 (51, 0)])
def test_linear_perm_stat_kernel(dev, d, q, B):
    """K20 at every path of its entry point (d <= 16 and <= 32 unrolled over
    registers, one and two permutations a thread; d = 51 the generic loop;
    B off a warp and past one CTA's 256 threads; t and joint F) against its
    plain version in f64 on the same f32 inputs, NaN where an inverse is,
    two runs identical."""
    from plink_torch.ops.glm import _kept, linear_perm_stat, linear_perm_stat_plain

    rng = np.random.default_rng(1000 * d + 10 * q + B)
    vb, tc = 37, 12
    a = rng.normal(size=(vb, d, d))
    inv = (a @ a.transpose(0, 2, 1) / d + np.eye(d)).astype(np.float32)
    inv[3] = np.nan  # a singular design
    xty = rng.normal(size=(vb, d, B)).astype(np.float32)
    bx = np.einsum("vjb,vjb->vb", np.einsum("vij,vjb->vib", inv.astype(np.float64), xty),
                   xty)
    yy = (np.nan_to_num(bx) + rng.uniform(5.0, 50.0, size=(vb, B))).astype(np.float32)
    nm = rng.uniform(d + 2.0, 600.0, size=vb).astype(np.float32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in
         (("inv", inv), ("xty", xty), ("yy", yy), ("nm", nm))}
    inv0 = None
    if q:
        keep = _kept(d, tc, q)
        inv0 = t["inv"][:, keep][:, :, keep].contiguous()
    k = linear_perm_stat(t["inv"], t["xty"], t["yy"], t["nm"], tc, q, inv0)
    p = linear_perm_stat_plain(t["inv"].double(), t["xty"].double(), t["yy"].double(),
                               t["nm"].double(), tc, q,
                               None if inv0 is None else inv0.double())
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    fin = torch.isfinite(p)
    assert float(fin.float().mean()) > 0.9
    assert float(((k - p).abs() / p.abs().clamp(min=1.0))[fin].max()) <= 1e-5
    again = linear_perm_stat(t["inv"], t["xty"], t["yy"], t["nm"], tc, q, inv0)
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("B", [5, 134])
@pytest.mark.parametrize("design", ["p1", "p2_scaled"])
def test_linear_perm_xty_many_covariates(dev, design, B):
    """K19 with more than 63 covariate columns: a column tile of the
    valid-plane rows then holds fewer than all dc + 1 of a permutation's
    rows, and its c columns are staged as a range that wraps past the yy
    row; against the plain version in f64 as above, two runs identical."""
    from plink_torch.ops.glm import linear_perm_xty, linear_perm_xty_plain

    n, vb, dc = 700, 150, 70
    packed, feat, gw = _inputs(n, vb, dc, 53)
    rng = np.random.default_rng(54)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    c, mask = f[:, :dc].contiguous(), f[:, dc + 1].contiguous()
    if design == "p1":
        g3, covj, ss = torch.from_numpy(gw)[:, None].contiguous(), (0,), None
    else:
        g3, covj = _design(gw, dc, "p2")
        ss = torch.from_numpy(np.where(rng.random(f.shape[0]) < 0.5, 0.5, 1.0)
                              .astype(np.float32)).to(dev)
    g3 = g3.to(dev)
    Y = torch.from_numpy(rng.normal(1.0, 2.0, size=(f.shape[0], B))
                         .astype(np.float32)).to(dev) * mask[:, None]
    xty, yy = linear_perm_xty(pk, g3, c, Y, mask, covj, ss)
    dbl = (lambda t: None if t is None else t.double())
    p_xty, p_yy = linear_perm_xty_plain(pk, g3.double(), c.double(), Y.double(),
                                        mask.double(), covj, dbl(ss))
    a_xty, a_yy = linear_perm_xty_plain(pk, g3.double().abs(), c.double().abs(),
                                        Y.double().abs(), mask.double(), covj,
                                        dbl(ss))
    assert float(((xty - p_xty).abs() / a_xty.clamp(min=1e-30)).max()) <= TOL
    assert float(((yy - p_yy).abs() / a_yy.clamp(min=1e-30)).max()) <= TOL
    again = linear_perm_xty(pk, g3, c, Y, mask, covj, ss)
    assert torch.equal(xty, again[0]) and torch.equal(yy, again[1])


@pytest.mark.parametrize("B", [4, 136])
def test_linear_perm_xty_entry_layouts(dev, B):
    """K19's C entry point on code rows one byte off alignment (copied
    byte by byte, every stage on the checked path), against the plain
    version in f64; its refusal of what its 16-byte copies cannot take (a B
    that is not a multiple of 4, Y or c off 16-byte alignment); and the
    wrapper, which copies such a Y and c away, giving the same bytes."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import _PERM_RUN, linear_perm_xty, linear_perm_xty_plain

    n, vb, dc = 2085, 150, 5
    packed, feat, gw = _inputs(n, vb, dc, 56)
    rng = np.random.default_rng(57)
    nb = packed.shape[1]
    pbuf = torch.zeros(vb * nb + 1, dtype=torch.uint8, device=dev)
    pbuf[1:] = torch.from_numpy(packed).reshape(-1).to(dev)
    pk = pbuf[1:].view(vb, nb)
    f = torch.from_numpy(feat).to(dev)
    c = f[:, :dc].contiguous()
    mask = f[:, dc + 1].contiguous()
    g3 = torch.from_numpy(gw)[:, None].contiguous().to(dev)
    Y = torch.from_numpy(rng.normal(1.0, 2.0, size=(f.shape[0], B))
                         .astype(np.float32)).to(dev) * mask[:, None]
    xty = torch.empty((vb, dc + 1, B), dtype=torch.float32, device=dev)
    yy = torch.empty((vb, B), dtype=torch.float32, device=dev)
    cj = torch.tensor([-1], dtype=torch.int32, device=dev)

    def launch(c_ptr, Y_ptr, width):
        _cuda.launch("linear_perm_xty", pk.data_ptr(), nb, vb, g3.data_ptr(), 1, c_ptr,
                     dc, Y_ptr, width, mask.data_ptr(), cj.data_ptr(), None, _PERM_RUN,
                     xty.data_ptr(), yy.data_ptr())

    launch(c.data_ptr(), Y.data_ptr(), B)
    p_xty, p_yy = linear_perm_xty_plain(pk, g3.double(), c.double(), Y.double(),
                                        mask.double(), (0,))
    a_xty, a_yy = linear_perm_xty_plain(pk, g3.double().abs(), c.double().abs(),
                                        Y.double().abs(), mask.double(), (0,))
    assert float(((xty - p_xty).abs() / a_xty.clamp(min=1e-30)).max()) <= TOL
    assert float(((yy - p_yy).abs() / a_yy.clamp(min=1e-30)).max()) <= TOL
    for c_ptr, Y_ptr, width in [(c.data_ptr(), Y.data_ptr(), B - 1),
                                (c.data_ptr() + 4, Y.data_ptr(), B),
                                (c.data_ptr(), Y.data_ptr() + 4, B)]:
        with pytest.raises(RuntimeError, match="linear_perm_xty failed"):
            launch(c_ptr, Y_ptr, width)
    # the wrapper on c and Y one float off alignment: the same bytes
    off = [torch.zeros(t.numel() + 1, dtype=torch.float32, device=dev) for t in (c, Y)]
    for buf, t in zip(off, (c, Y)):
        buf[1:] = t.reshape(-1)
    got = linear_perm_xty(pk, g3, off[0][1:].view_as(c), off[1][1:].view_as(Y), mask,
                          (0,))
    assert torch.equal(got[0], xty) and torch.equal(got[1], yy)


def test_linear_perm_xty_guard(dev):
    """K19 decodes the per-code genotype weights into bf16: plane weights
    that are not exact there raise before any launch."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.glm import linear_perm_xty

    packed, feat, gw = _inputs(203, 70, 1, 55)
    pk = torch.from_numpy(packed).to(dev)
    f = torch.from_numpy(feat).to(dev)
    c, mask = f[:, :1].contiguous(), f[:, 2].contiguous()
    Y = torch.ones((f.shape[0], 3), dtype=torch.float32, device=dev)
    g3 = torch.from_numpy(gw)[:, None].contiguous().to(dev)
    g3[7, 0, 1] = 2.0 + 2.0 ** -9
    before = _cuda.LAUNCHES["linear_perm_xty"]
    with pytest.raises(ValueError, match="exact in bf16"):
        linear_perm_xty(pk, g3, c, Y, mask)
    assert _cuda.LAUNCHES["linear_perm_xty"] == before


def _nonfinite_spw(rng, V, K):
    wts = rng.normal(size=(V, 4, K))
    wts[V // 2, 3, K - 1] = np.nan  # one set all NaN
    if K > 2:
        wts[1, 2, 1] = np.inf       # Inf where hom-ALT, NaN elsewhere
    return wts


@pytest.mark.parametrize("K", [1, 3, 5, 10, 17])
@pytest.mark.parametrize("n,vb,dc", SHAPES + [(2001, 600, 2)])
def test_sample_plane_weighted_kernel(dev, n, vb, dc, K):
    """K21 against its plain version: f64 within 1e-12 of the sum of |terms|
    and bit for bit (both sum in the kernel's order), f32 0/1 selectors
    exact, NaN / Inf where the plain version has them; two runs
    identical."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.counts import sample_plane_weighted, sample_plane_weighted_plain

    packed, _, _ = _inputs(n, vb, dc, 61)
    pk = torch.from_numpy(packed).to(dev)
    rng = np.random.default_rng(K)
    for wts in (rng.normal(size=(vb, 4, K)), _nonfinite_spw(rng, vb, K)):
        w = torch.from_numpy(wts).to(dev)
        before = _cuda.LAUNCHES["sample_plane_weighted"]
        k = sample_plane_weighted(pk, w)
        assert _cuda.LAUNCHES["sample_plane_weighted"] == before + 1
        p = sample_plane_weighted_plain(pk, w)
        a = sample_plane_weighted_plain(pk, torch.nan_to_num(w.abs()))
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        assert torch.equal(torch.isinf(k), torch.isinf(p))
        fin = torch.isfinite(p)
        assert torch.equal(k[~fin & ~torch.isnan(p)], p[~fin & ~torch.isnan(p)])
        err = ((k - p).abs() / a.clamp(min=1e-300))[fin]  # empty if all non-finite
        assert err.numel() == 0 or float(err.max()) <= 1e-12
        assert torch.equal(k[fin], p[fin])
        assert torch.equal(k.view(torch.int64), sample_plane_weighted(pk, w).view(torch.int64))
    sel = torch.from_numpy((rng.random((vb, 4, K)) < 0.5).astype(np.float32)).to(dev)
    k = sample_plane_weighted(pk, sel)
    assert k.dtype == torch.float64
    assert torch.equal(k, sample_plane_weighted_plain(pk, sel))


def test_sample_plane_weighted_kernel_f32_past_2_24(dev, monkeypatch):
    """K21 in f32 with the split cap lowered to 4 variants: weights of 2^22
    on 8 variants and 1 on 3 sum to 2^25 + 3 exactly for every sample (f32
    splits added in f64)."""
    from plink_torch.ops import counts as C

    monkeypatch.setattr(C, "F32_SPLIT_ROWS", 4)
    packed, _, _ = _inputs(2001, 11, 2, 63)
    pk = torch.from_numpy(packed).to(dev)
    wts = np.ones((11, 4, 1), np.float32)
    wts[:8] = 2.0 ** 22
    k = C.sample_plane_weighted(pk, torch.from_numpy(wts).to(dev))
    assert k.dtype == torch.float64 and bool((k == 2.0 ** 25 + 3).all())


@pytest.mark.parametrize("K", [1, 2, 3, 6, 9])
@pytest.mark.parametrize("n,vb,dc", SHAPES + [(2001, 600, 2)])
def test_variant_plane_weighted_kernel(dev, n, vb, dc, K):
    """K22 against its plain version: f64 within 1e-12 of the sum of |terms|,
    f32 0/1 weights exact, NaN / Inf where the plain version has them; two
    runs identical."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.counts import variant_plane_weighted, variant_plane_weighted_plain

    packed, _, _ = _inputs(n, vb, dc, 62)
    pk = torch.from_numpy(packed).to(dev)
    npad = pk.shape[1] * 4
    rng = np.random.default_rng(K)
    w = np.zeros((npad, K))
    w[:n] = rng.normal(size=(n, K))
    bad = w.copy()
    bad[n // 2, K - 1] = np.nan
    bad[n // 3, 0] = np.inf
    for wv in (w, bad):
        wt = torch.from_numpy(wv).to(dev)
        before = _cuda.LAUNCHES["variant_plane_weighted"]
        k = variant_plane_weighted(pk, wt)
        assert _cuda.LAUNCHES["variant_plane_weighted"] == before + 1
        p = variant_plane_weighted_plain(pk, wt)
        a = variant_plane_weighted_plain(pk, torch.nan_to_num(wt.abs()))
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        assert torch.equal(torch.isinf(k), torch.isinf(p))
        fin = torch.isfinite(p)
        err = ((k - p).abs() / a.clamp(min=1e-300))[fin]  # empty if all non-finite
        assert err.numel() == 0 or float(err.max()) <= 1e-12
        assert torch.equal(k.view(torch.int64), variant_plane_weighted(pk, wt).view(torch.int64))
    sel = np.zeros((npad, K), np.float32)
    sel[:n] = rng.random((n, K)) < 0.5
    st = torch.from_numpy(sel).to(dev)
    k = variant_plane_weighted(pk, st)
    assert k.dtype == torch.float32
    assert torch.equal(k, variant_plane_weighted_plain(pk, st))


WMISS_SHAPES = [(150, 5, 64, 100), (1001, 3, 700, 260), (2300, 2, 2048, 1024)]


@pytest.mark.parametrize("n,nb,vb,tile", WMISS_SHAPES)
def test_wmiss_gram_kernel(dev, n, nb, vb, tile):
    """K23 equals its plain version (f64 on the card, exact below 2^53)
    exactly on every lower tile of a layout padded to whole tiles (sides
    not multiples of 64, a ragged last tile), with weights up to 2^32 - 1
    and sample 5 missing at every variant; two launches identical, one
    launch counted a call."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.pairwise import (iter_lower_tiles, pairwise_inputs_from_numpy,
                                          wmiss_gram, wmiss_gram_plain)

    packed, vmask, _ = _pair_inputs(n, nb, vb, 23)
    packed[..., 1] |= 0b1100  # sample 5: code 3 everywhere
    npad = -(-n // tile) * tile
    packed = np.pad(packed, ((0, 0), (0, 0), (0, npad // 4 - packed.shape[2])))
    rng = np.random.default_rng(29)
    w = rng.integers(0, 1 << 32, size=nb * vb, dtype=np.int64)
    w[::3] = (1 << 32) - 1
    pk, vm = pairwise_inputs_from_numpy(packed, vmask, device=dev)
    wt = torch.from_numpy(w).to(dev)
    for r0, c0 in iter_lower_tiles(npad, tile):
        before = _cuda.LAUNCHES["wmiss_gram"]
        k = wmiss_gram(pk, vm, wt, r0, c0, tile, tile)
        assert _cuda.LAUNCHES["wmiss_gram"] == before + 1
        assert k.dtype == torch.int64
        assert torch.equal(k, wmiss_gram_plain(pk, vm, wt, r0, c0, tile, tile)), (r0, c0)
        assert torch.equal(k, wmiss_gram(pk, vm, wt, r0, c0, tile, tile))
        if r0 == c0 == 0:
            assert int(k[5, 5]) == int(w[vmask.reshape(-1) != 0].sum())
    # a tile whose sides differ and are not multiples of 64
    s, t = tile - 8, tile - 36
    k = wmiss_gram(pk, vm, wt, npad - s, 4, s, t)
    assert torch.equal(k, wmiss_gram_plain(pk, vm, wt, npad - s, 4, s, t))


@pytest.mark.parametrize("n,m,nb,groups", [(301, 77, 64, 2), (1000, 300, 256, 2),
                                           (517, 130, 96, 1), (97, 65, 33, 2)])
def test_epi_joint_counts_kernel(dev, n, m, nb, groups):
    """K24 (packing pass and counting kernel) equals its plain version
    exactly on seeded codes with 5% missing calls, a random A1 orientation
    a variant and groups of odd sizes drawn from a sample subset; the last
    row block is ragged and a second block takes rows out of order; two
    launches identical, one counting launch a call and one packing launch
    a run."""
    from plink_torch.ops import _cuda
    from plink_torch.ops.epistasis import (epi_joint_tables_plain, joint_tables,
                                           split_planes)

    rng = np.random.default_rng(n + m)
    V = m + 9
    codes = rng.integers(0, 3, size=(V, n)).astype(np.uint8)
    codes[rng.random((V, n)) < 0.05] = 3
    buf = np.zeros((V, -(-n // 4) * 4), np.uint8)
    buf[:, :n] = codes
    buf = buf.reshape(V, -1, 4)
    packed = buf[..., 0] | buf[..., 1] << 2 | buf[..., 2] << 4 | buf[..., 3] << 6
    vidx = np.sort(rng.choice(V, m, replace=False))
    a1 = rng.random(m) < 0.5
    member = rng.integers(0, 3, size=n)  # 0 case, 1 control, 2 neither
    grp = [np.flatnonzero(member == g) for g in range(groups)]
    pk = torch.from_numpy(packed).to(dev)
    before = dict(_cuda.LAUNCHES)
    planes = split_planes(pk, vidx, a1, grp)
    assert _cuda.LAUNCHES["epi_split_planes"] == before["epi_split_planes"] + 1
    for rows in (np.arange(m - (m % nb or nb), m), rng.permutation(m)[:nb]):
        k = joint_tables(planes, rows)
        assert k.shape == (groups, rows.size, m, 9) and k.dtype == torch.int32
        want = epi_joint_tables_plain(pk, vidx, a1, grp, rows)
        assert torch.equal(k, want), rows[:4]
        assert torch.equal(k, joint_tables(planes, rows))
    assert _cuda.LAUNCHES["epi_joint_counts"] == before["epi_joint_counts"] + 4


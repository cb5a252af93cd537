"""plink_torch's CUDA kernels against their plain PyTorch versions at awkward
small shapes: sample counts that leave a ragged last byte (the unaligned
decode path) or a ragged tile, variant counts that are not a multiple of the
64-variant block (or of K5's 256-row chunk), every covariate width the
kernels are built for, inactive rows and masked-out variants, and matrix
sizes up to the 48-column limit of chol_small.

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


@pytest.mark.parametrize("d", [1, 2, 5, 13, 17, 30, 48])
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


@pytest.mark.parametrize("n,vb,dc", SHAPES)
def test_linear_sums_kernel(dev, n, vb, dc):
    """K6 against its plain version run in f64, each entry normalised by a
    Cauchy-Schwarz bound on its plane sum; two runs give identical bytes."""
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
    k = linear_sums(pk, *(t.float() for t in ins))
    again = linear_sums(pk, *(t.float() for t in ins))
    r = linear_sums_plain(pk, *ins)
    codes = unpack_codes(pk)
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


PAIR_SHAPES = [(150, 5, 64), (1001, 3, 700), (2300, 2, 2048)]


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


@pytest.mark.parametrize("n,nb,vb", PAIR_SHAPES)
def test_grm_gram_kernel(dev, n, nb, vb):
    """K8 against its plain version and an f64 numpy product, each entry
    normalised by sqrt(sum Z_i^2 sum Z_j^2): tile and chunk modes, the pair
    counts exact, two runs identical."""
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
    for r0, c0, s, t in _pair_tiles(pk.shape[2] * 4):
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
            for a in (acc, pacc):
                assert float((np.abs(a.double().cpu().numpy() - ref) / scale).max()) <= TOL
            again = grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t, tile=True,
                             fetch32=fetch32)
            assert torch.equal(acc, again[0])
        g, gnm = grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t)
        pg, pgnm = grm_gram_plain(pk, cf, vm, miss, mv, r0, c0, s, t)
        assert gnm.dtype == torch.float32
        assert torch.equal(gnm, pgnm) and torch.equal(gnm, pnm.float())
        nmv = pnm.double().cpu().numpy()
        err = np.abs(g.double().cpu().numpy() - ref / nmv) * nmv / scale
        assert float(np.nanmax(err)) <= TOL
        assert torch.equal(g, grm_gram(pk, cf, vm, miss, mv, r0, c0, s, t)[0])


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


GRAM_SHAPES = [(150, 70, 45), (1001, 512, 512), (77, 1, 300), (2300, 256, 130),
               (10001, 600, 64)]


@pytest.mark.parametrize("n,ca,cb", GRAM_SHAPES)
def test_ld_gram_pair_kernel(dev, n, ca, cb):
    """K13 equals its plain version exactly for chunks of different lengths
    (tiles cut ragged; the word axis split over blocks or not), with a
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

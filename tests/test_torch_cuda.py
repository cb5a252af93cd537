"""plink_torch's CUDA kernels against their plain PyTorch versions at awkward
small shapes: sample counts that leave a ragged last byte (the unaligned
decode path) or a ragged tile, variant counts that are not a multiple of the
64-variant block, every covariate width the kernels are built for, inactive
rows, and matrix sizes up to the 48-column limit of chol_small.

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

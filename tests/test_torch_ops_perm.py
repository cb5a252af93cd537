"""plink_torch's permutation scans against plink_tpu's on the CPU.

The same seeded numpy inputs (3 blocks x 64 variants x 256 samples, dc = 3,
B = 16 permuted phenotype columns) go through plink_tpu.ops.glm's
linear_perm_scan / linear_perm_multi_scan / firth_perm_scan /
firth_perm_multi_scan and the port's functions of the same names, whose
kernel wrappers (K19 / K20, K2 / K15, K3 / K16, K4) take their plain
versions for CPU tensors.  Designs: the additive model (P = 1), genotypic
(P = 2, joint test q = 2) and `interaction` (the additive column and its
products with the two covariates, q = 0), each with and without a
per-sample genotype multiplier (sscale, --xchr-model 1).

Rules: linear t / F within rtol 1e-4 and atol 1e-5, NaN at the same
places, except that the joint F takes atol 1e-4: F = ((rss0 - rss) / q) /
sigma^2 differences two f32 residual sums of ~(n - d) sigma^2 each, so
each package's F carries an absolute rounding of up to ~2 eps (n - d) / q
~ 6e-5 at n = 256 whatever its size (the two differ by up to 1.3e-5 here
on F values near 0).  Firth statistics within 1e-3 of max(|stat|, 1) (the
GLM rule for a Z statistic: a |z| near 0 comes from a beta near 0 whose f32
noise is large relative to itself), the -1 (failed fit) markers at the
same places.
"""

import numpy as np
import pytest
import torch

NBLK, VB, N, DC, B = 3, 64, 256, 3, 16
# plane weights (het, hom-ALT, valid) for A1 = ALT and A1 = REF
_W = {"ADD": ((1, 2, 0), (-1, -2, 2)), "DOMDEV": ((1, 0, 0), (1, 0, 0))}
DESIGNS = {  # name: (model columns, covj, joint-test q)
    "additive": (["ADD"], (0,), 0),
    "genotypic": (["ADD", "DOMDEV"], (0, 0), 2),
    "interaction": (["ADD", "ADD", "ADD"], (0, 1, 2), 0),
}


def _inputs(geno_factory, design, scaled, cc):
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(41)
    codes = geno_factory(NBLK * VB, N, missing_rate=0.05, maf_lo=0.2,
                         maf_hi=0.5)
    codes[5, :] = 0  # monomorphic: a singular design
    blocks = _pack_np(codes, N).reshape(NBLK, VB, N // 4)
    names, covj, q = DESIGNS[design]
    a1_alt = rng.random(NBLK * VB) < 0.5
    gws = np.stack([np.where(a1_alt[:, None], np.array(_W[nm][0], np.float32),
                             np.array(_W[nm][1], np.float32)) for nm in names],
                   axis=1).reshape(NBLK, VB, len(names), 3).astype(np.float32)
    c = np.ones((N, DC), np.float32)
    c[:, 1:] = rng.normal(size=(N, DC - 1))
    mask = np.ones(N, np.float32)
    mask[-6:] = 0.0  # padding samples
    c[-6:] = 0.0
    if cc:
        y = (rng.random(N) < 0.4).astype(np.float32)
    else:
        y = (rng.normal(size=N) + 0.3 * c[:, 1]).astype(np.float32)
    y[-6:] = 0.0
    Y = np.stack([np.concatenate([rng.permutation(y[:-6]), np.zeros(6)])
                  for _ in range(B)], axis=1).astype(np.float32)
    sscale = None
    if scaled:
        sscale = np.where(rng.random(N) < 0.5, 0.5, 1.0).astype(np.float32)
    return blocks, gws, c, Y, mask, covj, q, sscale


def _jax(fn_name, blocks, gws, c, Y, mask, covj, q, sscale):
    import jax.numpy as jnp

    from plink_tpu.ops import glm as J

    fn = getattr(J, fn_name)
    ss = None if sscale is None else jnp.asarray(sscale)
    args = (jnp.asarray(blocks), jnp.asarray(gws), jnp.asarray(c), jnp.asarray(Y),
            jnp.asarray(mask), DC)
    if fn_name.endswith("multi_scan"):
        return np.asarray(fn(*args, covj, q, ss))
    return np.asarray(fn(*args, covj, ss))


def _port(fn_name, blocks, gws, c, Y, mask, covj, q, sscale):
    from plink_torch.ops import glm as G

    t = torch.from_numpy
    fn = getattr(G, fn_name)
    ss = None if sscale is None else t(sscale)
    args = (t(blocks), t(gws), t(c), t(Y), t(mask), DC)
    if fn_name.endswith("multi_scan"):
        return fn(*args, covj, q, ss).numpy()
    return fn(*args, covj, ss).numpy()


def _fn(kind, design):
    multi = design != "additive"
    return f"{kind}_perm_{'multi_' if multi else ''}scan"


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "sscale"])
@pytest.mark.parametrize("design", list(DESIGNS))
def test_linear_perm_scan_matches_jax(geno_factory, design, scaled):
    ins = _inputs(geno_factory, design, scaled, cc=False)
    fn = _fn("linear", design)
    ref = _jax(fn, *ins)
    got = _port(fn, *ins)
    assert got.shape == ref.shape == (NBLK, VB, B)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref[0, 5]).all()  # the monomorphic variant
    fin = np.isfinite(ref)
    assert fin.mean() > 0.95
    atol = 1e-4 if DESIGNS[design][2] else 1e-5
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=atol)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "sscale"])
@pytest.mark.parametrize("design", list(DESIGNS))
def test_firth_perm_scan_matches_jax(geno_factory, design, scaled):
    ins = _inputs(geno_factory, design, scaled, cc=True)
    fn = _fn("firth", design)
    ref = _jax(fn, *ins)
    got = _port(fn, *ins)
    assert got.shape == ref.shape == (B, NBLK, VB)
    failed = ref == -1.0
    assert np.array_equal(got == -1.0, failed)
    assert failed[:, 0, 5].all()  # the monomorphic variant
    assert failed.mean() < 0.05
    g, r = got[~failed], ref[~failed]
    assert (np.abs(g - r) <= 1e-3 * np.maximum(np.abs(r), 1.0)).all()


def test_linear_perm_kernels_compose():
    """perm_inverses + linear_perm_xty + linear_perm_stat on precomputed
    inverses give the scan's statistics, and the plain K19 is the f64 sums
    in f32: the design's X^T y of a permuted column equals numpy's."""
    from plink_torch.ops import glm as G
    from plink_torch.ops.planes import _unpack_np
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(5)
    codes = (rng.random((16, 64)) < 0.3).astype(np.uint8) + \
        (rng.random((16, 64)) < 0.3).astype(np.uint8)
    codes[rng.random((16, 64)) < 0.05] = 3
    pk = torch.from_numpy(_pack_np(codes, 64))
    gw = torch.tensor([[[1.0, 2.0, 0.0]]]).expand(16, 1, 3).contiguous()
    c = torch.from_numpy(np.column_stack([np.ones(64), rng.normal(size=64)])
                         .astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(64, 5)).astype(np.float32))
    mask = torch.ones(64)
    xty, yy = G.linear_perm_xty(pk, gw, c, Y, mask)
    cd = _unpack_np(pk.numpy())[:, :64]
    valid = (cd != 3).astype(np.float64)
    g = np.where(cd == 3, 0.0, cd).astype(np.float64)
    c64, Y64 = c.double().numpy(), Y.double().numpy()
    want = np.stack([valid @ (c64[:, :1] * Y64), valid @ (c64[:, 1:] * Y64),
                     g @ Y64], axis=1)
    np.testing.assert_allclose(xty.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yy.numpy(), valid @ (Y64 * Y64), rtol=1e-5)
    inv = G.perm_inverses(pk[None], gw[None], c, mask)
    scan = G.linear_perm_scan(pk[None], gw[None], c, Y, mask, 2, (0,), None, inv)
    direct = G.linear_perm_stat(inv[0][0], xty, yy, inv[0][2], 2)
    assert torch.equal(scan[0], direct)

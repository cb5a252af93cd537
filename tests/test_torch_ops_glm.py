"""plink_torch's device GLM functions against plink_tpu's on the CPU.

The same seeded numpy inputs go through the JAX reference
(plink_tpu.ops.counts / plink_tpu.ops.glm, run as their own tests run them)
and through the port's plain PyTorch versions (what the kernel wrappers run
for CPU tensors), via `scan_inputs_from_numpy`.
"""

import numpy as np
import pytest
import torch

N, VB, NBLK, DC = 301, 64, 2, 4  # samples (npad 304), variant block, blocks, c cols


def _panel(geno_factory):
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(17)
    V = VB * NBLK
    codes = geno_factory(V, N, missing_rate=0.05, maf_lo=0.05, maf_hi=0.5)
    codes[0, :] = 0  # monomorphic
    codes[1, : N // 2] = 0  # ALT carried only by the second half...
    codes[1, N // 2:] = 1
    npad = -(-N // 4) * 4
    blocks = _pack_np(codes, npad).reshape(NBLK, VB, npad // 4)
    cov = rng.normal(size=(N, DC - 1))
    y = (rng.random(N) < 1 / (1 + np.exp(-(0.2 + 0.6 * cov[:, 0])))).astype(np.float64)
    y[: N // 2] = 0  # ...so variant 1 separates cases from controls
    y[N // 2: N // 2 + 20] = 1
    c = np.zeros((npad, DC), np.float32)
    c[:N, 0] = 1.0
    c[:N, 1:] = cov
    ypad = np.zeros(npad, np.float32)
    ypad[:N] = y
    mask = np.zeros(npad, np.float32)
    mask[:N] = 1.0
    cy = np.concatenate([c, ypad[:, None]], axis=1)
    a1_alt = rng.random(V) < 0.5
    w = np.where(a1_alt[:, None], np.array([1, 2, 0], np.float32),
                 np.array([-1, -2, 2], np.float32)).reshape(NBLK, VB, 1, 3)
    gws = w.astype(np.float32)
    gwms = np.concatenate([gws, gws], axis=2)
    return codes, blocks, gws, gwms, c, cy, ypad, mask


def _jax_scan(blocks, gws, gwms, c, cy, y, mask, firth):
    import jax.numpy as jnp

    from plink_tpu.ops.glm import glm_logistic_scan

    outs = glm_logistic_scan(
        jnp.asarray(blocks), jnp.asarray(gws), jnp.asarray(gwms), jnp.asarray(c),
        jnp.asarray(cy), jnp.asarray(y), jnp.asarray(mask), DC, 1, (0,), firth)
    return [np.asarray(x) for x in outs]


def _port_scan(blocks, gws, gwms, c, cy, y, mask, firth):
    from plink_torch.ops.glm import glm_logistic_scan, scan_inputs_from_numpy

    ins = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                 torch.device("cpu"))
    return [x.numpy() for x in glm_logistic_scan(*ins, firth=firth)]


def test_geno_counts_plain_matches_jax(geno_factory):
    """K1's plain version equals _geno_counts_multimask exactly."""
    import jax.numpy as jnp

    from plink_torch.ops.counts import geno_counts
    from plink_tpu.ops.counts import _geno_counts_multimask
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(3)
    codes = geno_factory(77, N, missing_rate=0.1)
    npad = -(-N // 4) * 4
    packed = _pack_np(codes, npad)
    masks = np.zeros((npad, 3), np.float32)
    masks[:N, 0] = 1
    masks[:N, 1] = rng.random(N) < 0.5
    masks[:N, 2] = (rng.random(N) < 0.3) & (masks[:N, 1] == 0)
    ref = np.asarray(_geno_counts_multimask(jnp.asarray(packed),
                                            jnp.asarray(masks), npad))
    got = geno_counts(torch.from_numpy(packed), torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_moments_plain_matches_jax(geno_factory):
    """The plain moments equal B1a's to rtol 1e-5: f32 sums of the same
    products, in another summation order."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import glm_moments
    from plink_tpu.ops.glm import _moments_from_cols, _plane_cols

    _, blocks, gws, gwms, c, cy, y, mask = _panel(geno_factory)
    gcols, valid = _plane_cols(jnp.asarray(blocks[0]), jnp.asarray(gwms[0]),
                               jnp.asarray(cy), jnp.asarray(mask), 2, (0, 0))
    ref = np.asarray(_moments_from_cols(gcols, valid, jnp.asarray(cy), DC + 1))
    feat = torch.from_numpy(np.concatenate([cy, mask[:, None]], axis=1))
    got = glm_moments(torch.from_numpy(blocks[0]), torch.from_numpy(gwms[0]),
                      feat).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def _host_refit(beta, se, conv, fail, unf, mstats, obs, dc):
    """Rows the command refits per variant in f64 on the host (the
    `_extreme` rule of commands/glm.py): their f32 device fit is never
    reported, and its flags sit at f32 noise thresholds."""
    with np.errstate(invalid="ignore"):
        bm = np.abs(beta[..., dc:]).max(axis=-1)
        sm = se[..., dc:].max(axis=-1)
    mac = np.minimum(mstats[..., 0], 2.0 * obs - mstats[..., 0])
    return (bm > 5) | (sm > 5) | (mac < 30) | fail | unf | ~conv


@pytest.mark.parametrize("firth", [False, True], ids=["logistic", "firth"])
def test_glm_logistic_scan_matches_jax(geno_factory, firth):
    """The port's glm_logistic_scan against JAX's.  Moments, obs and the
    device collinearity screen agree on every row; conv/fail/unf/invalid and
    beta/SE (rtol 1e-4 / atol 1e-5: f32 IRLS on both sides, LAPACK against a
    plain Cholesky) on every row that either side's fit lets the host report
    without an f64 refit."""
    args = _panel(geno_factory)[1:]
    ref = _jax_scan(*args, firth)
    got = _port_scan(*args, firth)
    (momy_r, mst_r, scr_r, b_r, se_r, conv_r, fail_r, unf_r, obs_r, inv_r,
     _h_r) = ref
    (momy_g, mst_g, scr_g, b_g, se_g, conv_g, fail_g, unf_g, obs_g, inv_g,
     _h_g) = got
    np.testing.assert_allclose(momy_g, momy_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mst_g, mst_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(obs_g, obs_r)
    np.testing.assert_array_equal(scr_g, scr_r)
    refit = (_host_refit(b_r, se_r, conv_r, fail_r, unf_r, mst_r, obs_r, DC)
             | _host_refit(b_g, se_g, conv_g, fail_g, unf_g, mst_g, obs_g, DC))
    assert refit[0, 0] and refit[0, 1]  # the monomorphic and separated rows
    assert refit.sum() <= 0.1 * refit.size
    ok = ~refit
    for name, a, b in (("conv", conv_g, conv_r), ("fail", fail_g, fail_r),
                       ("unf", unf_g, unf_r), ("invalid", inv_g, inv_r)):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    np.testing.assert_allclose(b_g[ok], b_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(se_g[ok], se_r[ok], rtol=1e-4, atol=1e-5)


def test_firth_irls_block_matches_jax(geno_factory):
    """firth_irls_block on the block holding the separated variant."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import firth_irls_block, scan_inputs_from_numpy
    from plink_tpu.ops.glm import firth_irls_block as jax_firth

    _, blocks, gws, gwms, c, cy, y, mask = _panel(geno_factory)
    ref = [np.asarray(x) for x in jax_firth(
        jnp.asarray(blocks[0]), jnp.asarray(gws[0]), jnp.asarray(c),
        jnp.asarray(y), jnp.asarray(mask), DC)]
    pk, gw, _, feat = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                             torch.device("cpu"))
    got = [x.numpy() for x in firth_irls_block(pk[0], gw[0], feat)]
    b_r, se_r, _, conv_r, fail_r, unf_r, obs_r, _ = ref
    b_g, se_g, _, conv_g, fail_g, unf_g, obs_g, _ = got
    np.testing.assert_array_equal(obs_g, obs_r)
    assert conv_r[1] and conv_g[1], "the separated variant converges under Firth"
    # rows at the 25-iteration limit on either side are refit on the host
    ok = conv_r & ~fail_r & conv_g & ~fail_g
    assert ok.sum() >= 0.9 * ok.size
    np.testing.assert_array_equal(fail_g[ok | fail_r], fail_r[ok | fail_r])
    np.testing.assert_allclose(b_g[ok], b_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(se_g[ok], se_r[ok], rtol=1e-4, atol=1e-5)


def test_chol_small_plain_matches_numpy():
    """K4's plain version against numpy.linalg in f64 on well-conditioned SPD
    matrices (cond < 100, so f32 keeps ~1e-5 relative); a matrix that is not
    positive definite comes back NaN."""
    from plink_torch.ops.glm import chol_small

    rng = np.random.default_rng(5)
    vb, d = 40, 13
    a = rng.normal(size=(vb, d, d))
    h = a @ a.transpose(0, 2, 1) / d + np.eye(d)
    h[3] = -np.eye(d)
    rhs = rng.normal(size=(vb, d))
    x, inv, ld = chol_small(torch.from_numpy(h.astype(np.float32)),
                            torch.from_numpy(rhs.astype(np.float32)),
                            inverse=True, logdet=True)
    good = np.arange(vb) != 3
    np.testing.assert_allclose(x.numpy()[good],
                               np.linalg.solve(h, rhs[:, :, None])[good, :, 0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(inv.numpy()[good], np.linalg.inv(h)[good],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ld.numpy()[good],
                               np.linalg.slogdet(h)[1][good], rtol=1e-5,
                               atol=1e-5)
    assert np.isnan(x.numpy()[3]).all() and np.isnan(inv.numpy()[3]).all()
    assert np.isnan(ld.numpy()[3])


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors: on any other
    device it launches its kernel or raises, never falls back."""
    from plink_torch.ops.counts import geno_counts
    from plink_torch.ops.glm import chol_small, glm_moments

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        geno_counts(torch.empty((4, 2), dtype=torch.uint8, device=meta),
                    torch.empty((8, 1), device=meta))
    with pytest.raises(ValueError):
        glm_moments(torch.empty((4, 2), dtype=torch.uint8, device=meta),
                    torch.empty((4, 2, 3), device=meta),
                    torch.empty((8, 5), device=meta))
    with pytest.raises(ValueError):
        chol_small(torch.empty((4, 3, 3), device=meta))

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
    from plink_torch.ops.glm import (chol_small, glm_irls_pass, glm_moments,
                                     xm1_stats)

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
    with pytest.raises(ValueError):
        xm1_stats(torch.empty((4, 2), dtype=torch.uint8, device=meta),
                  torch.empty((8, 2), device=meta), torch.empty(8, device=meta))
    # the residualized design takes its mean and offset together, dc = 0
    cpu = dict(dtype=torch.float32)
    with pytest.raises(ValueError):
        glm_irls_pass(torch.zeros((4, 2), dtype=torch.uint8),
                      torch.zeros((4, 3), **cpu), torch.zeros((8, 2), **cpu),
                      torch.zeros((4, 1), **cpu), torch.ones(4, dtype=torch.bool),
                      gmean=torch.zeros(4, **cpu))


# ---------------------------------------------------------------------------
# the B7 entry points (residualized IRLS, --xchr-model 1) and sscale
# ---------------------------------------------------------------------------


def _resid_inputs(geno_factory):
    """_panel's inputs plus a seeded null-model offset and an --xchr-model 1
    multiplier (0.5 for a random half of the samples, 1 on the padding)."""
    codes, blocks, gws, gwms, c, cy, y, mask = _panel(geno_factory)
    rng = np.random.default_rng(23)
    offs = np.zeros_like(y)
    offs[:N] = -0.2 + 0.4 * c[:N, 1] + rng.normal(scale=0.1, size=N)
    s = np.ones_like(y)
    s[:N] = np.where(rng.random(N) < 0.5, 0.5, 1.0)
    return codes, blocks, gws, gwms, c, cy, y, mask, offs.astype(np.float32), \
        s.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("firth", [False, True], ids=["logistic", "firth"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "sscale"])
def test_glm_resid_scan_matches_jax(geno_factory, firth, scaled):
    """glm_resid_scan (cc-/firth-residualize) against JAX's.  The moments,
    mstats and obs as in the plain scan (rtol 1e-5, exact); beta / SE of the
    one residualized column to rtol 1e-4 / atol 1e-5 and conv / fail / unf /
    invalid equal on every row neither side sends to the host refit.  The
    port takes the per-variant mean and the IRLS start from K2's sums in
    closed form where JAX sums the centred column over the samples: the
    start differs in the last bits, the converged fits by f32 noise."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import glm_resid_scan, scan_inputs_from_numpy
    from plink_tpu.ops.glm import glm_resid_scan as jax_scan

    _, blocks, gws, gwms, c, cy, y, mask, offs, s = _resid_inputs(geno_factory)
    ss = s if scaled else None
    ref = [np.asarray(x) for x in jax_scan(
        jnp.asarray(blocks), jnp.asarray(gws), jnp.asarray(gwms),
        jnp.asarray(cy), jnp.asarray(offs), jnp.asarray(y), jnp.asarray(mask),
        DC, 1, firth, None if ss is None else jnp.asarray(ss))]
    ins = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                 torch.device("cpu"))
    got = [x.numpy() for x in glm_resid_scan(
        *ins, _t(offs), firth=firth, sscale=None if ss is None else _t(ss))]
    (momy_r, mst_r, scr_r, b_r, se_r, conv_r, fail_r, unf_r, obs_r, inv_r,
     _h_r) = ref
    (momy_g, mst_g, scr_g, b_g, se_g, conv_g, fail_g, unf_g, obs_g, inv_g,
     _h_g) = got
    assert b_g.shape == b_r.shape == (NBLK, VB, 1)
    np.testing.assert_allclose(momy_g, momy_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mst_g, mst_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(obs_g, obs_r)
    np.testing.assert_array_equal(scr_g, scr_r)
    refit = (_host_refit(b_r, se_r, conv_r, fail_r, unf_r, mst_r, obs_r, 0)
             | _host_refit(b_g, se_g, conv_g, fail_g, unf_g, mst_g, obs_g, 0))
    assert refit.sum() <= 0.15 * refit.size
    ok = ~refit
    for name, a, b in (("conv", conv_g, conv_r), ("fail", fail_g, fail_r),
                       ("unf", unf_g, unf_r), ("invalid", inv_g, inv_r)):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    np.testing.assert_allclose(b_g[ok], b_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(se_g[ok], se_r[ok], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "sscale"])
def test_resid_irls_block_matches_jax(geno_factory, scaled):
    """resid_irls_block (the hybrid's residualized Firth fallback) against
    JAX's with firth=True on the block holding the separated variant, d = 1
    (K4 on 1 x 1 matrices): obs exact, beta / SE to rtol 1e-4 / atol 1e-5
    on the rows both sides converge."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import resid_irls_block, scan_inputs_from_numpy
    from plink_tpu.ops.glm import resid_irls_block as jax_block

    _, blocks, gws, gwms, c, cy, y, mask, offs, s = _resid_inputs(geno_factory)
    ss = s if scaled else None
    ref = [np.asarray(x) for x in jax_block(
        jnp.asarray(blocks[0]), jnp.asarray(gws[0]), jnp.asarray(offs),
        jnp.asarray(y), jnp.asarray(mask), 1, True,
        None if ss is None else jnp.asarray(ss))]
    pk, gw, _, feat = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                             torch.device("cpu"))
    got = [x.numpy() for x in resid_irls_block(
        pk[0], gw[0], feat, _t(offs), sscale=None if ss is None else _t(ss))]
    b_r, se_r, _, conv_r, fail_r, unf_r, obs_r, h_r = ref
    b_g, se_g, _, conv_g, fail_g, unf_g, obs_g, h_g = got
    assert b_g.shape == (VB, 1) and h_g.shape == (VB, 1, 1)
    np.testing.assert_array_equal(obs_g, obs_r)
    assert conv_r[1] and conv_g[1], "the separated variant converges under Firth"
    ok = conv_r & ~fail_r & conv_g & ~fail_g
    assert ok.sum() >= 0.9 * ok.size
    np.testing.assert_array_equal(fail_g[ok | fail_r], fail_r[ok | fail_r])
    np.testing.assert_allclose(b_g[ok], b_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(se_g[ok], se_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_g[ok], h_r[ok], rtol=2e-4, atol=1e-6)


def test_xm1_stats_scan_matches_jax_exactly(geno_factory):
    """xm1_stats_scan (K14's plain version) equals JAX's on every output:
    sums of w in {0, 0.5, 1} and plane counts are exact in f32."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import xm1_stats_scan
    from plink_tpu.ops.glm import xm1_stats_scan as jax_xm1

    _, blocks, _, _, _, _, y, mask, _, s = _resid_inputs(geno_factory)
    mask = mask.copy()
    mask[::7] = 0.0  # samples outside the set
    w = np.stack([s, s * y], axis=1).astype(np.float32)
    w[N:] = 0.0
    ref = [np.asarray(x) for x in jax_xm1(jnp.asarray(blocks), jnp.asarray(w),
                                          jnp.asarray(mask))]
    got = [x.numpy() for x in xm1_stats_scan(_t(blocks), _t(w), _t(mask))]
    assert len(got) == 4
    for a, b in zip(got, ref):
        assert a.shape == (NBLK, VB)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("firth", [False, True], ids=["logistic", "firth"])
def test_glm_logistic_scan_sscale_matches_jax(geno_factory, firth):
    """glm_logistic_scan with the --xchr-model 1 multiplier against JAX's
    (K2 / K3 scaled modes' plain versions), by the rules of the unscaled
    test."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import glm_logistic_scan, scan_inputs_from_numpy
    from plink_tpu.ops.glm import glm_logistic_scan as jax_scan

    _, blocks, gws, gwms, c, cy, y, mask, _, s = _resid_inputs(geno_factory)
    ref = [np.asarray(x) for x in jax_scan(
        jnp.asarray(blocks), jnp.asarray(gws), jnp.asarray(gwms),
        jnp.asarray(c), jnp.asarray(cy), jnp.asarray(y), jnp.asarray(mask),
        DC, 1, (0,), firth, jnp.asarray(s))]
    ins = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                 torch.device("cpu"))
    got = [x.numpy() for x in glm_logistic_scan(*ins, firth=firth,
                                                sscale=_t(s))]
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
    assert refit.sum() <= 0.15 * refit.size
    ok = ~refit
    for name, a, b in (("conv", conv_g, conv_r), ("fail", fail_g, fail_r),
                       ("unf", unf_g, unf_r), ("invalid", inv_g, inv_r)):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    np.testing.assert_allclose(b_g[ok], b_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(se_g[ok], se_r[ok], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# several genotype columns (genotypic / hethom) and G x covariate columns
# (interaction): K2 / K3 with P = 2 and K15 / K16, through their plain
# versions
# ---------------------------------------------------------------------------

_W = {"ADD": ((1, 2, 0), (-1, -2, 2)), "DOMDEV": ((1, 0, 0), (1, 0, 0))}
# design: (predictor names, covj); interaction = ADD and ADD x each covariate
DESIGNS = {"genotypic": (("ADD", "DOMDEV"), (0, 0)),
           "interaction": (("ADD",) * DC, tuple(range(DC)))}


def _joint_inputs(geno_factory, design):
    """_panel's inputs with the design's plane weights: gws [nb, vb, P, 3]
    (flip-resolved per variant as commands/glm.py builds them) and gwms
    with ADD appended; covj as plink_tpu takes it."""
    codes, blocks, _, _, c, cy, y, mask = _panel(geno_factory)
    names, covj = DESIGNS[design]
    a1_alt = np.random.default_rng(29).random(VB * NBLK) < 0.5
    w = np.stack([np.where(a1_alt[:, None], np.array(_W[nm][0], np.float32),
                           np.array(_W[nm][1], np.float32)) for nm in names],
                 axis=1).reshape(NBLK, VB, len(names), 3)
    add = np.where(a1_alt[:, None], np.array(_W["ADD"][0], np.float32),
                   np.array(_W["ADD"][1], np.float32)).reshape(NBLK, VB, 1, 3)
    return blocks, w, np.concatenate([w, add], axis=2), c, cy, y, mask, covj


def _conds(blocks, gws, c, mask, covj, centred=False):
    """[nb, vb] condition number of each variant's design [c | G_1..G_P]
    (`centred`: the residualized design, the G columns less their mean)
    over its valid samples, column-scaled to unit diagonal in X^T X (inf
    with a constant column)."""
    from plink_torch.ops.planes import _unpack_np

    out = np.zeros(blocks.shape[:2])
    for bi in range(blocks.shape[0]):
        codes = _unpack_np(blocks[bi])[:, : c.shape[0]]
        for v in range(blocks.shape[1]):
            cd = codes[v]
            valid = (cd != 3) & (mask > 0)
            cols = [] if centred else \
                [c[:, j].astype(np.float64) for j in range(c.shape[1])]
            for p, w in enumerate(gws[bi, v]):
                g = w[0] * (cd == 1) + w[1] * (cd == 2) + w[2] * (cd != 3)
                cols.append(g * (c[:, covj[p]] if covj[p] else 1.0))
            X = np.column_stack(cols)[valid]
            if centred:
                X = X - X.mean(axis=0)
            s = X.T @ X
            if (np.diag(s) <= 1e-12).any():  # a constant column
                out[bi, v] = np.inf
                continue
            dg = np.sqrt(np.diag(s))
            out[bi, v] = np.linalg.cond(s / np.outer(dg, dg))
    return out


def _rtol(cond):
    """Per-row relative tolerance of beta / SE between two f32 fits: 1e-4,
    or 1e-6 x cond where that is larger.  An f32 IRLS carries relative
    noise of ~cond x 1e-7 per iteration, so two fits of a row whose design
    is ill-conditioned (a genotypic row with 1-3 hom-A1 carriers: DOMDEV ~
    ADD; cond 300-1,200 on these panels) agree only to a tolerance that
    grows with it."""
    return np.maximum(1e-4, 1e-6 * cond)


def _close(got, ref, rtol, floor=0.0):
    """[rows] bool: every entry of each row within rtol x max(|ref|, floor)
    + 1e-5."""
    scale = np.maximum(np.abs(ref), floor)
    with np.errstate(invalid="ignore"):  # inf x 0 on a constant column's row
        return (np.abs(got - ref) <= rtol[..., None] * scale + 1e-5).all(-1)


def _f64_rows(blocks, gws, c, y, mask, covj, firth, offs=None):
    """Per (block, variant): numpy f64 fits of the design [c | G_1..G_P]
    (or, with `offs`, of the residualized [G'_1..G'_P] with that offset) over
    the variant's valid samples: [(beta, se)] at every stop plink2's rules
    can take when an f32 fit reads their thresholds tenfold either way
    (plink_torch.testing.f64_logit with slack 10)."""
    from plink_torch.ops.planes import _unpack_np
    from plink_torch.testing import f64_logit

    n = c.shape[0]

    def fit(bi, v):
        cd = _unpack_np(blocks[bi, v][None])[0][:n]
        ok = (cd != 3) & (mask[:n] > 0)
        G = np.column_stack([
            (w[0] * (cd == 1) + w[1] * (cd == 2) + w[2] * (cd != 3))
            * (c[:, covj[p]] if covj[p] else 1.0)
            for p, w in enumerate(gws[bi, v])])[ok].astype(np.float64)
        if offs is not None:
            fits = f64_logit(G - G.mean(axis=0), y[:n][ok], offs[:n][ok], firth,
                             slack=10.0)
        else:
            X = np.column_stack([c[ok].astype(np.float64), G])
            fits = f64_logit(X, y[:n][ok], 0.0, firth, slack=10.0)
        return [f[:2] for f in fits]

    return fit


def _scan_close(ref, got, dc, n_refit, cond, f64, n_off):
    """The scan outputs `got` against JAX's `ref`: moments, mstats, obs and
    the screen on every row; flags and beta / SE (_rtol of the row's cond)
    on the rows neither side refits on the host.  The n_off rows where the
    two fits differ beyond that are held to numpy's f64 fit `f64` at any of
    the stops it lists (plink_tpu rounds the IRLS log-likelihood to f32 and
    may stop one iteration early: ROADMAP C), SE as above and beta relative
    to max(|beta|, SE) as the CLI tests hold a BETA.
    n_refit and n_off are what the seeded panel shows."""
    (momy_r, mst_r, scr_r, b_r, se_r, conv_r, fail_r, unf_r, obs_r, inv_r,
     _h_r) = ref
    (momy_g, mst_g, scr_g, b_g, se_g, conv_g, fail_g, unf_g, obs_g, inv_g,
     _h_g) = got
    assert momy_g.shape == momy_r.shape and b_g.shape == b_r.shape
    np.testing.assert_allclose(momy_g, momy_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mst_g, mst_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(obs_g, obs_r)
    np.testing.assert_array_equal(scr_g, scr_r)
    refit = (_host_refit(b_r, se_r, conv_r, fail_r, unf_r, mst_r, obs_r, dc)
             | _host_refit(b_g, se_g, conv_g, fail_g, unf_g, mst_g, obs_g, dc))
    assert refit.sum() == n_refit, refit.sum()
    ok = ~refit
    for name, a, b in (("conv", conv_g, conv_r), ("fail", fail_g, fail_r),
                       ("unf", unf_g, unf_r), ("invalid", inv_g, inv_r)):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    rtol = _rtol(cond)
    off = ok & ~(_close(b_g, b_r, rtol) & _close(se_g, se_r, rtol))
    assert off.sum() == n_off, off.sum()
    for bi, v in zip(*np.nonzero(off)):
        fits = f64(bi, v)
        assert any(_close(b_g[bi, v], b64, rtol[bi, v], se64)
                   and _close(se_g[bi, v], se64, rtol[bi, v])
                   for b64, se64 in fits), (bi, v, b_g[bi, v], se_g[bi, v], fits)


@pytest.mark.parametrize("firth", [False, True], ids=["logistic", "firth"])
@pytest.mark.parametrize("design", list(DESIGNS))
def test_glm_logistic_scan_joint_matches_jax(geno_factory, design, firth):
    """glm_logistic_scan with two genotype columns (np_ = 2) and with the
    G x covariate columns of `interaction` (covj) against JAX's, by the
    rules of the one-column test: moments rtol 1e-5, obs and the screen
    exact, flags equal and beta / SE rtol 1e-4 on the rows neither side
    refits on the host."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import glm_logistic_scan, scan_inputs_from_numpy
    from plink_tpu.ops.glm import glm_logistic_scan as jax_scan

    blocks, gws, gwms, c, cy, y, mask, covj = _joint_inputs(geno_factory, design)
    ref = [np.asarray(x) for x in jax_scan(
        jnp.asarray(blocks), jnp.asarray(gws), jnp.asarray(gwms),
        jnp.asarray(c), jnp.asarray(cy), jnp.asarray(y), jnp.asarray(mask),
        DC, gws.shape[2], covj, firth)]
    ins = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                 torch.device("cpu"))
    got = [x.numpy() for x in glm_logistic_scan(*ins, firth=firth, covj=covj)]
    assert got[3].shape == (NBLK, VB, DC + gws.shape[2])
    n_refit, n_off = {("genotypic", False): (14, 1), ("genotypic", True): (7, 0),
                      ("interaction", False): (4, 0),
                      ("interaction", True): (4, 0)}[design, firth]
    _scan_close(ref, got, DC, n_refit,
                _conds(blocks, gws, c[:N], mask[:N], covj),
                _f64_rows(blocks, gws, c[:N], y, mask, covj, firth), n_off)


@pytest.mark.parametrize("design", list(DESIGNS))
def test_firth_irls_block_joint_matches_jax(geno_factory, design):
    """firth_irls_block with np_ / covj (the hybrid's Firth fallback of the
    joint and interaction models) against JAX's on the block holding the
    separated variant: obs exact, beta / SE rtol 1e-4 on the rows both
    sides converge."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import firth_irls_block, scan_inputs_from_numpy
    from plink_tpu.ops.glm import firth_irls_block as jax_firth

    blocks, gws, gwms, c, cy, y, mask, covj = _joint_inputs(geno_factory, design)
    ref = [np.asarray(x) for x in jax_firth(
        jnp.asarray(blocks[0]), jnp.asarray(gws[0]), jnp.asarray(c),
        jnp.asarray(y), jnp.asarray(mask), DC, gws.shape[2], covj)]
    pk, gw, _, feat = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                             torch.device("cpu"))
    got = [x.numpy() for x in firth_irls_block(pk[0], gw[0], feat, covj=covj)]
    b_r, se_r, _, conv_r, fail_r, unf_r, obs_r, h_r = ref
    b_g, se_g, _, conv_g, fail_g, unf_g, obs_g, h_g = got
    assert b_g.shape == b_r.shape and h_g.shape == h_r.shape
    np.testing.assert_array_equal(obs_g, obs_r)
    cond = _conds(blocks[:1], gws[:1], c[:N], mask[:N], covj)[0]
    ok = conv_r & ~fail_r & conv_g & ~fail_g
    assert (~ok).sum() == {"genotypic": 3, "interaction": 2}[design]
    np.testing.assert_array_equal(fail_g[ok | fail_r], fail_r[ok | fail_r])
    assert _close(b_g[ok], b_r[ok], _rtol(cond[ok])).all()
    assert _close(se_g[ok], se_r[ok], _rtol(cond[ok])).all()


@pytest.mark.parametrize("firth", [False, True], ids=["logistic", "firth"])
def test_glm_resid_scan_two_columns_matches_jax(geno_factory, firth):
    """glm_resid_scan with np_ = 2 (`genotypic cc-residualize`: the
    residualized K3 at d = 2) against JAX's, by the rules of the one-column
    residualized test."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import glm_resid_scan, scan_inputs_from_numpy
    from plink_tpu.ops.glm import glm_resid_scan as jax_scan

    blocks, gws, gwms, c, cy, y, mask, _ = _joint_inputs(geno_factory,
                                                         "genotypic")
    offs = _resid_inputs(geno_factory)[8]
    ref = [np.asarray(x) for x in jax_scan(
        jnp.asarray(blocks), jnp.asarray(gws), jnp.asarray(gwms),
        jnp.asarray(cy), jnp.asarray(offs), jnp.asarray(y), jnp.asarray(mask),
        DC, 2, firth)]
    ins = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                 torch.device("cpu"))
    got = [x.numpy() for x in glm_resid_scan(*ins, _t(offs), firth=firth)]
    assert got[3].shape == ref[3].shape == (NBLK, VB, 2)
    _scan_close(ref, got, 0, 7 if firth else 8,
                _conds(blocks, gws, c[:N], mask[:N], (0, 0), True),
                _f64_rows(blocks, gws, c[:N], y, mask, (0, 0), firth, offs),
                0 if firth else 8)


def test_resid_irls_block_two_columns_matches_jax(geno_factory):
    """resid_irls_block with np_ = 2 (the hybrid's residualized Firth
    fallback of `genotypic cc-residualize`) against JAX's."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import resid_irls_block, scan_inputs_from_numpy
    from plink_tpu.ops.glm import resid_irls_block as jax_block

    blocks, gws, gwms, c, cy, y, mask, _ = _joint_inputs(geno_factory,
                                                         "genotypic")
    offs = _resid_inputs(geno_factory)[8]
    ref = [np.asarray(x) for x in jax_block(
        jnp.asarray(blocks[0]), jnp.asarray(gws[0]), jnp.asarray(offs),
        jnp.asarray(y), jnp.asarray(mask), 2, True)]
    pk, gw, _, feat = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                             torch.device("cpu"))
    got = [x.numpy() for x in resid_irls_block(pk[0], gw[0], feat, _t(offs))]
    b_r, se_r, _, conv_r, fail_r, unf_r, obs_r, h_r = ref
    b_g, se_g, _, conv_g, fail_g, unf_g, obs_g, h_g = got
    assert b_g.shape == (VB, 2) and h_g.shape == (VB, 2, 2)
    np.testing.assert_array_equal(obs_g, obs_r)
    cond = _conds(blocks[:1], gws[:1], c[:N], mask[:N], (0, 0), True)[0]
    ok = conv_r & ~fail_r & conv_g & ~fail_g
    assert (~ok).sum() == 3, (~ok).sum()
    assert _close(b_g[ok], b_r[ok], _rtol(cond[ok])).all()
    assert _close(se_g[ok], se_r[ok], _rtol(cond[ok])).all()


@pytest.mark.parametrize("design", list(DESIGNS))
def test_design_moments_block_matches_jax(geno_factory, design):
    """design_moments_block (B1e, a thin wrapper over K2 / K15) against
    JAX's: X^T X of [c | G_1..G_P] to rtol 1e-5."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import design_moments_block
    from plink_tpu.ops.glm import design_moments_block as jax_moments

    blocks, gws, _, c, _, _, mask, covj = _joint_inputs(geno_factory, design)
    ref = np.asarray(jax_moments(jnp.asarray(blocks[0]), jnp.asarray(gws[0]),
                                 jnp.asarray(c), jnp.asarray(mask), DC,
                                 gws.shape[2], covj))
    feat = np.concatenate([c, mask[:, None]], axis=1)
    got = design_moments_block(_t(blocks[0]), _t(gws[0]), _t(feat),
                               covj=covj).numpy()
    assert got.shape == ref.shape == (VB, DC + gws.shape[2], DC + gws.shape[2])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("design", list(DESIGNS))
def test_logistic_irls_block_matches_jax(geno_factory, design):
    """logistic_irls_block (B1e) against JAX's: obs exact, flags equal and
    beta / SE rtol 1e-4 on the rows neither side refits."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import (design_moments_block, logistic_irls_block,
                                     scan_inputs_from_numpy)
    from plink_tpu.ops.glm import logistic_irls_block as jax_block

    blocks, gws, gwms, c, cy, y, mask, covj = _joint_inputs(geno_factory, design)
    ref = [np.asarray(x) for x in jax_block(
        jnp.asarray(blocks[0]), jnp.asarray(gws[0]), jnp.asarray(c),
        jnp.asarray(y), jnp.asarray(mask), DC, gws.shape[2], covj)]
    pk, gw, _, feat = scan_inputs_from_numpy(blocks, gws, gwms, c, cy, y, mask,
                                             torch.device("cpu"))
    got = [x.numpy() for x in logistic_irls_block(pk[0], gw[0], feat, covj=covj)]
    b_r, se_r, _, conv_r, fail_r, unf_r, obs_r, _ = ref
    b_g, se_g, _, conv_g, fail_g, unf_g, obs_g, _ = got
    np.testing.assert_array_equal(obs_g, obs_r)
    mom = design_moments_block(_t(blocks[0]), _t(gws[0]), _t(np.concatenate(
        [c, mask[:, None]], axis=1)), covj=covj).numpy()
    mst = np.stack([mom[:, 0, DC], mom[:, 0, 0]], 1)  # the first G column's sum
    refit = (_host_refit(b_r, se_r, conv_r, fail_r, unf_r, mst, obs_r, DC)
             | _host_refit(b_g, se_g, conv_g, fail_g, unf_g, mst, obs_g, DC))
    assert refit.sum() == {"genotypic": 7, "interaction": 3}[design], refit.sum()
    ok = ~refit
    for name, a, b in (("conv", conv_g, conv_r), ("fail", fail_g, fail_r)):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    cond = _conds(blocks[:1], gws[:1], c[:N], mask[:N], covj)[0]
    assert _close(b_g[ok], b_r[ok], _rtol(cond[ok])).all()
    assert _close(se_g[ok], se_r[ok], _rtol(cond[ok])).all()


def test_joint_designs_route_to_their_kernels():
    """The dispatch rule on (P, covj, d): K2 / K3 take one column, and two
    unscaled without a covariate factor; every G x covariate design and
    every wider one goes to K15 / K16, at any width (no refusal past d = 96:
    the wrappers' width limit is gone)."""
    from plink_torch.ops import glm as G
    from plink_torch.ops.glm import MAX_DC, P2_MAX_DC, _register_kernel

    assert _register_kernel(1, (0,), 12, None)
    assert _register_kernel(1, (0,), 12, torch.ones(4))
    assert _register_kernel(2, (0, 0), 12, None) == (12 <= P2_MAX_DC)
    assert not _register_kernel(2, (0, 0), 12, torch.ones(4))
    assert not _register_kernel(1, (3,), 12, None)
    assert not _register_kernel(12, (0,) * 12, 12, None)
    assert not _register_kernel(1, (0,), MAX_DC + 1, None)
    assert not hasattr(G, "WIDE_MAX_D") and not hasattr(G, "_wide_d")
    # the plain route takes a d = 128 design (what K15 / K16 take on the card)
    rng = np.random.default_rng(5)
    pk = torch.from_numpy(rng.integers(0, 256, size=(3, 16), dtype=np.uint8))
    feat = torch.from_numpy(np.column_stack(
        [np.ones(64), rng.normal(size=(64, 63)), rng.random(64) < 0.5,
         np.ones(64)]).astype(np.float32))
    gw = torch.tensor([1.0, 2.0, 0.0]).expand(3, 64, 3).contiguous()
    h, _, _ = G.glm_irls_pass(pk, gw, feat, torch.zeros(3, 128),
                              torch.ones(3, dtype=torch.bool), covj=tuple(range(64)))
    assert h.shape == (3, 128, 128)

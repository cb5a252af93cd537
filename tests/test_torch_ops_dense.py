"""The dosage GLM blocks (K17 / K18's plain versions) against plink_tpu's
`dense_cc_block` / `dense_firth_block` / `dense_qt_block` on the CPU.

The same seeded numpy inputs (16 variants x 4,608 samples, an intercept and
two covariates, 5% of the calls missing, half the variants with A1 = REF,
one rare variant and one hard-call-only variant) go through the JAX
functions, as f32 dosages and finite masks, and through the port's, as the
uint16 A1 dosages in 1/16384 units the kernels read (u / 16384 is exact in
f32, so both see the same design).

Rules: obs exact; the sums (X^T X, X^T y, y'y, sum g, sum g^2, sum g y) to
rtol 1e-5 (f32 sums in another order); beta / SE to rtol 1e-4 / atol 1e-5
and conv / fail / unf / invalid equal on the rows neither side sends to the
host's f64 refit (plink_tpu `_glm_dosage`'s rule: not converged, failed,
unfinished, |beta_g| or SE_g > 5: none of the logistic fits, 8 of the 16
Firth fits, whose f32 score stays above plink2's 1e-5 at n = 4,608 on
either side), as
tests/test_torch_ops_glm.py::test_glm_resid_scan_matches_jax holds the
residualized fits.
"""

import numpy as np
import pytest
import torch

VB, N, DC = 16, 4608, 3


def _make_inputs():
    rng = np.random.default_rng(29)
    freq = rng.uniform(0.05, 0.95, size=VB)
    freq[3] = 0.004  # rare
    u = np.zeros((VB, N), np.int64)
    for v in range(VB):
        hard = rng.binomial(2, freq[v], size=N) * 16384
        soft = np.clip(hard + rng.integers(-6000, 6001, N), 0, 32768)
        u[v] = np.where(rng.random(N) < 0.7, soft, hard)
    u[5] = rng.binomial(2, freq[5], size=N) * 16384  # hard calls only
    u[3] = np.where(rng.random(N) < 0.01, 16384, 0)
    miss = rng.random((VB, N)) < 0.05
    a1_ref = np.zeros(VB, bool)
    a1_ref[1::2] = True
    ua = np.where(a1_ref[:, None], 32768 - u, u)  # A1-oriented
    dos = np.where(miss, 65535, ua).astype(np.uint16)
    cov = rng.normal(size=(N, DC - 1))
    g0 = np.where(miss, 0.0, ua / 16384.0)
    eta = -0.3 + 0.5 * cov[:, 0] + 0.2 * (g0[0] - 1.0)
    y = (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    c = np.column_stack([np.ones(N), cov]).astype(np.float32)
    qt = (0.3 * cov[:, 1] + rng.normal(size=N)).astype(np.float32)
    return dos, c, y, qt


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs()


def _jax(fn, dos, c, y, **kw):
    import jax.numpy as jnp

    fin = dos != 65535
    g = np.where(fin, dos.astype(np.float64) / 16384.0, 0.0).astype(np.float32)
    outs = fn(jnp.asarray(g), jnp.asarray(fin.astype(np.float32)),
              jnp.asarray(c), jnp.asarray(y), jnp.ones(N, jnp.float32), DC, **kw)
    return [np.asarray(x) for x in outs]


def _port(fn, dos, c, y, **kw):
    feat = np.column_stack([c, y, np.ones(N, np.float32)]).astype(np.float32)
    return [x.numpy() for x in fn(torch.from_numpy(dos), torch.from_numpy(feat),
                                  **kw)]


def _refit(beta, se, conv, fail, unf):
    with np.errstate(invalid="ignore"):
        return (~conv | fail | unf | (np.abs(beta[:, DC:]).max(axis=1) > 5.0)
                | (se[:, DC:].max(axis=1) > 5.0) | ~np.isfinite(se).all(axis=1))


def _fits_agree(ref, got, n_refit):
    b_r, se_r, conv_r, fail_r, unf_r, inv_r = ref
    b_g, se_g, conv_g, fail_g, unf_g, inv_g = got
    refit = _refit(b_r, se_r, conv_r, fail_r, unf_r) \
        | _refit(b_g, se_g, conv_g, fail_g, unf_g)
    assert refit.sum() == n_refit, np.flatnonzero(refit)
    # the rows sent to the refit stop where their f32 score test lets them
    # (the Firth fits at n = 4,608 mostly at the iteration limit): their
    # estimates still agree within 1e-3 of the SE
    assert (np.abs(b_g - b_r)[refit] <= 1e-3 * se_r[refit]).all()
    ok = ~refit
    for name, a, b in (("conv", conv_g, conv_r), ("fail", fail_g, fail_r),
                       ("unf", unf_g, unf_r), ("invalid", inv_g, inv_r)):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)
    np.testing.assert_allclose(b_g[ok], b_r[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(se_g[ok], se_r[ok], rtol=1e-4, atol=1e-5)


def test_dense_qt_block_matches_jax(inputs):
    from plink_torch.ops.glm import dense_qt_block
    from plink_tpu.ops.glm import dense_qt_block as jax_block

    dos, c, _, qt = inputs
    ref = _jax(jax_block, dos, c, qt)
    got = _port(dense_qt_block, dos, c, qt)
    for name, a, b in zip(("xtx", "xty", "yy", "g_tot", "g_ssq"), got[:5], ref[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(got[5], ref[5])


@pytest.mark.parametrize("firth", [False, True], ids=["logistic", "firth"])
def test_dense_cc_block_matches_jax(inputs, firth):
    from plink_torch.ops.glm import dense_cc_block
    from plink_tpu.ops.glm import dense_cc_block as jax_block

    dos, c, y, _ = inputs
    ref = _jax(jax_block, dos, c, y, firth=firth)
    got = _port(dense_cc_block, dos, c, y, firth=firth)
    for name, i in (("xtx", 0), ("g_case", 1), ("g_tot", 2), ("g_ssq", 3)):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-5, atol=1e-3,
                                   err_msg=name)
    np.testing.assert_array_equal(got[9], ref[9])
    assert got[4].shape == ref[4].shape == (VB, DC + 1)
    pick = [4, 5, 6, 7, 8, 10]
    _fits_agree([ref[i] for i in pick], [got[i] for i in pick], 8 if firth else 0)


def test_dense_firth_block_matches_jax(inputs):
    from plink_torch.ops.glm import dense_firth_block
    from plink_tpu.ops.glm import dense_firth_block as jax_block

    dos, c, y, _ = inputs
    ref = _jax(jax_block, dos, c, y)
    got = _port(dense_firth_block, dos, c, y)
    np.testing.assert_array_equal(got[5], ref[5])
    pick = [0, 1, 2, 3, 4, 6]
    _fits_agree([ref[i] for i in pick], [got[i] for i in pick], 8)


def test_dense_firth_block_active_rows(inputs):
    """Rows outside `active` are not fitted (zeros, not converged) and the
    others equal the all-rows fit."""
    from plink_torch.ops.glm import dense_firth_block

    dos, c, y, _ = inputs
    feat = torch.from_numpy(np.column_stack([c, y, np.ones(N, np.float32)]))
    dt = torch.from_numpy(dos)
    act = torch.zeros(VB, dtype=torch.bool)
    act[::3] = True
    full = dense_firth_block(dt, feat)
    part = dense_firth_block(dt, feat, act)
    assert torch.equal(part[0][act], full[0][act])
    assert not part[2][~act].any() and not part[0][~act].any()

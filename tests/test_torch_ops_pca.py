"""plink_torch's PCA operators (K9 x_apply, K10 xt_apply, xtx_apply) against
plink_tpu's on the CPU.

The same numpy-seeded inputs go through plink_tpu/ops/pca.py (jitted, on the
CPU) and, through `pca_inputs_from_numpy`, through the port's plain PyTorch
versions (what the wrappers run for CPU tensors): 150 samples (a ragged
last packed byte, two padded samples), five blocks of 64 variants with
zeroed coefficient rows (excluded variants) and a padded last block.
Tolerance 1e-5, each entry normalised by its Cauchy-Schwarz scale
sqrt(sum Z^2 * sum q^2) over the contracted axis (f32 sums in another
order; the power iterations' magnitudes grow by lambda per step, so an
absolute tolerance would mean nothing).
"""

import numpy as np
import pytest
import torch

N, NB, VB = 150, 5, 64
NPAD = -(-N // 4) * 4
TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    from plink_tpu.ops.pairwise import _pack_np, grm_coefs

    rng = np.random.default_rng(23)
    V = NB * VB
    maf = rng.uniform(0.02, 0.5, size=(V, 1))
    codes = ((rng.random((V, N)) < maf).astype(np.uint8)
             + (rng.random((V, N)) < maf))
    codes[rng.random((V, N)) < 0.05] = 3
    packed = _pack_np(codes, NPAD).reshape(NB, VB, NPAD // 4)
    vmask = rng.random(V) < 0.85
    vmask[-20:] = False  # the padded rows of the last block
    packed.reshape(V, -1)[-20:] = 0
    freqs = rng.uniform(0.0, 1.0, V)
    freqs[:3] = (0.0, 1.0, np.nan)  # zero-variance and unobserved variants
    coef = grm_coefs(freqs, np.zeros(V, bool), vmask).reshape(NB, VB, 3)
    smask = np.zeros(NPAD, np.float32)
    smask[:N] = 1.0
    return packed, coef, smask, rng


def _z(packed, coef, smask):
    """The standardised dosages [V, npad] in f64 (numpy)."""
    from plink_torch.ops.planes import _unpack_np

    codes = _unpack_np(packed.reshape(NB * VB, -1)).astype(np.int64)
    z = np.take_along_axis(coef.reshape(-1, 3).astype(np.float64),
                           np.minimum(codes, 2), axis=1)
    z[codes == 3] = 0.0
    return z * smask[None, :]


def _norm_err(got, ref, scale):
    return float((np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
                  / np.maximum(scale, 1e-30)).max())


@pytest.mark.parametrize("L", [3, 20])
def test_x_apply_matches_jax(data, L):
    """K9's plain version: X q per block, [nb, vb, L]."""
    import jax.numpy as jnp

    from plink_torch.ops.pca import pca_inputs_from_numpy, x_apply
    from plink_tpu.ops.pca import x_apply as ref_x

    packed, coef, smask, rng = data
    q = rng.standard_normal((NPAD, L)).astype(np.float32)
    q[N:] = 0.0
    ref = np.asarray(ref_x(*(jnp.asarray(a) for a in (packed, coef, smask, q))))
    got = x_apply(*pca_inputs_from_numpy(packed, coef, smask, q))
    assert got.dtype == torch.float32 and tuple(got.shape) == (NB, VB, L)
    z = _z(packed, coef, smask)
    scale = np.sqrt(np.outer((z ** 2).sum(1), (q.astype(np.float64) ** 2).sum(0)))
    assert _norm_err(got.numpy().reshape(-1, L), ref.reshape(-1, L), scale) <= TOL
    assert not got.numpy().reshape(-1, L)[-20:].any()  # padded variants


@pytest.mark.parametrize("L", [3, 20])
def test_xt_apply_matches_jax(data, L):
    """K10's plain version: X^T b, [npad, L]."""
    import jax.numpy as jnp

    from plink_torch.ops.pca import pca_inputs_from_numpy, xt_apply
    from plink_tpu.ops.pca import xt_apply as ref_xt

    packed, coef, smask, rng = data
    b = rng.standard_normal((NB, VB, L)).astype(np.float32)
    ref = np.asarray(ref_xt(*(jnp.asarray(a) for a in (packed, coef, smask, b))))
    got = xt_apply(*pca_inputs_from_numpy(packed, coef, smask, b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (NPAD, L)
    z = _z(packed, coef, smask)
    bb = b.reshape(-1, L).astype(np.float64)
    scale = np.sqrt(np.outer((z ** 2).sum(0), (bb ** 2).sum(0)))
    assert _norm_err(got.numpy(), ref, scale) <= TOL
    assert not got.numpy()[N:].any()  # padded samples


@pytest.mark.parametrize("steps", [1, 3])
def test_xtx_apply_matches_jax(data, steps):
    """(X^T X) q, and a few power iterations of it as _pca_approx takes
    them (each scaled by 1 / M, the magnitudes growing by ~lambda a step):
    every step within TOL of plink_tpu's on the same input."""
    import jax.numpy as jnp

    from plink_torch.ops.pca import pca_inputs_from_numpy, xtx_apply
    from plink_tpu.ops.pca import xtx_apply as ref_xtx

    packed, coef, smask, rng = data
    L = 6
    cur = rng.standard_normal((NPAD, L)).astype(np.float32)
    cur[N:] = 0.0
    z = _z(packed, coef, smask)
    inv_m = 1.0 / (NB * VB)
    for _ in range(steps):
        ref = np.asarray(ref_xtx(*(jnp.asarray(a) for a in (packed, coef, smask, cur)))
                         * inv_m)
        got = (xtx_apply(*pca_inputs_from_numpy(packed, coef, smask, cur)) * inv_m).numpy()
        t = z @ cur.astype(np.float64)
        scale = inv_m * np.sqrt(np.outer((z ** 2).sum(0), (t ** 2).sum(0)))
        assert _norm_err(got, ref, scale) <= TOL
        cur = ref.astype(np.float32)


def test_normed_block_matches_jax(data):
    """The plain decode equals plink_tpu's _normed_block on every block."""
    import jax.numpy as jnp

    from plink_torch.ops.pca import _normed_block, pca_inputs_from_numpy
    from plink_tpu.ops.pca import _normed_block as ref_block

    packed, coef, smask, _ = data
    pk, cf, sm, _ = pca_inputs_from_numpy(packed, coef, smask, smask[:, None])
    for k in range(NB):
        ref = np.asarray(ref_block(jnp.asarray(packed[k]), jnp.asarray(coef[k]),
                                   jnp.asarray(smask)))
        np.testing.assert_array_equal(_normed_block(pk[k], cf[k], sm).numpy(), ref)


@pytest.mark.parametrize("fn", ["x_apply", "xt_apply", "xtx_apply"])
def test_wrappers_refuse_bad_operands(data, fn):
    """The wrappers check shapes, types and devices before they dispatch."""
    import plink_torch.ops.pca as P

    packed, coef, smask, _ = data
    vec = (np.zeros((NB, VB, 2), np.float32) if fn == "xt_apply"
           else np.zeros((NPAD, 2), np.float32))
    pk, cf, sm, v = P.pca_inputs_from_numpy(packed, coef, smask, vec)
    getattr(P, fn)(pk, cf, sm, v)  # accepted
    with pytest.raises(ValueError):
        getattr(P, fn)(pk, cf[:, :, :2].contiguous(), sm, v)
    with pytest.raises(ValueError):
        getattr(P, fn)(pk, cf, sm[:-4].contiguous(), v)
    with pytest.raises(ValueError):
        getattr(P, fn)(pk, cf, sm, v[:-1].contiguous())

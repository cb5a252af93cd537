"""K21 / K22's plain versions (plink_torch/ops/counts.py) against plink_tpu's
`_sample_plane_weighted` / `_variant_plane_weighted` on seeded numpy
genotypes with n % 4 != 0 (pad samples in the last byte).

- f64: within 1e-12 of plink_tpu's, relative to the sum of |weight| over
  the terms (the two sum in different orders);
- f32 with 0/1 weights (--sample-counts' selectors): exactly equal;
- the plain version's order: K21's, checked bit for bit against a
  variant-by-variant numpy sum in the kernel's splits;
- f32 past 2^24 in one sample's sum (the split cap lowered): exact, as
  plink_tpu's f32 blocks added in f64 on the host;
- non-finite weights: NaN and +-Inf exactly where plink_tpu's dots give
  them (a NaN or Inf weight times a 0 plane entry is NaN);
- the host helpers (one launch for K weight sets) against plink_tpu's host
  wrappers called once per weight set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plink_torch.ops import counts as C
from plink_tpu.ops import counts as J

SHAPES = [(203, 70), (1001, 64), (37, 9), (4, 1)]  # samples, variants


def _packed(n, V, seed):
    rng = np.random.default_rng(seed)
    npad = -(-n // 4) * 4
    maf = rng.uniform(0.01, 0.5, size=(V, 1))
    codes = (rng.random((V, n)) < maf).astype(np.uint8) + (rng.random((V, n)) < maf)
    codes[rng.random((V, n)) < 0.05] = 3
    buf = np.zeros((V, npad), np.uint8)
    buf[:, :n] = codes
    b = buf.reshape(V, npad // 4, 4)
    return (b[..., 0] | b[..., 1] << 2 | b[..., 2] << 4 | b[..., 3] << 6).astype(np.uint8)


def _jax_spw(packed, wts, f64):
    """plink_tpu's per-sample sums, one call per weight set: [K, npad]."""
    npad = packed.shape[1] * 4
    return np.stack([np.asarray(J._sample_plane_weighted(
        jnp.asarray(packed), jnp.asarray(wts[:, :, k]), npad, f64), np.float64)
        for k in range(wts.shape[2])])


def _jax_vpw(packed, w, f64):
    npad = packed.shape[1] * 4
    return np.asarray(J._variant_plane_weighted(
        jnp.asarray(packed), jnp.asarray(w), npad, f64), np.float64)


def _close(got, ref, scale):
    fin = np.isfinite(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isposinf(got), np.isposinf(ref))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    err = np.abs(got[fin] - ref[fin]) / np.maximum(scale[fin], 1e-300)
    assert err.size == 0 or err.max() <= 1e-12, err.max()


@pytest.mark.parametrize("n,V", SHAPES)
@pytest.mark.parametrize("K", [1, 3, 10])
def test_sample_plane_weighted_f64(n, V, K):
    """Weights on every plane, K weight sets in one call."""
    packed = _packed(n, V, n + V)
    wts = np.random.default_rng(K).normal(size=(V, 4, K))
    got = C.sample_plane_weighted(torch.from_numpy(packed),
                                  torch.from_numpy(wts)).numpy()
    assert got.shape == (K, packed.shape[1] * 4) and got.dtype == np.float64
    scale = _jax_spw(packed, np.abs(wts), True)
    _close(got, _jax_spw(packed, wts, True), scale)


@pytest.mark.parametrize("n,V", SHAPES)
def test_sample_plane_weighted_f32_selectors(n, V):
    """0/1 selectors summed in f32 (plink_tpu's f64=False): exact."""
    packed = _packed(n, V, 3)
    wts = (np.random.default_rng(4).random((V, 4, 10)) < 0.5).astype(np.float32)
    got = C.sample_plane_weighted(torch.from_numpy(packed),
                                  torch.from_numpy(wts)).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, _jax_spw(packed, wts, False))


def test_sample_plane_weighted_f32_past_2_24(monkeypatch):
    """f32 sums past 2^24: with the split cap lowered to 4 variants, weights
    of 2^22 on 8 variants and 1 on 3 give 2^25 + 3 for every sample, which
    no f32 holds; the port's f32 splits added in f64 give it exactly, as
    plink_tpu's sample-counts loop does (f32 per block, f64 on the host)."""
    monkeypatch.setattr(C, "F32_SPLIT_ROWS", 4)
    n, V = 203, 11
    packed = _packed(n, V, 12)
    wts = np.ones((V, 4, 2), np.float32)
    wts[:8] = 2.0 ** 22
    wts[:, :, 1] = 1.0  # a 0/1 selector set beside it
    got = C.sample_plane_weighted(torch.from_numpy(packed),
                                  torch.from_numpy(wts)).numpy()
    ref = sum(_jax_spw(packed[v0:v0 + 4], wts[v0:v0 + 4], False)
              for v0 in range(0, V, 4))
    assert (ref[0] == 2.0 ** 25 + 3).all() and (ref[1] == V).all()
    assert np.array_equal(got, ref)
    assert not np.array_equal(_jax_spw(packed, wts, False), ref)  # one f32 sum


@pytest.mark.parametrize("V,f64", [(70, True), (700, True), (700, False)])
def test_sample_plane_weighted_kernel_order(V, f64):
    """The plain version sums in K21's order, bit for bit: per sample, in
    each of the kernel's splits, the weight of its genotype's plane variant
    by variant in the weights' type, the splits added in f64 in index
    order (here 1 and 11 splits).  A score whose exact value is a decimal
    tie at 6 digits then prints alike on the card and the CPU."""
    n = 203
    packed = _packed(n, V, 21)
    dt = np.float64 if f64 else np.float32
    wts = np.random.default_rng(V).normal(size=(V, 4, 3)).astype(dt)
    got = C.sample_plane_weighted(torch.from_numpy(packed),
                                  torch.from_numpy(wts)).numpy()
    codes = C._unpack_np(packed).astype(np.int64)
    splits = C._spw_splits(V, packed.shape[1], f64)
    rows = -(-V // splits)
    want = np.zeros((3, codes.shape[1]))
    for s0 in range(0, V, rows):
        acc = np.zeros((codes.shape[1], 3), dt)
        for v in range(s0, min(V, s0 + rows)):
            acc += wts[v][codes[v]]
        want += acc.T.astype(np.float64)
    assert V < 100 or splits > 1
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("plane", [0, 1, 2, 3])
def test_sample_plane_weighted_nonfinite(bad, plane):
    """One non-finite weight: NaN where its plane is 0, +-Inf where it is 1
    (and NaN everywhere for a NaN weight), in its weight set only; also on
    an all-hom-REF block with the weight on the missing plane."""
    packed = _packed(203, 70, 5)
    wts = np.random.default_rng(6).normal(size=(70, 4, 3))
    wts[11, plane, 1] = bad
    got = C.sample_plane_weighted(torch.from_numpy(packed),
                                  torch.from_numpy(wts)).numpy()
    ref = _jax_spw(packed, wts, True)
    _close(got, ref, _jax_spw(packed, np.nan_to_num(np.abs(wts)), True))
    assert np.isfinite(got[[0, 2]]).all() and not np.isfinite(got[1]).all()
    homref = np.zeros_like(packed)
    z = np.zeros((70, 4, 1))
    z[3, 3, 0] = bad
    got = C.sample_plane_weighted(torch.from_numpy(homref), torch.from_numpy(z))
    assert np.isnan(got.numpy()).all() and np.isnan(_jax_spw(homref, z, True)).all()


@pytest.mark.parametrize("n,V", SHAPES)
@pytest.mark.parametrize("K", [1, 2, 6])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_variant_plane_weighted(n, V, K, f64):
    """f64 within 1e-12 (relative to sum |w|); f32 with 0/1 weights exact
    (the weights rounded to f32 before the product, as plink_tpu casts)."""
    packed = _packed(n, V, 7 + K)
    npad = packed.shape[1] * 4
    rng = np.random.default_rng(K)
    w = np.zeros((npad, K), np.float64 if f64 else np.float32)
    w[:n] = rng.normal(size=(n, K)) if f64 else rng.random((n, K)) < 0.6
    got = C.variant_plane_weighted(torch.from_numpy(packed),
                                   torch.from_numpy(w)).numpy()
    assert got.shape == (V, K, 3) and got.dtype == w.dtype
    ref = _jax_vpw(packed, w, f64)
    if f64:
        _close(got, ref, _jax_vpw(packed, np.abs(w), True))
    else:
        assert np.array_equal(got.astype(np.float64), ref)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_variant_plane_weighted_nonfinite(bad):
    """One NaN sample weight makes its column NaN on every variant; an Inf
    one gives Inf where the sample is in the plane, NaN elsewhere."""
    packed = _packed(203, 70, 8)
    w = np.zeros((204, 2))
    w[:203] = np.random.default_rng(9).normal(size=(203, 2))
    w[17, 1] = bad
    got = C.variant_plane_weighted(torch.from_numpy(packed),
                                   torch.from_numpy(w)).numpy()
    ref = _jax_vpw(packed, w, True)
    _close(got, ref, _jax_vpw(packed, np.nan_to_num(np.abs(w)), True))
    assert np.isfinite(got[:, 0]).all()
    if np.isnan(bad):
        assert np.isnan(got[:, 1]).all()


def test_host_helpers_match_plink_tpu():
    """weighted_sample_sums / weighted_variant_sums (one launch for K
    weight sets, pad samples cut) against plink_tpu's host wrappers."""
    n, V = 203, 70
    packed = _packed(n, V, 10)
    rng = np.random.default_rng(11)
    wts = rng.normal(size=(V, 4, 3))
    got = C.weighted_sample_sums(torch.from_numpy(packed), n, wts)
    assert got.shape == (3, n)
    ref = np.stack([J.sample_plane_weighted(packed, n, wts[:, :, k])
                    for k in range(3)])
    scale = np.stack([J.sample_plane_weighted(packed, n, np.abs(wts[:, :, k]))
                      for k in range(3)])
    _close(got, ref, scale)
    w = rng.normal(size=(n, 4))
    got = C.weighted_variant_sums(torch.from_numpy(packed), n, w, f64=False)
    ref = J.variant_plane_weighted(packed, n, w, f64=False)
    assert got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    got = C.weighted_variant_sums(torch.from_numpy(packed), n, w)
    _close(got, J.variant_plane_weighted(packed, n, w),
           J.variant_plane_weighted(packed, n, np.abs(w)))

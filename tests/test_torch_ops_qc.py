"""plink_torch's QC and linear-GLM device functions against plink_tpu's on
the CPU.

The same seeded numpy inputs go through the JAX reference (plink_tpu.ops,
on the CPU as its own tests run it) and through the port's plain PyTorch
versions (what the kernel wrappers run for CPU tensors).
"""

import numpy as np
import pytest
import torch

N, V = 301, 150  # samples (npad 304; a ragged last byte), variants


def _packed(geno_factory, missing_rate=0.1):
    from plink_tpu.ops.pairwise import _pack_np

    codes = geno_factory(V, N, missing_rate=missing_rate)
    return _pack_np(codes, -(-N // 4) * 4)


def _vmask(seed):
    return (np.random.default_rng(seed).random(V) < 0.7).astype(np.float32)


def test_sample_counts_plain_matches_jax(geno_factory):
    """K5's plain version equals _sample_miss_counts and
    _sample_het_hom_counts exactly, with variant masks that drop rows; two
    masks in one call equal two calls."""
    import jax.numpy as jnp

    from plink_torch.ops.counts import sample_counts
    from plink_tpu.ops.counts import _sample_het_hom_counts, _sample_miss_counts

    packed = _packed(geno_factory)
    npad = packed.shape[1] * 4
    vms = [_vmask(1), _vmask(2)]
    got_miss = sample_counts(torch.from_numpy(packed),
                             torch.from_numpy(np.stack(vms, 1))).numpy()
    got_hh = sample_counts(torch.from_numpy(packed),
                           torch.from_numpy(np.stack(vms, 1)), het_hom=True).numpy()
    for g, vm in enumerate(vms):
        ref_miss = np.asarray(_sample_miss_counts(jnp.asarray(packed),
                                                  jnp.asarray(vm), npad))
        ref_hh = np.asarray(_sample_het_hom_counts(jnp.asarray(packed),
                                                   jnp.asarray(vm), npad))
        np.testing.assert_array_equal(got_miss[g], ref_miss)
        np.testing.assert_array_equal(got_hh[g], ref_hh)


def test_geno_counts_one_mask_matches_jax(geno_factory):
    """K1 with G = 1 equals _geno_counts_masked exactly."""
    import jax.numpy as jnp

    from plink_torch.ops.counts import geno_counts
    from plink_tpu.ops.counts import _geno_counts_masked

    packed = _packed(geno_factory)
    npad = packed.shape[1] * 4
    mask = np.zeros(npad, np.float32)
    mask[:N] = np.random.default_rng(4).random(N) < 0.6
    ref = np.asarray(_geno_counts_masked(jnp.asarray(packed), jnp.asarray(mask),
                                         npad))
    got = geno_counts(torch.from_numpy(packed),
                      torch.from_numpy(mask[:, None].copy())).numpy()[0]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
def test_host_count_helpers_match_jax(geno_factory, host):
    """The helpers the reports and filters call take the host matrix (tiny
    panels, numpy) or the device-resident one (K1 / K5), with the same
    result as plink_tpu's sample_missing_counts and geno_counts."""
    from plink_torch.ops.counts import (masked_geno_counts,
                                        sample_het_hom_counts,
                                        sample_missing_counts)
    from plink_tpu.ops import counts as J

    packed = _packed(geno_factory)
    mat = packed if host else torch.from_numpy(packed)
    vms = [_vmask(5), _vmask(6)]
    got = sample_missing_counts(mat, N, vms)
    for g, vm in enumerate(vms):
        np.testing.assert_array_equal(got[g], J.sample_missing_counts(packed, N, vm))
    masks = [np.random.default_rng(7 + k).random(N) < 0.5 for k in range(3)]
    for g, cts in enumerate(masked_geno_counts(mat, masks)):
        np.testing.assert_array_equal(cts, J.geno_counts(packed, N, masks[g]))
    if not host:  # the het/hom form has no host branch, as in plink_tpu
        np.testing.assert_array_equal(
            sample_het_hom_counts(mat, N, vms[0]),
            J.sample_het_hom_counts(packed, N, vms[0]))


def test_linear_sums_plain_matches_jax(geno_factory):
    """K6's plain version against linear_sums_scan.  Both sum the same f32
    products in another order (JAX's HIGHEST-precision dot against torch's
    f32 matmul): rtol 1e-5 relative to each entry's own size, plus an
    absolute 1e-4 for entries that cancel toward 0."""
    import jax.numpy as jnp

    from plink_torch.ops.glm import linear_sums_scan
    from plink_tpu.ops.glm import linear_sums_scan as jax_scan

    rng = np.random.default_rng(9)
    nblk, vb, dc = 2, V // 2, 4
    blocks = _packed(geno_factory, 0.05).reshape(nblk, vb, -1)
    npad = blocks.shape[2] * 4
    c = np.zeros((npad, dc))
    c[:N, 0] = 1.0
    c[:N, 1:] = rng.normal(size=(N, dc - 1))
    y = np.zeros(npad)
    y[:N] = rng.normal(size=N)
    f32 = [a.astype(np.float32) for a in (
        c, (c[:, :, None] * c[:, None, :]).reshape(npad, dc * dc), y,
        c * y[:, None], y * y)]
    ref = jax_scan(jnp.asarray(blocks), *(jnp.asarray(a) for a in f32))
    got = linear_sums_scan(torch.from_numpy(blocks),
                           *(torch.from_numpy(a) for a in (f32[1], f32[3], f32[4])))
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)


def test_linear_sums_a1_ref_swaps_the_hom_planes(geno_factory):
    """K6's plain version with a1_ref: a flagged variant's sums are those of
    its codes with hom-REF and hom-ALT swapped, bit for bit; the others
    are untouched."""
    from plink_torch.ops.glm import linear_sums
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(10)
    codes = geno_factory(V, N, missing_rate=0.05)
    a1r = rng.random(V) < 0.5
    swapped = np.where(a1r[:, None] & (codes % 2 == 0), 2 - codes, codes)
    npad = -(-N // 4) * 4
    dc = 3
    c = np.zeros((npad, dc))
    c[:N] = np.column_stack([np.ones(N), rng.normal(size=(N, dc - 1))])
    y = np.zeros(npad)
    y[:N] = rng.normal(size=N)
    ins = [torch.from_numpy(a.astype(np.float32)) for a in (
        (c[:, :, None] * c[:, None, :]).reshape(npad, dc * dc), c * y[:, None],
        y * y)]
    got = linear_sums(torch.from_numpy(_pack_np(codes, npad)), *ins,
                      torch.from_numpy(a1r))
    want = linear_sums(torch.from_numpy(_pack_np(swapped.astype(np.uint8), npad)),
                       *ins)
    assert a1r.any() and not a1r.all()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_qc_wrappers_refuse_other_devices():
    """K5 and K6 run their plain versions only for CPU tensors: on any
    other device they launch their kernel or raise, never fall back."""
    from plink_torch.ops.counts import sample_counts
    from plink_torch.ops.glm import linear_sums

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        sample_counts(torch.empty((4, 2), dtype=torch.uint8, device=meta),
                      torch.empty((4, 1), device=meta))
    with pytest.raises(ValueError):
        linear_sums(torch.empty((4, 2), dtype=torch.uint8, device=meta),
                    torch.empty((8, 4), device=meta),
                    torch.empty((8, 2), device=meta), torch.empty(8, device=meta))


@pytest.mark.parametrize("n", [200, 20000])
def test_hwe_window_matches_full_support(n):
    """The port's HWE exact test evaluates only the het counts whose weight
    does not underflow; plink_tpu's evaluates the whole support.  Where the
    window is the whole support (small n) the p-values are identical; where
    it is not, they differ only by the summation order of the same f64
    terms (< 1e-15 relative)."""
    from plink_torch.stats.hwe import hwe_exact_pvals
    from plink_tpu.stats.hwe import hwe_exact_pvals as jax_pvals

    rng = np.random.default_rng(n)
    p = rng.random(500) * 0.5
    hr = rng.binomial(n, (1 - p) ** 2)
    het = np.minimum(rng.binomial(n, 2 * p * (1 - p)), n - hr)
    het[:20] //= 2  # far out of equilibrium
    hr[20], het[20] = n, 0  # monomorphic
    ha = n - hr - het
    for midp in (False, True):
        got = hwe_exact_pvals(hr, het, ha, midp)
        ref = jax_pvals(hr, het, ha, midp)
        if n <= 200:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)

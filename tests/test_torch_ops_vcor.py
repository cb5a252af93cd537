"""plink_torch's LD report operations against plink_tpu's on the CPU: K12
`ld_band_stats` and `LdBand`, K13 `ld_gram_pair` and `LdJointBand`, and
the haplotype solver of stats/phased_ld.py.

Panel: numpy-seeded codes of 150 samples (npad 152, not a multiple of 32;
a ragged last packed byte, ten samples masked out) x 300 variants (not a
multiple of any chunk) with 6% missing calls, runs of copied variants with
a few calls changed (high r^2), and monomorphic, all-het, all-missing and
single-call variants.  Every count is compared as int64 with no tolerance;
the solver's outputs bit for bit.
"""

import numpy as np
import pytest
import torch

N, V = 150, 300
NPAD = -(-N // 4) * 4
WIDTHS = [1, 5, 64, 200]


@pytest.fixture(scope="module")
def panel():
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(41)
    maf = rng.uniform(0.05, 0.5, size=(V, 1))
    codes = ((rng.random((V, N)) < maf).astype(np.uint8)
             + (rng.random((V, N)) < maf))
    for v0 in range(0, V - 8, 29):  # LD runs: copies with a few calls changed
        for d in range(1, 6):
            codes[v0 + d] = codes[v0]
            flip = rng.random(N) < 0.05 * d
            codes[v0 + d, flip] = rng.integers(0, 3, flip.sum())
    codes[rng.random((V, N)) < 0.06] = 3
    codes[10] = 0           # monomorphic hom-REF
    codes[11] = 2           # monomorphic hom-ALT
    codes[12] = 1           # all het
    codes[13] = 3           # all missing
    codes[14] = 3
    codes[14, 5] = 2        # a single observed call
    smask = np.zeros(NPAD, np.int8)
    smask[:N] = 1
    smask[rng.choice(N, 10, replace=False)] = 0
    return _pack_np(codes, NPAD), smask


def _tensors(packed, smask):
    from plink_torch.ops.ld import ld_inputs_from_numpy

    return ld_inputs_from_numpy(packed, smask)


@pytest.mark.parametrize("width", WIDTHS)
def test_band_stats_match_jax_scan(panel, width):
    """K12's plain version against `_ld_band_scan` run over chunks of
    max(64, width) rows (plink_tpu's LdBand layout): the six statistics of
    every pair (i, i + d), d = 0 included, and the three count vectors; the
    port's entries past the subcontig's end are 0."""
    import jax.numpy as jnp

    from plink_torch.ops.ld import ld_band_stats
    from plink_tpu.ops.ld import _ld_band_scan

    packed, smask = panel
    c = max(64, width)
    nc = -(-V // c)
    pr = np.concatenate([packed, np.zeros((nc * c - V, packed.shape[1]), np.uint8)])
    blocks = jnp.asarray(pr.reshape(nc, c, -1))
    nxt = jnp.concatenate([blocks[1:], jnp.zeros_like(blocks[:1])], axis=0)
    six, nm1, hr1, ha1 = (np.asarray(a) for a in _ld_band_scan(
        blocks, nxt, jnp.asarray(smask), width))
    ref = six.transpose(1, 0, 2, 3).reshape(6, nc * c, width + 1)[:, :V]
    got = ld_band_stats(*_tensors(packed, smask), width)
    stats = got[0].numpy()
    assert got[0].dtype == torch.int32 and stats.shape == (6, V, width + 1)
    ii, dd = np.arange(V)[:, None], np.arange(width + 1)[None, :]
    inside = ii + dd < V
    np.testing.assert_array_equal(stats[:, inside], ref[:, inside])
    assert not stats[:, ~inside].any()
    assert stats[1, inside].min() >= 0 and stats[1].max() <= int(smask.sum())
    for g, r in zip(got[1:], (nm1, hr1, ha1)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r.reshape(-1)[:V])


@pytest.mark.parametrize("width", WIDTHS)
def test_ld_band_matches_jax(panel, width):
    """The port's LdBand equals plink_tpu's as int64: the six bands, nm1,
    homref1, homalt1, the clipped width, `pair` and `r2_exceeds_vec`."""
    from plink_torch.ops.ld import LdBand
    from plink_tpu.ops.ld import LdBand as RefBand

    packed, smask = panel
    ref = RefBand(packed, smask, width)
    got = LdBand(_tensors(packed, smask)[0], smask, width)
    assert got.width == ref.width and got.n == ref.n
    for key in LdBand.KEYS:
        assert got.bands[key].dtype == np.int64
        np.testing.assert_array_equal(got.bands[key], ref.bands[key], key)
    for key in ("nm1", "homref1", "homalt1"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), key)
    d = min(width, 3)
    assert got.pair("dot", 40, 40 + d) == ref.pair("dot", 40, 40 + d)
    f = np.arange(100 - width, 100) if width < 100 else np.arange(0, 100)
    for t in (0.05, 0.5):
        np.testing.assert_array_equal(got.r2_exceeds_vec(f, 100, t),
                                      ref.r2_exceeds_vec(f, 100, t))


@pytest.mark.parametrize("rows", [(0, 70, 200, 245), (37, 300, 0, 19), (5, 6, 5, 6)],
                         ids=["70x45", "263x19", "1x1"])
def test_gram_pair_matches_jax(panel, rows):
    """K13's plain version equals plink_tpu's `ld_gram_pair` for chunks of
    different lengths, the partial sample mask applied."""
    import jax.numpy as jnp

    from plink_torch.ops.ld import ld_gram_pair
    from plink_tpu.ops.ld import ld_gram_pair as ref_gram

    packed, smask = panel
    a0, a1, b0, b1 = rows
    pa, pb = packed[a0:a1], packed[b0:b1]
    ref = np.asarray(ref_gram(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(smask)))
    ta, sm = _tensors(pa, smask)
    got = ld_gram_pair(ta, _tensors(pb, smask)[0], sm)
    assert got.dtype == torch.int32 and got.shape == (3 * (a1 - a0), 3 * (b1 - b0))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_pair_stats_from_gram_matches_jax(panel):
    from plink_torch.ops.ld import ld_gram_pair, pair_stats_from_gram
    from plink_tpu.ops.ld import pair_stats_from_gram as ref_stats

    packed, smask = panel
    ta, sm = _tensors(packed[:30], smask)
    g = ld_gram_pair(ta, _tensors(packed[40:52], smask)[0], sm)
    got, ref = pair_stats_from_gram(g.numpy(), 30, 12), ref_stats(g.numpy(), 30, 12)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], k)


@pytest.mark.parametrize("width,chunk", [(1, None), (5, None), (64, None),
                                         (200, None), (299, None), (20, 48)])
def test_ld_joint_band_matches_jax(panel, width, chunk):
    """The port's LdJointBand equals plink_tpu's as int64 (the nine bands;
    the d = 0 column and the pairs past the end 0), and so do the joint
    counts of a row of pairs; chunk 48 puts 7 chunk pairs in the band."""
    from plink_torch.ops.ld import LdJointBand
    from plink_tpu.ops.ld import LdJointBand as RefJoint

    packed, smask = panel
    ref = RefJoint(packed, smask, width, chunk)
    got = LdJointBand(_tensors(packed, smask)[0], smask, width, chunk)
    assert got.width == ref.width and got.n == ref.n
    for key in LdJointBand.RAW:
        assert got.bands[key].dtype == np.int64
        np.testing.assert_array_equal(got.bands[key], ref.bands[key], key)
    assert got.bands["VV"][:, 1:].any()
    d = np.arange(1, min(width, 40) + 1)
    f = np.full(d.size, 250)
    jg, jr = got.joint_counts(f, d), ref.joint_counts(f, d)
    for k in jr:
        np.testing.assert_array_equal(jg[k], jr[k], k)


def _count_tuples():
    """(nmaj1, nmaj2, known, unknown_hethet, valid) tuples: seeded genotype
    pairs in minor-allele space, k = 0, monomorphic, no samples, and the
    symmetric double-het table of plink_tpu/commands/clump.py:14-19."""
    rng = np.random.default_rng(5)
    out = []

    def add(a, b):
        a, b = np.asarray(a), np.asarray(b)
        dh = (a == 1) & (b == 1)
        out.append((float(a.sum()), float(b.sum()),
                    float((np.minimum(a, b) * ~dh).sum()), float(dh.sum()),
                    float(a.size)))

    for _ in range(300):
        n = int(rng.integers(2, 200))
        p, q, rho = rng.uniform(0.02, 0.5), rng.uniform(0.02, 0.5), rng.uniform(0, 1)
        a = (rng.random(n) < p).astype(int) + (rng.random(n) < p)
        b = np.where(rng.random(n) < rho, np.minimum(a, 2),
                     (rng.random(n) < q).astype(int) + (rng.random(n) < q))
        add(a, b)
    add([0, 1, 2, 2, 0, 1], [0, 0, 2, 2, 1, 1])    # one double het
    add([0, 2, 2, 0], [0, 2, 0, 2])                # k = 0
    add([0, 0, 0, 0], [0, 1, 2, 1])                # monomorphic first
    add([1] * 10 + [1] * 4 + [2] * 4, [1] * 10 + [2] * 4 + [1] * 4)  # symmetric
    add([1] * 6, [1] * 6)                          # double hets only
    out.append((0.0, 0.0, 0.0, 0.0, 0.0))          # no valid samples
    return out


def test_phased_r2_matches_jax():
    """phased_r2 (both lnlike rules) and phased_ld_detail equal plink_tpu's
    bit for bit."""
    from plink_torch.stats import phased_ld as P
    from plink_tpu.stats import phased_ld as J

    def same(x, y):
        return np.array(x, np.float64).tobytes() == np.array(y, np.float64).tobytes()

    tuples = _count_tuples()
    finite = 0
    for t in tuples:
        for rule in (False, True):
            r, ref = P.phased_r2(*t, plink2_lnlike=rule), J.phased_r2(*t, plink2_lnlike=rule)
            assert same(r, ref), (t, rule, r, ref)
        finite += bool(np.isfinite(P.phased_r2(*t)))
        sols, best, exp = P.phased_ld_detail(*t)
        rsols, rbest, rexp = J.phased_ld_detail(*t)
        assert best == rbest and len(sols) == len(rsols), t
        for s, rs in zip(sols, rsols):
            assert s.keys() == rs.keys() and all(same(s[k], rs[k]) for k in s), t
        assert (exp is None) == (rexp is None)
        if exp is not None:
            assert all(same(exp[k], rexp[k]) for k in rexp)
    assert 250 < finite < len(tuples)
    multi = sum(len(P.phased_ld_detail(*t)[0]) > 1 for t in tuples)
    assert multi >= 1  # the symmetric case has several in-range roots

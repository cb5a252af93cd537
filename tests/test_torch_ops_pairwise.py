"""plink_torch's pairwise device functions (K7 king_gram, K8 grm_gram, K5 as
sample_miss_counts) against plink_tpu's on the CPU.

The same numpy-seeded inputs go through the JAX reference (plink_tpu.ops,
on the CPU as its own tests run it) and, through
`pairwise_inputs_from_numpy`, through the port's plain PyTorch versions
(what the kernel wrappers run for CPU tensors): 150 samples padded to three
64-sample tiles (a ragged last tile, padded samples decode as valid
hom-REF), five blocks of 64 variants with variant-mask zeros and a padded
last block.  KING counters, pass masks, pass counts, pair counts and jm are
exact; the KING kinship is bit-identical (the same f64 operations in the
same order); GRM sums within 2e-6 absolute (f32 block products in another
order, carried in f64).
"""

import numpy as np
import pytest
import torch

N, TILE, NB, VB = 150, 64, 5, 64
NPAD = -(-N // TILE) * TILE
TILES = [(r0, c0) for r0 in range(0, NPAD, TILE) for c0 in range(0, r0 + 1, TILE)]
GRM_ATOL = 2e-6


@pytest.fixture(scope="module")
def data():
    from plink_tpu.ops.pairwise import _pack_np, grm_coefs

    rng = np.random.default_rng(17)
    V = NB * VB
    maf = rng.uniform(0.02, 0.5, size=(V, 1))
    codes = ((rng.random((V, N)) < maf).astype(np.uint8)
             + (rng.random((V, N)) < maf))
    codes[rng.random((V, N)) < 0.06] = 3
    codes[:, 7] = 3  # one sample missing everywhere: a zero KING denominator
    packed = _pack_np(codes, NPAD).reshape(NB, VB, NPAD // 4)
    vmask = (rng.random((NB, VB)) < 0.85).astype(np.int8)
    packed[-1, 40:] = 0  # padded variant rows of the last block
    vmask[-1, 40:] = 0
    freqs = rng.uniform(0.0, 1.0, V)
    freqs[:3] = (0.0, 1.0, np.nan)  # zero-variance and unobserved variants
    coef = grm_coefs(freqs, np.zeros(V, bool), vmask.reshape(-1).astype(bool))
    return packed, vmask, coef.reshape(NB, VB, 3)


def _jax(*arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def _port(data):
    from plink_torch.ops.pairwise import pairwise_inputs_from_numpy

    return pairwise_inputs_from_numpy(*data)


@pytest.mark.parametrize("r0,c0", TILES, ids=[f"{r}-{c}" for r, c in TILES])
def test_king_counters_match_jax(data, r0, c0):
    """K7's counters (the `--king-table-subset` mode) equal
    king_counts_from_gram of king_gram_tile's plane Gram exactly."""
    from plink_torch.ops.pairwise import KING_COUNTER_KEYS, king_gram
    from plink_tpu.ops.pairwise import king_counts_from_gram, king_gram_tile

    packed, vmask, _ = data
    g = np.asarray(king_gram_tile(*_jax(packed, vmask), r0, c0, TILE, TILE))
    ref = king_counts_from_gram(g, TILE, TILE)
    got = king_gram(*_port(data)[:2], r0, c0, TILE, TILE, counts=True).numpy()
    for i, key in enumerate(KING_COUNTER_KEYS):
        np.testing.assert_array_equal(got[i], ref[key], err_msg=key)


@pytest.mark.parametrize("thresh", [-np.inf, 0.05], ids=["all", "filter"])
def test_king_stats_match_jax(data, thresh):
    """K7's default outputs equal king_tile_stats on every lower tile: kin
    bit for bit (NaN / -inf included), nsnp / hethet / ibs0, the pass mask
    and the pass count."""
    import jax.numpy as jnp

    from plink_torch.ops.pairwise import king_gram
    from plink_tpu.ops.pairwise import king_gram_tile, king_tile_stats

    packed, vmask, _ = data
    pk, vm = _port(data)[:2]
    total = 0
    for r0, c0 in TILES:
        g = king_gram_tile(*_jax(packed, vmask), r0, c0, TILE, TILE)
        ref = king_tile_stats(g, jnp.int32(r0), jnp.int32(c0), jnp.int32(N),
                              jnp.float64(thresh), TILE, TILE)
        got = king_gram(pk, vm, r0, c0, TILE, TILE, n=N, thresh=thresh)
        kin_ref, kin_got = np.asarray(ref[0]), got[0].numpy()
        assert kin_got.dtype == np.float64
        assert kin_got.tobytes() == kin_ref.tobytes()
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy().reshape(np.shape(b)), np.asarray(b))
        total += int(got[5])
    assert np.isinf(kin_got).any() or total > 0
    if thresh == 0.05:
        assert 0 < total < N * (N - 1) // 2


@pytest.mark.parametrize("fetch32", [False, True], ids=["f64", "fetch32"])
def test_grm_tile_matches_jax(data, fetch32):
    """K8's tile mode against grm_tile: the sums within 2e-6 absolute (f32
    block products carried in f64, or rounded to f32 with fetch32), the
    valid-pair counts exact."""
    from plink_torch.ops.pairwise import grm_gram, sample_miss_counts
    from plink_tpu.ops.pairwise import grm_tile

    packed, vmask, coef = data
    pk, vm, cf = _port(data)
    miss = sample_miss_counts(pk, vm)
    mv = int(vmask.sum())
    for r0, c0 in TILES:
        acc, nm = grm_tile(*_jax(packed, coef, vmask), r0, c0, TILE, TILE, fetch32)
        g_acc, g_nm = grm_gram(pk, cf, vm, miss, mv, r0, c0, TILE, TILE,
                               tile=True, fetch32=fetch32)
        assert g_acc.dtype == (torch.float32 if fetch32 else torch.float64)
        assert float(np.abs(g_acc.numpy() - np.asarray(acc)).max()) <= GRM_ATOL
        np.testing.assert_array_equal(g_nm.numpy(), np.asarray(nm).astype(np.int64))


@pytest.mark.parametrize("jm16", [False, True], ids=["u8", "wide"])
def test_grm_chunk_matches_jax(data, jm16):
    """K8's chunk mode against grm_chunk (jm16 both ways): g within 2e-6
    absolute; the port's f32 valid-pair counts equal Mv - m_i - m_j + jm
    from plink_tpu's jm and missing counts exactly; a 64 x 128 chunk as the
    streaming writer takes them."""
    from plink_torch.ops.pairwise import grm_gram, sample_miss_counts
    from plink_tpu.ops.pairwise import grm_chunk, sample_miss_counts as jmiss

    packed, vmask, coef = data
    pk, vm, cf = _port(data)
    miss = sample_miss_counts(pk, vm)
    mv = int(vmask.sum())
    miss_ref = jmiss(*_jax(packed, vmask))
    m = np.asarray(miss_ref).astype(np.int64)
    c = 2 * TILE
    for r0 in range(0, NPAD, TILE):
        for a0 in sorted({min(a, NPAD - c) for a in range(0, r0 + TILE, c)}):
            g, jm, jmax = grm_chunk(*_jax(packed, coef, vmask), miss_ref,
                                    np.float64(mv), r0, a0, TILE, c, jm16)
            assert int(jmax) > 0
            gg, gnm = grm_gram(pk, cf, vm, miss, mv, r0, a0, TILE, c)
            assert float(np.nanmax(np.abs(gg.numpy() - np.asarray(g)))) <= GRM_ATOL
            assert np.array_equal(np.isnan(gg.numpy()), np.isnan(np.asarray(g)))
            want = (mv - m[r0 : r0 + TILE, None] - m[None, a0 : a0 + c]
                    + np.asarray(jm).astype(np.int64))
            assert gnm.dtype == torch.float32
            np.testing.assert_array_equal(gnm.numpy(), want.astype(np.float32))


def test_sample_miss_counts_matches_jax(data):
    """K5 as sample_miss_counts equals plink_tpu's exactly."""
    from plink_torch.ops.pairwise import sample_miss_counts
    from plink_tpu.ops.pairwise import sample_miss_counts as ref

    packed, vmask, _ = data
    got = sample_miss_counts(*_port(data)[:2])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(*_jax(packed, vmask))))


@pytest.mark.parametrize("name", ["king_counts_from_gram", "king_kinship",
                                  "grm_coefs", "iter_lower_tiles"])
def test_host_helpers_match_jax(data, name):
    """The numpy helpers copied from plink_tpu/ops/pairwise.py give the same
    bytes."""
    import plink_torch.ops.pairwise as P
    import plink_tpu.ops.pairwise as J

    rng = np.random.default_rng(5)
    g = rng.integers(0, 300, size=(3 * 8, 3 * 6))
    if name == "king_counts_from_gram":
        a, b = P.king_counts_from_gram(g, 8, 6), J.king_counts_from_gram(g, 8, 6)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    elif name == "king_kinship":
        cnt = J.king_counts_from_gram(g, 8, 6)
        cnt["hethet"][0, 0] = cnt["het_r_hom_c"][0, 0] = 0
        with np.errstate(divide="ignore", invalid="ignore"):
            assert P.king_kinship(cnt).tobytes() == J.king_kinship(cnt).tobytes()
    elif name == "grm_coefs":
        freqs = np.r_[0.0, 1.0, np.nan, rng.uniform(size=40)]
        hap = rng.random(43) < 0.3
        vm = rng.random(43) < 0.8
        for std in (True, False):
            assert (P.grm_coefs(freqs, hap, vm, std).tobytes()
                    == J.grm_coefs(freqs, hap, vm, std).tobytes())
    else:
        for n, tile in ((150, 64), (2048, 2048), (4100, 2048)):
            assert list(P.iter_lower_tiles(n, tile)) == list(J.iter_lower_tiles(n, tile))


@pytest.mark.parametrize("keep", [None, "mind"], ids=["all", "compacted"])
def test_packed_device_tiling_matches_jax(tmp_path, keep, monkeypatch):
    """PackedDevice.for_pairs pads samples as plink_tpu's PackedDevice does
    (to a multiple of the tile once n > tile) and holds the same bytes and
    variant mask, with every sample and with a compacted sample set."""
    from plink_torch.bench_gen import gen_panel
    from plink_torch.dataset import load_dataset as load_torch
    from plink_torch.ops.pairwise import PackedDevice
    from plink_tpu.dataset import load_dataset as load_jax
    from plink_tpu.ops.pairwise import PackedDevice as JPackedDevice

    prefix = str(tmp_path / "p")
    gen_panel(prefix, 203, 150, miss_rate=0.05, seed=9)
    monkeypatch.setenv("PLINK_TPU_VB", "64")
    monkeypatch.setenv("PLINK_TPU_DEVICES", "1")
    monkeypatch.setenv("PLINK_TORCH_VB", "64")
    monkeypatch.setenv("PLINK_TORCH_TILE", str(TILE))
    dj, dt = load_jax(prefix), load_torch(prefix, torch.device("cpu"))
    smask = None
    if keep == "mind":
        smask = np.random.default_rng(1).random(203) < 0.8
    vmask = np.random.default_rng(2).random(150) < 0.9
    ref = JPackedDevice(dj, vmask, tile=TILE, sample_mask=smask)
    got = PackedDevice.for_pairs(dt, vmask, sample_mask=smask)
    assert (got.n, got.npad, got.tile, got.nblocks, got.vb) == \
        (ref.n, ref.npad, ref.tile, ref.nblocks, ref.vb)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.vmask.numpy(), np.asarray(ref.vmask))

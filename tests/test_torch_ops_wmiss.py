"""plink_torch's weighted joint-missing Gram (K23 wmiss_gram) and the
--distance weights against plink_tpu's on the CPU.

The inputs are those of test_torch_ops_pairwise.py (150 samples padded to
three 64-sample tiles, a ragged last one; five 64-variant blocks with
variant-mask zeros and a padded last block), with a 30% missing rate so
that joint missingness is common.  plink_tpu's `wmiss_gram_tile` runs on
the CPU as its own tests run it, and its five 7-bit limb blocks are
recombined as commands/distance.py:98-103 does (sum_k 2^(7k) block_k); the
weights come from a numpy seed and hold 0, 1, 127, 128, 2^31 and 2^32 - 1
so that every limb is non-zero somewhere.  Every lower tile, the diagonal
ones included, must be equal exactly.  `distance_weights` must give
plink_tpu's int64 weights (captured where its `_pair_counts` hands them to
`weight_limbs`) on frequencies with 0, 1, NaN and masked-out variants.
"""

import numpy as np
import pytest
import torch

N, TILE, NB, VB = 150, 64, 5, 64
NPAD = -(-N // TILE) * TILE
TILES = [(r0, c0) for r0 in range(0, NPAD, TILE) for c0 in range(0, r0 + 1, TILE)]
SPECIAL = (0, 1, 127, 128, 1 << 31, (1 << 32) - 1)


@pytest.fixture(scope="module")
def data():
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(23)
    V = NB * VB
    maf = rng.uniform(0.02, 0.5, size=(V, 1))
    codes = ((rng.random((V, N)) < maf).astype(np.uint8)
             + (rng.random((V, N)) < maf))
    codes[rng.random((V, N)) < 0.3] = 3
    codes[:, 11] = 3  # one sample missing everywhere
    packed = _pack_np(codes, NPAD).reshape(NB, VB, NPAD // 4)
    vmask = (rng.random((NB, VB)) < 0.85).astype(np.int8)
    packed[-1, 40:] = 0  # padded variant rows of the last block
    vmask[-1, 40:] = 0
    w = rng.integers(0, 1 << 32, size=V, dtype=np.int64)
    w[: len(SPECIAL)] = SPECIAL
    w[len(SPECIAL) : 2 * len(SPECIAL)] = SPECIAL
    return packed, vmask, w


def _jax_tile(data, r0, c0):
    import jax.numpy as jnp

    from plink_tpu.ops.pairwise import weight_limbs, wmiss_gram_tile

    packed, vmask, w = data
    wl = jnp.asarray(weight_limbs(w, NB, VB))
    gw = np.asarray(wmiss_gram_tile(jnp.asarray(packed), jnp.asarray(vmask), wl,
                                    r0, c0, TILE, TILE), dtype=np.int64)
    acc = np.zeros((TILE, TILE), np.int64)
    for k in range(5):  # plink_tpu/commands/distance.py:98-103
        acc += (1 << (7 * k)) * gw[k * TILE : (k + 1) * TILE, :]
    return acc


@pytest.mark.parametrize("r0,c0", TILES, ids=[f"{r}-{c}" for r, c in TILES])
def test_wmiss_gram_matches_jax(data, r0, c0):
    from plink_torch.ops.pairwise import pairwise_inputs_from_numpy, wmiss_gram

    packed, vmask, w = data
    pk, vm = pairwise_inputs_from_numpy(packed, vmask)
    got = wmiss_gram(pk, vm, torch.from_numpy(w), r0, c0, TILE, TILE)
    assert got.dtype == torch.int64
    ref = _jax_tile(data, r0, c0)
    # joint missingness is common among the real samples; padding adds 0
    assert (ref[: N - r0, : N - c0] != 0).mean() > 0.5
    assert not ref[N - r0 :].any() and not ref[:, N - c0 :].any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wmiss_gram_exact_past_int32_limbs(data):
    """The diagonal of tile (0, 0) against numpy's int64 sums (Python ints
    where a sum passes 2^63 could not): a sample missing everywhere sums
    every weight of the mask, far past the reference's int32 limb range."""
    from plink_torch.ops.pairwise import pairwise_inputs_from_numpy, wmiss_gram

    packed, vmask, w = data
    pk, vm = pairwise_inputs_from_numpy(packed, vmask)
    got = wmiss_gram(pk, vm, torch.from_numpy(w), 0, 0, TILE, TILE).numpy()
    from plink_tpu.ops.pairwise import _unpack_np

    codes = _unpack_np(packed.reshape(NB * VB, -1))[:, :TILE]
    miss = (codes == 3) & (vmask.reshape(-1) != 0)[:, None]
    want = [sum(int(x) for x in w[miss[:, i]]) for i in range(TILE)]
    assert [int(x) for x in np.diag(got)] == want
    assert want[11] == sum(int(x) for x in w[vmask.reshape(-1) != 0]) > 1 << 38


def test_wmiss_gram_refuses_bad_weights(data):
    from plink_torch.ops.pairwise import pairwise_inputs_from_numpy, wmiss_gram

    packed, vmask, w = data
    pk, vm = pairwise_inputs_from_numpy(packed, vmask)
    with pytest.raises(ValueError, match="weights must be"):
        wmiss_gram(pk, vm, torch.from_numpy(w[:-1]), 0, 0, TILE, TILE)
    with pytest.raises(ValueError, match="weights must be"):
        wmiss_gram(pk, vm, torch.from_numpy(w).to(torch.int32), 0, 0, TILE, TILE)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """A 60 x 90 `--dummy` panel written by plink_tpu."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = tmp_path_factory.mktemp("wmiss")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    subprocess.run([sys.executable, "-m", "plink_tpu.cli", "--dummy", "60", "90",
                    "0.1", "--seed", "5", "--out", str(d / "p"), "--silent"],
                   env=env, cwd=repo, check=True, capture_output=True)
    return str(d / "p")


@pytest.mark.parametrize("case", ["special", "uniform"])
def test_distance_weights_match_plink_tpu(panel, monkeypatch, case):
    """plink_tpu's --distance weights, taken where its `_pair_counts` hands
    them to `weight_limbs`, for a frequency vector with 0, 1, NaN and
    masked-out variants (its own frequencies replaced by it)."""
    import plink_tpu.commands.basic_reports as R
    import plink_tpu.ops.pairwise as P
    from plink_torch.ops.pairwise import distance_weights
    from plink_tpu.commands.distance import _pair_counts
    from plink_tpu.dataset import load_dataset

    ds = load_dataset(panel)
    M = ds.raw_variant_ct
    rng = np.random.default_rng(31 if case == "special" else 37)
    freqs = rng.uniform(0.0, 1.0, M)
    if case == "special":
        freqs[:8] = (0.0, 1.0, np.nan, 0.5, 1e-9, 1.0 - 1e-9, np.nan, 0.0)
    vmask = rng.random(M) < 0.8
    vmask[:8] = True
    seen = []
    real = P.weight_limbs
    monkeypatch.setattr(R, "alt_allele_freqs", lambda ds, founders_only=True: freqs)
    monkeypatch.setattr(P, "weight_limbs",
                        lambda wi, nb, vb: seen.append(wi.copy()) or real(wi, nb, vb))
    _pair_counts(ds, vmask, True, False)
    wi, wsum = distance_weights(freqs, vmask)
    assert wi.dtype == np.int64
    np.testing.assert_array_equal(wi, seen[0])
    assert wsum == int(seen[0].sum()) < 1 << 32
    assert (wi[~vmask] == 0).all()
    if case == "special":
        assert wi[2] == wi[6] == wi[3] and wi[0] == wi[1] == wi[7]

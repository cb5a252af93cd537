"""plink_torch's LD decisions (K11 ld_band_bits, LdBitsBand) and the
--indep-pairwise walk against plink_tpu's on the CPU.

Panels: numpy-seeded codes of 150 samples (a ragged last packed byte, two
padded samples, ten masked out) x 300 variants with 6% missing calls, runs
of copied variants with a few calls changed (high r^2), monomorphic,
all-het, all-missing and single-call variants.  The decision bits and the
three count vectors must equal plink_tpu's exactly, at r^2 thresholds 0.2
and 0.5, at count-window widths and at kb-window widths
(`_max_bp_window_span` of irregular positions).  The native walk must
equal the Python walk, in count and kb windows.
"""

import numpy as np
import pytest
import torch

N, V = 150, 300
NPAD = -(-N // 4) * 4


@pytest.fixture(scope="module")
def panel():
    from plink_tpu.ops.pairwise import _pack_np

    rng = np.random.default_rng(31)
    maf = rng.uniform(0.05, 0.5, size=(V, 1))
    codes = ((rng.random((V, N)) < maf).astype(np.uint8)
             + (rng.random((V, N)) < maf))
    for v0 in range(0, V - 8, 37):  # LD runs: copies with a few calls changed
        for d in range(1, 6):
            codes[v0 + d] = codes[v0]
            flip = rng.random(N) < 0.04 * d
            codes[v0 + d, flip] = rng.integers(0, 3, flip.sum())
    codes[rng.random((V, N)) < 0.06] = 3
    codes[10] = 0           # monomorphic hom-REF
    codes[11] = 2           # monomorphic hom-ALT
    codes[12] = 1           # all het: no homs
    codes[13] = 3           # all missing
    codes[14] = 3
    codes[14, 5] = 2        # a single observed call
    smask = np.zeros(NPAD, np.int8)
    smask[:N] = 1
    smask[rng.choice(N, 10, replace=False)] = 0
    bps = np.cumsum(rng.integers(1, 400, V)).astype(np.int64)
    return _pack_np(codes, NPAD), smask, bps


def _widths(bps):
    from plink_torch.commands.ld import _max_bp_window_span

    return {"ct20": 20, "ct60": 60, "kb": _max_bp_window_span(bps, 5000)}


CASES = [(w, r2) for w in ("ct20", "ct60", "kb") for r2 in (0.2, 0.5)]


@pytest.mark.parametrize("wname,r2t", CASES, ids=[f"{w}-{r}" for w, r in CASES])
def test_band_bits_match_jax_scan(panel, wname, r2t):
    """The plain K11 against _ld_band_bits_scan in 64-variant chunks: the
    bits over every pair (i, i + d), 1 <= d <= w, i + d < n, and the count
    vectors exact; the port's bits are 0 outside that set."""
    import jax.numpy as jnp

    from plink_torch.ops.ld import ld_band_bits, ld_inputs_from_numpy
    from plink_tpu.ops.ld import _ld_band_bits_scan

    packed, smask, bps = panel
    width = _widths(bps)[wname]
    c = max(64, width)
    nc = -(-V // c)
    pr = np.concatenate([packed, np.zeros((nc * c - V, packed.shape[1]), np.uint8)])
    blocks = jnp.asarray(pr.reshape(nc, c, -1))
    nxt = jnp.concatenate([blocks[1:], jnp.zeros_like(blocks[:1])], axis=0)
    ex, nm1, hr1, ha1 = (np.asarray(a) for a in _ld_band_bits_scan(
        blocks, nxt, jnp.asarray(smask), jnp.asarray(r2t, jnp.float64), width))
    ex = ex.reshape(nc * c, width + 1)[:V]
    got = ld_band_bits(*ld_inputs_from_numpy(packed, smask), width, r2t)
    gex = got[0].numpy()
    ii, dd = np.arange(V)[:, None], np.arange(width + 1)[None, :]
    inside = (dd >= 1) & (ii + dd < V)
    np.testing.assert_array_equal(gex[inside], ex[inside])
    assert not gex[~inside].any()
    assert 0 < int(gex.sum()) < int(inside.sum())
    for g, r in zip(got[1:], (nm1, hr1, ha1)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r.reshape(-1)[:V])


@pytest.mark.parametrize("wname,r2t", CASES, ids=[f"{w}-{r}" for w, r in CASES])
def test_ld_bits_band_matches_jax(panel, wname, r2t):
    """The port's LdBitsBand equals plink_tpu's: exceeds, nm1, homref1,
    homalt1 and the clipped width."""
    from plink_torch.ops.ld import LdBitsBand, ld_inputs_from_numpy
    from plink_tpu.ops.ld import LdBitsBand as RefBand

    packed, smask, bps = panel
    width = _widths(bps)[wname]
    ref = RefBand(packed, smask, width, r2t)
    got = LdBitsBand(ld_inputs_from_numpy(packed, smask)[0], smask, width, r2t)
    assert got.width == ref.width and got.n == ref.n
    for key in ("exceeds", "nm1", "homref1", "homalt1"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), key)
    f = np.arange(46, 65)  # offsets 1..19, inside every width
    np.testing.assert_array_equal(got.r2_exceeds_vec(f, 65), ref.r2_exceeds_vec(f, 65))


def test_band_width_clipped_to_subcontig(panel):
    """A width past the subcontig's end is clipped (n - 1), as plink_tpu
    clips it, and a two-variant subcontig has one pair."""
    from plink_torch.ops.ld import LdBitsBand, ld_inputs_from_numpy
    from plink_tpu.ops.ld import LdBitsBand as RefBand

    packed, smask, _ = panel
    for rows in (packed[:2], packed[20:45]):
        ref = RefBand(rows, smask, 500, 0.1)
        got = LdBitsBand(ld_inputs_from_numpy(rows, smask)[0], smask, 500, 0.1)
        assert got.width == ref.width == rows.shape[0] - 1
        np.testing.assert_array_equal(got.exceeds, ref.exceeds)


@pytest.mark.parametrize("mode", ["ct", "kb"])
def test_native_walk_matches_python_walk(panel, mode):
    """The native ld_prune_walk and the Python walk remove the same
    variants from the same decision bits, in count windows with a step and
    in kb windows."""
    from plink_torch.commands.ld import _max_bp_window_span, _walk, _walk_py
    from plink_torch.native import get_lib
    from plink_torch.ops.ld import LdBitsBand, ld_inputs_from_numpy

    if get_lib() is None:
        pytest.skip("no C++ compiler for the native library")
    packed, smask, bps = panel
    if mode == "ct":
        ws, step, width = 60, 7, 60
    else:
        ws, step = 5000, 1
        width = _max_bp_window_span(bps, ws)
    band = LdBitsBand(ld_inputs_from_numpy(packed, smask)[0], smask, width, 0.05)
    mono = (((band.homref1 == 0) & (band.homalt1 == 0))
            | (band.homref1 == band.nm1) | (band.homalt1 == band.nm1))
    majf = np.random.default_rng(4).uniform(0.5, 1.0, V)
    majf[100:110] = 0.75  # ties: the (1 + 2^-44) rule decides
    args = (band, mono, majf, bps, ws, mode == "kb", step)
    native, python = _walk(*args), _walk_py(*args)
    np.testing.assert_array_equal(native, python)
    assert mono[10:15].all() and native[10:15].all()
    assert 10 < int(native.sum()) < V - 10


@pytest.mark.parametrize("name", ["_parse_spec", "_subcontigs", "_max_bp_window_span"])
def test_host_helpers_match_jax(name):
    """The window helpers copied from plink_tpu/commands/ld.py agree."""
    import plink_torch.commands.ld as P
    import plink_tpu.commands.ld as J

    rng = np.random.default_rng(9)
    bps = np.cumsum(rng.integers(1, 3000, 400))
    if name == "_parse_spec":
        for spec in (("50", "5", "0.2"), ("20kb", "0.5"), ("20", "kb", "1", "0.3"),
                     ("0.1kb", "0.02"), ("200", "0.1")):
            assert P._parse_spec(spec) == J._parse_spec(spec)
        for bad in (("50",), ("50", "5", "1.0"), ("20kb", "2", "0.5"), ("5", "9", "0.2")):
            with pytest.raises(ValueError):
                P._parse_spec(bad)
    elif name == "_subcontigs":
        for ws, kb in ((1000, True), (2500, True), (50, False)):
            assert P._subcontigs(bps, ws, kb) == J._subcontigs(bps, ws, kb)
    else:
        for ws in (0, 1000, 5000, 10 ** 7):
            assert P._max_bp_window_span(bps, ws) == J._max_bp_window_span(bps, ws)


def test_subcontig_rows_compacts_founders(tmp_path):
    """The subcontig's rows, sliced from the device-resident copy and
    compacted to the founders on the device, equal plink_tpu's host repack
    (`_repack(_sub_codes(...))`)."""
    from plink_torch.bench_gen import gen_panel
    from plink_torch.commands.ld import _subcontig_rows
    from plink_torch.dataset import load_dataset
    from plink_tpu.commands.ld import _repack, _sub_codes

    prefix = str(tmp_path / "p")
    gen_panel(prefix, 103, 90, miss_rate=0.05, seed=3)
    ds = load_dataset(prefix, torch.device("cpu"))
    host = ds.all_packed()
    sub = np.arange(7, 80)
    for keep in (np.ones(103, bool), np.random.default_rng(2).random(103) < 0.7):
        inc_f = np.flatnonzero(keep)
        npad = -(-inc_f.size // 4) * 4
        want = _repack(_sub_codes(host[sub], 103, inc_f), npad)
        got = _subcontig_rows(ds, sub, inc_f, npad)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)

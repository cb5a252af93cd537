"""The arithmetic of K8 on the tensor cores (csrc/grm_gram.cu), checked on
the CPU in plain torch.

K8 splits each Z = coef[v, code] exactly into three bf16 parts hi + mid +
lo (the leading 8 significant bits of what remains, `hop::split_bf16x3`),
so each product of two parts is exact; it sums hi hi in one f32
accumulator and the other part pairs it takes (ops.pairwise._K8_PRODUCTS:
six of the nine, mid lo, lo mid and lo lo left out) in another, adds the
two into f64 at the end of every ops.pairwise._K8_RUN-variant run, and
counts the pairs missing together as one more product of the 0/1 missing
planes.  The model below sums each run with the CPU's round-to-nearest
matmuls: it checks the regrouping and what the left-out part pairs cost,
not how the tensor cores round as they accumulate (they truncate, which is
why the runs are short; tools/grm_breakdown.py measures that on the card,
and the card tests and chip_smoke hold the kernel itself to f64).  Here:
(a) the split gives back every f32 coefficient exactly; (b) the model at
the kernel's scheme (ops.pairwise's constants, held to the source), and at nine products and other run lengths, against
plink_tpu's grm_chunk and grm_tile on seeded panels of a few hundred
samples (variants off a stage and a run, vmask zeros, row0 != col0): each
entry within TOL_K8 of sqrt(sum Z_i^2 sum Z_j^2) / nm, the counts exact.
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from plink_torch.ops import pairwise as P

TOL_K8 = 2e-6  # chip_smoke.TOL_K8, the same normalisation


def split3(z):
    """z (f32) -> (hi, mid, lo), as `hop::split_bf16x3` forms them: each the
    upper 16 bits of the f32 pattern of what is left."""
    hi = (z.view(torch.int32) & -65536).view(torch.float32)
    r = z - hi
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    return hi, mid, r - mid


FLOATS = st.floats(width=32, allow_nan=False, allow_infinity=False).filter(
    lambda x: x == 0.0 or abs(x) >= 2.0 ** -100)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(FLOATS, min_size=1, max_size=96))
@example([1.0, -1.4142135, 70.71068, -0.014142135, 2.0 ** -100, 0.0, -0.0,
          3.4028234663852886e38, 16777215.0, 0.1])
def test_split_gives_back_every_coefficient(xs):
    """(a) hi + mid + lo == z exactly (in f64) for every f32 with |z| >=
    2^-100 or 0; each part exact in bf16, |mid| < 2^-7 |z|, |lo| < 2^-14
    |z|, and mid, lo of z's sign (or 0)."""
    z = torch.tensor(xs, dtype=torch.float32)
    parts = split3(z)
    assert torch.equal(parts[0].double() + parts[1].double() + parts[2].double(),
                       z.double())
    for p in parts:
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    a = z.double().abs()
    nz = a > 0
    assert bool((parts[1].double().abs()[nz] < 2.0 ** -7 * a[nz]).all())
    assert bool((parts[2].double().abs()[nz] < 2.0 ** -14 * a[nz]).all())
    assert bool((parts[1] * z >= 0).all() and (parts[2] * z >= 0).all())


# part pairs (A part, B part) of each scheme; 0 hi, 1 mid, 2 lo
PAIRS = {6: [(0, 1), (1, 0), (1, 1), (0, 2), (2, 0)],
         9: [(0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, 2), (2, 1), (2, 2)]}


def model(packed, coef, vmask, miss, mv, row0, col0, s, c, products, run,
          tile=False):
    """K8's sums as the kernel groups them: per run of `run` variants, hi hi
    in one f32 sum and the other part pairs in another, their f32 sum added
    into f64; jm as the 0/1 missing planes' product, exact.  Then the chunk
    epilogue (g = f32(acc / nm), nm f32) or the tile one (acc f64, nm
    int32)."""
    flat = packed.reshape(-1, packed.shape[2])
    cf = coef.reshape(-1, 3)
    vm = vmask.reshape(-1) != 0
    V = flat.shape[0]

    def side(a0, w):
        codes = P.unpack_codes(flat[:, a0 // 4 : (a0 + w) // 4]).long()
        z = torch.gather(cf, 1, codes.clamp(max=2))
        z = torch.where(codes == 3, torch.zeros((), dtype=z.dtype), z)
        return split3(z), ((codes == 3) & vm[:, None]).to(torch.int64)

    (rh, rm, rl), mr = side(row0, s)
    (ch, cm, cl), mc = side(col0, c)
    rp, cp = (rh, rm, rl), (ch, cm, cl)
    acc = torch.zeros((s, c), dtype=torch.float64)
    for v0 in range(0, V, run):
        sl = slice(v0, min(V, v0 + run))
        big = rh[sl].t() @ ch[sl]
        small = torch.zeros((s, c), dtype=torch.float32)
        for a, b in PAIRS[products]:
            small += rp[a][sl].t() @ cp[b][sl]
        acc += (big + small).double()
    jm = mr.t() @ mc
    return P._grm_finish(acc, jm, miss, mv, row0, col0, s, c, tile, False)


@pytest.fixture(scope="module")
def panel():
    """300 samples (npad 304) over 3 blocks of 203 variants (609: off a
    128-variant stage and run), 6% missing, vmask zeros,
    plink2's coefficients (zero-variance and unobserved variants too)."""
    from plink_tpu.ops.pairwise import _pack_np, grm_coefs

    rng = np.random.default_rng(23)
    n, nb, vb = 300, 3, 203
    npad = 304
    V = nb * vb
    maf = rng.uniform(0.01, 0.5, size=(V, 1))
    codes = ((rng.random((V, n)) < maf).astype(np.uint8) + (rng.random((V, n)) < maf))
    codes[rng.random((V, n)) < 0.06] = 3
    packed = _pack_np(codes, npad).reshape(nb, vb, npad // 4)
    vmask = (rng.random((nb, vb)) < 0.9).astype(np.int8)
    freqs = maf[:, 0].copy()
    freqs[:2] = (0.0, np.nan)
    coef = grm_coefs(freqs, np.zeros(V, bool), vmask.reshape(-1).astype(bool))
    return packed, vmask, coef.reshape(nb, vb, 3)


def _port(panel):
    pk, vm, cf = P.pairwise_inputs_from_numpy(*panel)
    return pk, vm, cf, P.sample_miss_counts(pk, vm), int(panel[1].sum())


def _scale(pk, cf, row0, col0, s, c):
    """sqrt(sum Z_i^2 sum Z_j^2) in f64 over every variant (Cauchy-Schwarz
    bound on |acc_ij|)."""
    codes = P.unpack_codes(pk.reshape(-1, pk.shape[2])).long()
    z = torch.gather(cf.reshape(-1, 3).double(), 1, codes.clamp(max=2))
    d = torch.where(codes == 3, 0.0, z * z).sum(0)
    return torch.sqrt(d[row0 : row0 + s, None] * d[None, col0 : col0 + c]).clamp(min=1e-30)


# (row0, col0, s, c): the diagonal chunk, row0 != col0 off every CTA
# boundary, the last anchor pulled back inside npad
TILES = [(0, 0, 304, 304), (176, 20, 128, 196), (304 - 132, 304 - 68, 132, 68)]
SCHEMES = [(P._K8_PRODUCTS, P._K8_RUN), (9, P._K8_RUN), (6, 256), (9, 2048)]


@pytest.mark.parametrize("products,run", SCHEMES)
@pytest.mark.parametrize("tile", TILES)
def test_model_matches_grm_chunk(panel, tile, products, run):
    """(b) chunk mode: g within TOL_K8 of sqrt(sum Z_i^2 sum Z_j^2) / nm of
    grm_chunk's; nm = Mv - m_i - m_j + jm exactly."""
    from plink_tpu.ops.pairwise import grm_chunk, sample_miss_counts as jmiss

    packed, vmask, coef = panel
    pk, vm, cf, miss, mv = _port(panel)
    r0, c0, s, c = tile
    miss_ref = jmiss(packed, vmask)
    g, jm, _ = grm_chunk(packed, coef, vmask, miss_ref, np.float64(mv), r0, c0, s, c,
                         True)
    mg, mnm = model(pk, cf, vm, miss, mv, r0, c0, s, c, products, run)
    m = np.asarray(miss_ref).astype(np.int64)
    want = mv - m[r0 : r0 + s, None] - m[None, c0 : c0 + c] + np.asarray(jm).astype(np.int64)
    np.testing.assert_array_equal(mnm.numpy(), want.astype(np.float32))
    scale = _scale(pk, cf, r0, c0, s, c).numpy() / want
    err = np.abs(mg.double().numpy() - np.asarray(g).astype(np.float64)) / scale
    assert np.array_equal(np.isnan(mg.numpy()), np.isnan(np.asarray(g)))
    assert float(np.nanmax(err)) <= TOL_K8


@pytest.mark.parametrize("products,run", SCHEMES[:2])
@pytest.mark.parametrize("tile", TILES)
def test_model_matches_grm_tile(panel, tile, products, run):
    """(b) tile mode: acc within TOL_K8 of sqrt(sum Z_i^2 sum Z_j^2) of
    grm_tile's, nm exact."""
    from plink_tpu.ops.pairwise import grm_tile

    packed, vmask, coef = panel
    pk, vm, cf, miss, mv = _port(panel)
    r0, c0, s, c = tile
    acc, nm = grm_tile(packed, coef, vmask, r0, c0, s, c)
    macc, mnm = model(pk, cf, vm, miss, mv, r0, c0, s, c, products, run, tile=True)
    np.testing.assert_array_equal(mnm.numpy(), np.asarray(nm).astype(np.int64))
    err = np.abs(macc.numpy() - np.asarray(acc)) / _scale(pk, cf, r0, c0, s, c).numpy()
    assert float(err.max()) <= TOL_K8


def test_left_out_pairs_are_small(panel):
    """The three part pairs the six-product scheme leaves out (mid lo, lo
    mid, lo lo) add up to at most 2^-20 sqrt(sum Z_i^2 sum Z_j^2) here
    (each term is below 2^-21 |Z_i Z_j|); ops.pairwise's _K8_PRODUCTS and
    _K8_RUN are the scheme csrc/grm_gram.cu is built with: its wgmma
    products into the two f32 sums a k16 step, and kRun, whole stages."""
    pk, vm, cf, miss, mv = _port(panel)
    s = pk.shape[2] * 4
    g6, _ = model(pk, cf, vm, miss, mv, 0, 0, s, s, 6, P._K8_RUN, tile=True)
    g9, _ = model(pk, cf, vm, miss, mv, 0, 0, s, s, 9, P._K8_RUN, tile=True)
    assert float(((g6 - g9).abs() / _scale(pk, cf, 0, 0, s, s)).max()) <= 2.0 ** -20
    src = open(os.path.join(os.path.dirname(P.__file__), "..", "csrc",
                            "grm_gram.cu")).read()
    body = src[src.index("void step_products("):src.index("#else", src.index(
        "void step_products("))]
    assert len(re.findall(r"wgmma_m64n64k16_bf16_rs\((big|small),", body)) == P._K8_PRODUCTS
    const = dict(re.findall(r"constexpr int (kRun|kKT) = (\d+);", src))
    assert int(const["kRun"]) == P._K8_RUN and P._K8_RUN % int(const["kKT"]) == 0

"""The arithmetic of K19 on the tensor cores (csrc/linear_perm.cu), checked
on the CPU in plain torch.

K19 regroups every term of the permuted X^T y as A_r(v, s) * Z_r(s, b): A_r
the variant's weight of its genotype code (exact in bf16), Z_r the f32
product of the sample's factors (mask Y c_j, mask Y^2, or mask Y c_covj
sscale).  Z_r is split exactly into three bf16 parts (each the leading 8
significant bits of what remains), so each product is exact and only the
f32 accumulation rounds; f32 sums run over at most _PERM_RUN (512)
samples and the runs add in f64.  The model below sums each run in f32
with the CPU's round-to-nearest matmuls: it checks that the regrouping is
exact, not how the tensor cores round as they accumulate (they truncate,
which is why the runs are short; the card tests and chip_smoke hold the
kernel itself to f64).  Here: (a) the split gives back every f32 exactly, (b) the
regrouped sum, written out below, stays within 2e-5 of the sum of |terms|
of the plain version in f64 (the card test's tolerance, test_torch_cuda.TOL)
at its four designs, (c) through K20's plain version it gives plink_tpu's
permutation statistics, (d) the wrapper's bf16 check refuses weights that
are not exact, and (e) every model the permutation paths build passes it.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from plink_torch.ops import glm as G
from plink_torch.ops.planes import unpack_codes

TOL = 2e-5  # test_torch_cuda.TOL: short f32 sums added in f64, normalised
RUN = G._PERM_RUN  # samples per f32 run, as K19 runs them


def split3(z):
    """z (f32) -> (hi, mid, lo): each the leading 8 significant bits of
    what is left (the upper 16 bits of its f32 pattern), as K19's
    `hop::split_bf16x3` forms them."""
    hi = (z.view(torch.int32) & -65536).view(torch.float32)
    r = z - hi
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    return hi, mid, r - mid


def _bf16_exact(t):
    return torch.equal(t.to(torch.bfloat16).to(torch.float32), t)


FLOATS = st.floats(width=32, allow_nan=False, allow_infinity=False).filter(
    lambda x: x == 0.0 or abs(x) >= 2.0 ** -100)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(FLOATS, min_size=1, max_size=64))
@example([3.4028234663852886e38, -3.4028234663852886e38, 2.0 ** -100,
          -(2.0 ** -100) * 1.9999999, 1.0 + 2.0 ** -23, -(2.0 - 2.0 ** -23),
          16777215.0, 0.1, -0.0, 0.0])
def test_split_is_exact(xs):
    """(a) hi + mid + lo == z for every f32 with |z| >= 2^-100 (large,
    tiny, negative, zero), each part exact in bf16."""
    z = torch.tensor(xs, dtype=torch.float32)
    parts = split3(z)
    for p in parts:
        assert _bf16_exact(p)
    total = parts[0].double() + parts[1].double() + parts[2].double()
    assert torch.equal(total, z.double())


def _inputs(n, vb, dc, B, design, seed, maf_lo=0.01, y_mean=1.0):
    """The card test's panel (test_torch_cuda._inputs / _design): codes with
    5% missing calls, c = [1, normal columns], a 0/1 sample mask, the ADD
    weights of either A1 orientation, Y = mask * normal(y_mean, 2)."""
    rng = np.random.default_rng(seed)
    npad = -(-n // 4) * 4
    maf = rng.uniform(maf_lo, 0.5, size=(vb, 1))
    codes = (rng.random((vb, n)) < maf).astype(np.uint8) + (rng.random((vb, n)) < maf)
    codes[rng.random((vb, n)) < 0.05] = 3
    buf = np.zeros((vb, npad), np.uint8)
    buf[:, :n] = codes
    buf = buf.reshape(vb, npad // 4, 4)
    packed = buf[..., 0] | buf[..., 1] << 2 | buf[..., 2] << 4 | buf[..., 3] << 6
    c = np.zeros((npad, dc), np.float32)
    c[:n, 0] = 1.0
    c[:n, 1:] = rng.normal(size=(n, dc - 1))
    mask = np.zeros(npad, np.float32)
    mask[:n] = rng.random(n) < 0.95
    alt = rng.random(vb) < 0.5
    add = np.where(alt[:, None], [1.0, 2.0, 0.0], [-1.0, -2.0, 2.0]).astype(np.float32)
    dom = np.zeros_like(add)
    dom[:, 0] = 1.0
    if design == "p1":
        gw, covj = add[:, None], (0,)
    elif design.startswith("p2"):
        gw, covj = np.stack([add, dom], 1), (0, 0)
    else:  # interaction: ADD and ADD x each non-intercept covariate
        gw, covj = np.stack([add] * dc, 1), tuple(range(dc))
    sscale = (np.where(rng.random(npad) < 0.5, 0.5, 1.0).astype(np.float32)
              if design == "p2_scaled" else None)
    Y = (rng.normal(y_mean, 2.0, size=(npad, B)) * mask[:, None]).astype(np.float32)
    t = torch.from_numpy
    return (t(packed.astype(np.uint8)), t(np.ascontiguousarray(gw)), t(c), t(Y),
            t(mask), covj, None if sscale is None else t(sscale))


def tc_xty(packed, gw, c, Y, mask, covj, sscale):
    """K19's regrouped sums: A_r from the codes (valid plane, or each
    genotype row's per-code weight), Z_r = the f32 factor products split in
    three bf16 parts, the three products of a run of <= RUN samples summed
    in f32, the runs added in f64.  -> xty [vb, dc + P, B], yy [vb, B]."""
    codes = unpack_codes(packed).long()
    dc, P = c.shape[1], gw.shape[1]
    ym = mask[:, None] * Y  # exact: the mask is 0 or 1
    valid = (codes != 3).float()
    w4 = torch.cat([G.perm_code_weights(gw), torch.zeros(gw.shape[0], P, 1)], -1)

    def contract(A, Z):
        parts = split3(Z)
        out = torch.zeros((A.shape[0], Z.shape[1]), dtype=torch.float64)
        for r0 in range(0, Z.shape[0], RUN):
            s = slice(r0, r0 + RUN)
            run = A[:, s] @ parts[0][s] + A[:, s] @ parts[1][s] + A[:, s] @ parts[2][s]
            out += run.double()
        return out

    rows = [contract(valid, c[:, j:j + 1] * ym) for j in range(dc)]
    for p in range(P):
        f = c[:, covj[p]] if covj[p] else torch.ones_like(mask)
        if sscale is not None:
            f = f * sscale
        f = f * mask
        rows.append(contract(torch.gather(w4[:, p], 1, codes), f[:, None] * Y))
    return torch.stack(rows, 1), contract(valid, Y * ym)


@pytest.mark.parametrize("B", [1, 5, 134])
@pytest.mark.parametrize("design", ["p1", "p2", "interaction", "p2_scaled"])
def test_regrouped_sum_matches_plain(design, B):
    """(b) the regrouped sum against the plain version in f64 over 4,099
    samples (nine runs) x 40 variants, dc = 4, each entry normalised by
    the sum of its terms' magnitudes."""
    pk, gw, c, Y, mask, covj, ss = _inputs(4099, 40, 4, B, design, 61)
    xty, yy = tc_xty(pk, gw, c, Y, mask, covj, ss)
    dbl = (lambda t: None if t is None else t.double())
    p_xty, p_yy = G.linear_perm_xty_plain(pk, gw.double(), c.double(), Y.double(),
                                          mask.double(), covj, dbl(ss))
    a_xty, a_yy = G.linear_perm_xty_plain(pk, gw.double().abs(), c.double().abs(),
                                          Y.double().abs(), mask.double(), covj,
                                          dbl(ss))
    assert xty.shape == p_xty.shape and yy.shape == p_yy.shape
    assert float(((xty - p_xty).abs() / a_xty.clamp(min=1e-30)).max()) <= TOL
    assert float(((yy - p_yy).abs() / a_yy.clamp(min=1e-30)).max()) <= TOL


@pytest.mark.parametrize("design", ["additive", "genotypic"])
def test_regrouped_stats_match_jax(design):
    """(c) the regrouped sums through K20's plain version (in f64, as K20
    works) give plink_tpu's linear_perm_scan t (additive) and
    linear_perm_multi_scan joint F (genotypic, q = 2) on a 200 x 64 panel
    with dc = 3 (allele frequencies 0.2-0.5, so that no variant's
    genotypic design is near singular; a centred phenotype: plink_tpu's
    f32 joint F carries an absolute rounding of ~n eps yy / (q sigma^2)),
    within 1e-4 of max(|stat|, 1), NaN at the same places."""
    import jax.numpy as jnp

    from plink_tpu.ops import glm as J

    pk, gw, c, Y, mask, covj, _ = _inputs(
        200, 64, 3, 16, "p1" if design == "additive" else "p2", 62, maf_lo=0.2,
        y_mean=0.0)
    q = 0 if design == "additive" else 2
    xty, yy = tc_xty(pk, gw, c, Y, mask, covj, None)
    (inv, inv0, nm), = G.perm_inverses(pk[None], gw[None], c, mask, covj, q)
    dbl = (lambda t: None if t is None else t.double())
    got = G.linear_perm_stat_plain(inv.double(), xty, yy, nm.double(), 3, q,
                                   dbl(inv0)).numpy()
    args = (jnp.asarray(pk.numpy()[None]), jnp.asarray(gw.numpy()[None]),
            jnp.asarray(c.numpy()), jnp.asarray(Y.numpy()), jnp.asarray(mask.numpy()),
            3, covj)
    ref = np.asarray(J.linear_perm_scan(*args, None) if q == 0
                     else J.linear_perm_multi_scan(*args, q, None))[0]
    assert got.shape == ref.shape == (64, 16)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    assert fin.mean() > 0.9
    assert (np.abs(got - ref)[fin] <= 1e-4 * np.maximum(np.abs(ref[fin]), 1.0)).all()


@pytest.mark.parametrize("bad", [1.0 + 2.0 ** -9, 0.1, float("nan"), float("inf")])
def test_guard_refuses_inexact_weights(bad):
    """(d) a plane weight (or a per-code sum) that is not exact in bf16, or
    not finite, raises; exact ones give the per-code weights."""
    gw = torch.tensor([[[1.0, 2.0, 0.0]], [[-1.0, -2.0, 2.0]]])
    assert torch.equal(G.perm_code_weights(gw),
                       torch.tensor([[[0.0, 1.0, 2.0]], [[2.0, 1.0, 0.0]]]))
    bad_gw = gw.clone()
    bad_gw[1, 0, 1] = bad
    with pytest.raises(ValueError, match="exact in bf16"):
        G.perm_code_weights(bad_gw)
    # exact parts whose per-code sum is not: 256 + 1 needs 9 bits
    with pytest.raises(ValueError, match="exact in bf16"):
        G.perm_code_weights(torch.tensor([[[1.0, 0.0, 256.0]]]))


MODELS = [set(), {"dominant"}, {"recessive"}, {"hetonly"}, {"hethom"},
          {"genotypic"}, {"interaction"}, {"genotypic", "interaction"}]


@pytest.mark.parametrize("mods", MODELS, ids=lambda m: "+".join(sorted(m)) or "additive")
def test_every_perm_model_passes_guard(mods):
    """(e) every predictor `_perm_spec_fn` builds, with A1 = ALT and A1 =
    REF, has plane weights and per-code weights exact in bf16 (small
    integers in [-2, 2])."""
    from plink_torch.commands.glm_perm import _perm_spec_fn

    specs, _ = _perm_spec_fn(mods)(["C1", "C2", "SEX"])
    gw = torch.tensor([[s[0] for s in specs], [s[1] for s in specs]],
                      dtype=torch.float32)  # [2 orientations, P, 3]
    w = G.perm_code_weights(gw)
    assert torch.equal(w, w.round()) and float(w.abs().max()) <= 2.0

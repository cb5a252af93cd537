"""The algebra of K7's int8 plane Grams (plink_torch/csrc/king_gram.cu),
written out in numpy where no kernel runs, against plink_tpu's KING
counters.

K7 writes a tile's 2-bit codes sample-major (king_codes_kernel: a 4 x 4
transpose of 2-bit fields in a register, after two byte permutes), decodes
them with one byte permute per four codes into three int8 planes (H = het,
O = hom, D = hom-ALT - hom-REF; 0 where missing or masked), and forms five
products: hethet = HH, het_r_hom_c = HO, het_c_hom_r = OH, ibs0 = (OO -
DD) / 2, nsnp = HH + HO + OH + OO, homhom = OO - ibs0.  Here the same bit
operations run on numpy uint32 words (CUDA's __byte_perm modelled byte for
byte), with the kernel's plane tables and its padding (tile sides to 128
samples, the variants to 128 per stage, code 3 there), and the counters
must equal plink_tpu's `king_counts_from_gram(king_gram_tile(...))`
exactly, on seeded panels with tile sides off 64, variant counts off 32
and off one stage, masked variants and missing calls.
"""

import numpy as np
import pytest

KS = 128  # variants a stage; also the tile sides' padding
TAB = {"H": 0x00000100, "O": 0x00010001, "D": 0x000100FF}  # king_gram.cu

# (seed, samples, blocks, variants a block, missing rate, masked share,
#  tile row0, col0, s, t)
CASES = [
    (1, 150, 3, 50, 0.05, 0.1, 0, 0, 148, 148),      # V = 150, diagonal
    (2, 203, 2, 70, 0.08, 0.2, 100, 8, 100, 60),      # off-diagonal, ragged
    (3, 90, 1, 20, 0.05, 0.0, 0, 0, 92, 92),          # V = 20 < one k32 step
    (4, 130, 4, 33, 0.30, 0.5, 64, 0, 64, 60),        # heavy missingness
    (5, 120, 2, 97, 0.02, 0.15, 40, 12, 24, 36),      # sides below 64
    (6, 260, 3, 61, 0.10, 0.3, 128, 128, 132, 128),   # a side past 128
]


def _prmt(a, b, sel):
    """CUDA's __byte_perm(a, b, sel) on uint32 arrays: byte k of the result
    is byte (nibble k of sel) of the eight bytes of b:a (selectors 0-7)."""
    pool = a.astype(np.uint64) | (np.asarray(b, np.uint64) << np.uint64(32))
    sel = np.asarray(sel, np.uint64)
    out = np.zeros(np.broadcast(pool, sel).shape, np.uint64)
    for k in range(4):
        idx = (sel >> np.uint64(4 * k)) & np.uint64(7)
        out |= ((pool >> (np.uint64(8) * idx)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def _words16(codes):
    """codes [rows, 16 k] (values 0-3) -> uint32 [rows, k]: code i of a word
    in bits 2i..2i+1 (pgen order)."""
    c = codes.reshape(codes.shape[0], -1, 16).astype(np.uint32)
    return (c << (2 * np.arange(16, dtype=np.uint32))).sum(axis=2, dtype=np.uint32)


def _transpose_pass(codes, length):
    """king_codes_kernel on one side: codes [Vpad, side] (variant-major, the
    side padded to 128 samples) -> bytes [side, Vpad / 4], sample-major, 4
    variants a byte, rows at or past `length` code 3."""
    vpad, side = codes.shape
    w = _words16(codes)  # [Vpad, side / 16]: variant, 16-sample word
    w = w.reshape(vpad // 4, 4, side // 16)  # variant group vg, i, word sg
    out = np.empty((side, vpad // 4), np.uint8)
    for j in range(4):
        sel = j | ((4 + j) << 4)
        x = _prmt(_prmt(w[:, 0], w[:, 1], sel), _prmt(w[:, 2], w[:, 3], sel), 0x5410)
        d = ((x >> 6) ^ x) & 0x00CC00CC
        x ^= d ^ (d << 6)
        d = ((x >> 12) ^ x) & 0x0000F0F0
        x ^= d ^ (d << 12)
        for k in range(4):  # sample 16 sg + 4 j + k of variant group vg
            out[4 * j + k :: 16] = ((x >> (8 * k)) & 0xFF).astype(np.uint8).T
    out[length:] = 0xFF
    return out


def _decode(rows, table):
    """The int8 plane of sample-major code bytes [side, Vpad / 4] through
    hop::code_selectors / hop::code_plane: [side, Vpad] int8."""
    words = rows.view("<u4")  # 16 variants a word
    out = []
    for h in range(2):
        x = _prmt(words, 0, 0x4342 if h else 0x4140)
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        for sel in (x, x >> 16):
            out.append(_prmt(np.full_like(sel, table), 0, sel))
    planes = np.stack(out, axis=-1).astype("<u4")  # word, 4 bytes a quarter
    return planes.view(np.int8).reshape(rows.shape[0], -1)


def _kernel_counters(codes, vmask, row0, col0, s, t):
    """The five products and their counters as K7 forms them, from codes
    [V, npad] and the variant mask [V]."""
    V = codes.shape[0]
    vpad = -(-V // KS) * KS
    c = np.full((vpad, codes.shape[1]), 3, np.uint8)
    c[:V] = np.where(vmask[:, None] != 0, codes, 3)
    sides = []
    for first, length in ((row0, s), (col0, t)):
        side = -(-length // KS) * KS
        blk = np.full((vpad, side), 3, np.uint8)
        blk[:, :length] = c[:, first : first + length]
        t_rows = _transpose_pass(blk, length)
        # the transpose pass = the direct sample-major packing
        direct = (blk.T.reshape(side, vpad // 4, 4).astype(np.uint8)
                  << (2 * np.arange(4, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)
        direct[length:] = 0xFF
        np.testing.assert_array_equal(t_rows, direct)
        sides.append({p: _decode(t_rows, tab).astype(np.int64)[:length]
                      for p, tab in TAB.items()})
    r, q = sides
    hh, ho = r["H"] @ q["H"].T, r["H"] @ q["O"].T
    oh, oo, dd = r["O"] @ q["H"].T, r["O"] @ q["O"].T, r["D"] @ q["D"].T
    assert not ((oo - dd) % 2).any()
    ibs0 = (oo - dd) // 2
    return {"ibs0": ibs0, "hethet": hh, "het_r_hom_c": ho, "het_c_hom_r": oh,
            "homhom": oo - ibs0, "nsnp": hh + ho + oh + oo}


@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
def test_five_products_match_plink_tpu(case):
    """The decoded planes are the plane definitions, and the five-product
    counters equal plink_tpu's plane-Gram counters exactly."""
    import jax.numpy as jnp

    from plink_tpu.ops.pairwise import _pack_np, king_counts_from_gram, king_gram_tile

    seed, n, nb, vb, miss, masked, row0, col0, s, t = case
    rng = np.random.default_rng(seed)
    V = nb * vb
    npad = -(-n // 4) * 4
    maf = rng.uniform(0.02, 0.5, size=(V, 1))
    codes = np.full((V, npad), 0, np.uint8)  # padded samples: hom-REF, as packed
    codes[:, :n] = (rng.random((V, n)) < maf).astype(np.uint8) + (rng.random((V, n)) < maf)
    codes[:, :n][rng.random((V, n)) < miss] = 3
    codes[:, 3] = 3  # a sample missing at every variant
    codes[5] = 3     # a variant missing in every sample
    vmask = (rng.random(V) >= masked).astype(np.int8)
    assert row0 + s <= npad and col0 + t <= npad

    packed = _pack_np(codes, npad).reshape(nb, vb, npad // 4)
    g = np.asarray(king_gram_tile(jnp.asarray(packed), jnp.asarray(vmask.reshape(nb, vb)),
                                  row0, col0, s, t))
    ref = king_counts_from_gram(g, s, t)
    got = _kernel_counters(codes, vmask, row0, col0, s, t)
    for key, want in ref.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)

    # the planes themselves: H = het, O = hom, D = hom-ALT - hom-REF, 0
    # where missing or masked
    c = np.where(vmask[:, None] != 0, codes, 3)[:, row0 : row0 + s].T
    vpad = -(-V // KS) * KS
    rows = _transpose_pass(np.pad(c.T, ((0, vpad - V), (0, -(-s // KS) * KS - s)),
                                  constant_values=3), s)
    dec = {p: _decode(rows, tab)[:s, :V] for p, tab in TAB.items()}
    np.testing.assert_array_equal(dec["H"], (c == 1).astype(np.int8))
    np.testing.assert_array_equal(dec["O"], ((c == 0) | (c == 2)).astype(np.int8))
    np.testing.assert_array_equal(dec["D"], (c == 2).astype(np.int8) - (c == 0))

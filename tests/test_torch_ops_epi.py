"""K24's plain version (plink_torch/ops/epistasis.py) against plink_tpu's
B8 product form, and the vectorized best-partner update of
--fast-epistasis against plink_tpu's per-pair loop.

plink_tpu builds the joint tables inline (commands/epistasis.py:530-542,
613-621): codes decoded on the host, flipped to the A1 orientation, int8
planes [hom A1, het, hom A2] per group, and [3B, S] @ [S, 3M] as a host
int32 matmul or, from M * |group| >= 2^22 on, a device jnp.dot with int32
accumulation.  The test repeats both routes with plink_tpu's own decode
on seeded codes with 5% missing calls, a random A1 orientation a variant,
one and two groups, row blocks of 256 and 96 and a ragged last block; the
port's plain version and its CPU wrappers (split_planes + joint_tables)
must give the same integers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plink_torch.ops.epistasis import (epi_joint_tables_plain, joint_tables,
                                       split_planes)
from plink_tpu.ops.pairwise import _unpack_np


def _panel(n, v, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 3, size=(v, n)).astype(np.uint8)
    codes[rng.random((v, n)) < 0.05] = 3
    buf = np.zeros((v, -(-n // 4) * 4), np.uint8)
    buf[:, :n] = codes
    buf = buf.reshape(v, -1, 4)
    packed = buf[..., 0] | buf[..., 1] << 2 | buf[..., 2] << 4 | buf[..., 3] << 6
    return rng, np.ascontiguousarray(packed)


def _tpu_tables(packed, n, vidx, a1_is_alt, groups, rsel, device):
    """plink_tpu's B8 on one row block (epistasis.py:530-542, 599-622)."""
    sub = _unpack_np(packed)[:, :n][vidx]
    eff = np.where(a1_is_alt[:, None], sub.astype(np.int8), 2 - sub.astype(np.int8))
    tabs = []
    for g in groups:
        cg = eff[:, g]
        p = np.stack([(cg == 2), (cg == 1), (cg == 0)], axis=0).astype(np.int8)
        flat = p.reshape(-1, p.shape[2])
        rows = p[:, rsel].reshape(3 * len(rsel), -1)
        if device:
            j = np.asarray(jnp.dot(jnp.asarray(rows), jnp.asarray(flat).T,
                                   preferred_element_type=jnp.int32))
        else:
            j = rows.astype(np.int32) @ flat.astype(np.int32).T
        t = j.reshape(3, len(rsel), 3, len(vidx)).transpose(1, 3, 0, 2)
        tabs.append(t.reshape(len(rsel), len(vidx), 9).astype(np.int64))
    return np.stack(tabs)


@pytest.mark.parametrize("n,v,m,block,n_groups", [
    (203, 340, 300, 256, 2), (203, 340, 300, 96, 2), (150, 140, 130, 96, 1),
    (97, 70, 64, 256, 1)])
def test_plain_matches_plink_tpu_product(n, v, m, block, n_groups):
    rng, packed = _panel(n, v, n + m)
    vidx = np.sort(rng.choice(v, m, replace=False))
    a1 = rng.random(m) < 0.5
    member = rng.integers(0, 3, size=n)  # 0 case, 1 control, 2 neither
    groups = [np.flatnonzero(member == g) for g in range(n_groups)]
    pk = torch.from_numpy(packed)
    planes = split_planes(pk, vidx, a1, groups)
    for r0 in range(0, m, block):
        rsel = np.arange(r0, min(m, r0 + block))  # the last block is ragged
        want = _tpu_tables(packed, n, vidx, a1, groups, rsel, device=r0 == 0)
        got = epi_joint_tables_plain(pk, vidx, a1, groups, rsel)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(joint_tables(planes, rsel), got)
    rsel = rng.permutation(m)[:block // 2]  # a set-mode block: scattered rows
    want = _tpu_tables(packed, n, vidx, a1, groups, rsel, device=False)
    assert np.array_equal(joint_tables(planes, rsel).numpy(), want)


def test_missing_calls_fall_in_no_plane():
    """A sample missing at every variant adds to no cell; a variant whose
    calls are all missing has an all-zero table row."""
    rng, packed = _panel(64, 20, 3)
    packed[:, 0] |= 0b11  # sample 0 missing everywhere
    packed[7] = 0xFF  # variant 7 all missing
    groups = [np.arange(0, 40), np.arange(40, 64)]
    vidx = np.arange(20)
    a1 = rng.random(20) < 0.5
    t = epi_joint_tables_plain(torch.from_numpy(packed), vidx, a1, groups,
                               np.arange(20)).numpy()
    assert (t[:, 7] == 0).all() and (t[:, :, 7] == 0).all()
    codes = _unpack_np(packed)[:, :64]
    called = codes != 3
    for g, idx in enumerate(groups):
        both = (called[:, None, idx] & called[None, :, idx]).sum(-1)
        assert np.array_equal(t[g].sum(-1), both)


def test_best_pair_update_matches_the_loop():
    """best_pair_update equals plink_tpu's per-pair loop (epistasis.py:
    705-714) on blocks with many tied values, triangular (rows 0..255 of
    300 markers, then rows 256..299) and in set mode (scattered rows)."""
    from plink_torch.commands.epistasis import best_pair_update

    rng = np.random.default_rng(4)
    m = 300
    for triangular in (True, False):
        best = np.zeros(m)
        bid = np.zeros(m, np.int64)
        ref_best = np.zeros(m)
        ref_id = np.zeros(m, np.int64)
        blocks = ([np.arange(0, 256), np.arange(256, m)] if triangular
                  else [np.sort(rng.choice(m, 40, replace=False)) for _ in range(3)])
        for rows in blocks:
            mask = np.zeros((rows.size, m), bool)
            for k, i in enumerate(rows):
                if triangular:
                    mask[k, i + 1 + rng.integers(0, 3):] = True
                else:
                    mask[k] = rng.random(m) < 0.7
                    mask[k, i] = False
            pi, pj = np.nonzero(mask)
            z = rng.integers(0, 4, pi.size).astype(np.float64)  # many ties
            z[rng.random(pi.size) < 0.2] = 0.0
            gi = rows[pi]
            for k in range(pi.size):
                i, jx, v = gi[k], pj[k], z[k]
                if v > ref_best[i]:
                    ref_best[i], ref_id[i] = v, jx
                if triangular and v > ref_best[jx]:
                    ref_best[jx], ref_id[jx] = v, i
            best_pair_update(best, bid, rows, pi, pj, z, triangular)
        assert np.array_equal(best, ref_best) and np.array_equal(bid, ref_id)

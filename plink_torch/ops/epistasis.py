"""The --fast-epistasis joint-genotype tables: kernel K24
(`csrc/epi_counts.cu`, its packing pass `epi_split_planes` and its counting
kernel `epi_joint_counts`) with its plain PyTorch version.

plink_tpu/commands/epistasis.py:596-621 (B8) builds, per case / control
group, int8 split planes [hom A1, het, hom A2] of the kept variants over
the group's samples and takes each row block's 3 x 3 joint tables with one
integer matmul [3B, S] @ [S, 3M] (on the device once M * max |g| >= 2^22,
else on the host).  Here `split_planes` builds the group planes once a run
and `joint_tables` returns one row block's tables, int32 [G, nb, M, 9] with
out[g, i, j, 3 a + b] = #(samples of group g in plane a of row variant
rows[i] and plane b of kept variant j).  CPU tensors take the plain version
(0/1 planes and one matmul per group, plink_tpu's formulation); CUDA
tensors launch K24 for every block, with no host route.  The counts are
exact either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda
from .planes import unpack_codes

# a float32 sum of 0/1 products is exact while it stays below 2^24
_F32_EXACT = 1 << 24


@dataclass
class EpiPlanes:
    """The groups' split planes of the M kept variants.  On the card: K24's
    bit words `words` uint32 [3, wtot, M] (stored as int32), group g's in
    words [wofs[g], wofs[g + 1]), and `wofs` on the device for the kernel.
    On the CPU: `dense`, one 0/1 [3, M, |g|] float tensor a group (float64
    from 2^24 samples on)."""
    m: int
    groups: int
    words: torch.Tensor | None = None
    wofs: torch.Tensor | None = None
    dense: list | None = None


def epi_planes_plain(packed: torch.Tensor, vidx: np.ndarray, a1_is_alt: np.ndarray,
                     groups: list[np.ndarray]) -> EpiPlanes:
    """Plain version of K24's packing pass: the planes [hom A1, het, hom A2]
    (A1 = ALT where a1_is_alt, missing calls in none) of the kept variants
    `vidx` over each group's sample indices, as 0/1 floats."""
    codes = unpack_codes(packed[torch.from_numpy(np.asarray(vidx, np.int64)).to(
        packed.device)])
    a1 = torch.from_numpy(np.asarray(a1_is_alt, bool)).to(packed.device)[:, None]
    hom_alt, hom_ref = codes == 2, codes == 0
    planes = torch.stack([torch.where(a1, hom_alt, hom_ref), codes == 1,
                          torch.where(a1, hom_ref, hom_alt)])
    dense = []
    for g in groups:
        dt = torch.float32 if len(g) < _F32_EXACT else torch.float64
        idx = torch.from_numpy(np.asarray(g, np.int64)).to(packed.device)
        dense.append(planes[:, :, idx].to(dt))
    return EpiPlanes(m=len(vidx), groups=len(groups), dense=dense)


def split_planes(packed: torch.Tensor, vidx: np.ndarray, a1_is_alt: np.ndarray,
                 groups: list[np.ndarray]) -> EpiPlanes:
    """K24's packing pass over the whole packed matrix uint8 [V, NB] (the
    kept variants' raw indices `vidx`, their A1 orientation, each group's
    raw sample indices).  CPU tensors take the plain version; CUDA tensors
    launch `epi_split_planes` once."""
    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("split_planes: packed must be contiguous uint8 [V, NB]")
    if len(vidx) != len(a1_is_alt) or not groups:
        raise ValueError("split_planes: one A1 flag a kept variant, one group or more")
    if len(vidx) and not 0 <= min(vidx) <= max(vidx) < packed.shape[0]:
        raise ValueError("split_planes: a kept variant outside the packed rows")
    if any(len(g) and not 0 <= min(g) <= max(g) < 4 * packed.shape[1] for g in groups):
        raise ValueError("split_planes: a group sample outside the packed columns")
    if packed.device.type == "cpu":
        return epi_planes_plain(packed, vidx, a1_is_alt, groups)
    if packed.device.type != "cuda":
        raise ValueError(f"split_planes: unsupported device {packed.device}")
    dev = packed.device
    m = len(vidx)
    sofs = np.concatenate([[0], np.cumsum([len(g) for g in groups])])
    wofs = np.concatenate([[0], np.cumsum([(len(g) + 31) // 32 for g in groups])])
    wtot = int(wofs[-1])
    meta = torch.from_numpy(np.concatenate([wofs, sofs]).astype(np.int32)).to(dev)
    samples = torch.from_numpy(np.concatenate(groups).astype(np.int32)).to(dev)
    vd = torch.from_numpy(np.asarray(vidx, np.int64)).to(dev)
    a1 = torch.from_numpy(np.asarray(a1_is_alt, np.uint8)).to(dev)
    words = torch.empty((3, wtot, m), dtype=torch.int32, device=dev)
    _cuda.launch("epi_split_planes", packed.data_ptr(), packed.shape[1],
                 vd.data_ptr(), a1.data_ptr(), m, samples.data_ptr(),
                 meta.data_ptr(), len(groups), wtot, words.data_ptr())
    return EpiPlanes(m=m, groups=len(groups), words=words,
                     wofs=meta[: len(groups) + 1].contiguous())


def joint_tables_plain(planes: EpiPlanes, rows: np.ndarray) -> torch.Tensor:
    """Plain version of K24: one matmul a group of the row block's planes by
    every kept variant's, [3 nb, S] @ [S, 3 M] (exact in the planes' float
    type), reshaped pair-major to int32 [G, nb, M, 9]."""
    nb = len(rows)
    out = []
    for p in planes.dense:
        r = torch.from_numpy(np.asarray(rows, np.int64)).to(p.device)
        j = p[:, r].reshape(3 * nb, -1) @ p.reshape(3 * planes.m, -1).t()
        out.append(j.reshape(3, nb, 3, planes.m).permute(1, 3, 0, 2)
                   .reshape(nb, planes.m, 9).to(torch.int32))
    return torch.stack(out)


def joint_tables(planes: EpiPlanes, rows: np.ndarray) -> torch.Tensor:
    """K24: the 3 x 3 joint-genotype tables of row block `rows` (indices
    into the kept variants) against every kept variant, int32 [G, nb, M,
    9].  CPU planes take the plain version; CUDA planes launch
    `epi_joint_counts`."""
    if len(rows) and not 0 <= min(rows) <= max(rows) < planes.m:
        raise ValueError("joint_tables: a row outside the kept variants")
    if planes.dense is not None:
        return joint_tables_plain(planes, rows)
    dev = planes.words.device
    nb = len(rows)
    out = torch.empty((planes.groups, nb, planes.m, 9), dtype=torch.int32, device=dev)
    r = torch.from_numpy(np.asarray(rows, np.int32)).to(dev)
    _cuda.launch("epi_joint_counts", planes.words.data_ptr(), planes.m,
                 planes.words.shape[1], planes.wofs.data_ptr(), planes.groups,
                 r.data_ptr(), nb, out.data_ptr())
    return out


def epi_joint_tables_plain(packed: torch.Tensor, vidx: np.ndarray,
                           a1_is_alt: np.ndarray, groups: list[np.ndarray],
                           rows: np.ndarray) -> torch.Tensor:
    """K24's plain version end to end (the packing pass, then one row
    block's tables), on packed's device: the reference the tests and
    chip_smoke hold `joint_tables(split_planes(...), rows)` to."""
    return joint_tables_plain(epi_planes_plain(packed, vidx, a1_is_alt, groups),
                              rows)

"""Genotype counting: kernel K1 (`csrc/geno_counts.cu`) and its plain version.

Per-variant (hom-REF, het, hom-ALT, missing) counts for up to three sample
masks in one pass over the packed genotypes (plink_tpu/ops/counts.py
`_geno_counts_multimask` / `_geno_counts_scan`).  All counts are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .planes import _unpack_np, unpack_codes


def _np_counts_masked(packed: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Host counts [V, 4] (homref, het, homalt, missing) over mask>0 cols."""
    codes = _unpack_np(packed)
    m = np.asarray(mask) > 0
    cm = codes[:, : m.size][:, m]
    out = np.empty((packed.shape[0], 4), np.int64)
    for c in range(4):
        out[:, c] = (cm == c).sum(axis=1)
    return out


def geno_counts_plain(packed: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: packed uint8 [V, NB], masks f32 [4*NB, G] ->
    int32 [G, V, 4]; hom-REF = |mask| - het - hom-ALT - missing."""
    codes = unpack_codes(packed)
    out = torch.empty((masks.shape[1], packed.shape[0], 4), dtype=torch.int32,
                      device=packed.device)
    for g in range(masks.shape[1]):
        m = masks[:, g] > 0
        cm = codes[:, m]
        het, alt, miss = ((cm == c).sum(dim=1) for c in (1, 2, 3))
        out[g, :, 0] = int(m.sum()) - het - alt - miss
        out[g, :, 1] = het
        out[g, :, 2] = alt
        out[g, :, 3] = miss
    return out


def geno_counts(packed: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """K1: packed uint8 [V, NB], masks f32 [4*NB, G] (0/1, G <= 3) ->
    int32 [G, V, 4].  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("geno_counts: packed must be uint8 [V, NB]")
    V, nb = packed.shape
    if masks.dtype != torch.float32 or masks.dim() != 2 \
            or masks.shape[0] != 4 * nb or not 1 <= masks.shape[1] <= 3:
        raise ValueError("geno_counts: masks must be float32 [4*NB, G<=3]")
    if masks.device != packed.device:
        raise ValueError("geno_counts: packed and masks on different devices")
    if not packed.is_contiguous():
        raise ValueError("geno_counts: packed must be contiguous")
    if packed.device.type == "cpu":
        return geno_counts_plain(packed, masks)
    if packed.device.type != "cuda":
        raise ValueError(f"geno_counts: unsupported device {packed.device}")
    G = masks.shape[1]
    inm = (masks.t() > 0).to(torch.uint8).reshape(G, nb, 4) * 3
    mask2 = (inm[..., 0] | (inm[..., 1] << 2) | (inm[..., 2] << 4)
             | (inm[..., 3] << 6)).contiguous()
    nmask = (masks > 0).sum(dim=0).to(torch.int32)
    out = torch.empty((G, V, 4), dtype=torch.int32, device=packed.device)
    _cuda.launch("geno_counts", packed.data_ptr(), nb, mask2.data_ptr(),
                 nmask.data_ptr(), G, V, out.data_ptr())
    return out


def geno_counts_multimask_all(
    packed: torch.Tensor, sample_ct: int, masks: list[np.ndarray],
    variant_ct: int,
) -> list[np.ndarray]:
    """Counts for the whole dataset from its device-resident packed matrix
    ([M, NB] or the [nb, vb, NB] block view) for up to three sample masks;
    returns per-mask int64 [variant_ct, 4]."""
    flat = packed.reshape(-1, packed.shape[-1])
    mm = np.zeros((((sample_ct + 3) // 4) * 4, len(masks)), np.float32)
    for g, m in enumerate(masks):
        mm[: m.shape[0], g] = m
    out = geno_counts(flat, torch.from_numpy(mm).to(packed.device))
    out = out[:, :variant_ct].cpu().numpy()
    return [out[g].astype(np.int64) for g in range(len(masks))]

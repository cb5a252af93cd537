"""Genotype counting: kernels K1 (`csrc/geno_counts.cu`) and K5
(`csrc/sample_counts.cu`) with their plain versions.

- K1: per-variant (hom-REF, het, hom-ALT, missing) counts for up to three
  sample masks in one pass over the packed genotypes (plink_tpu/ops/counts.py
  `_geno_counts_multimask` / `_geno_counts_scan`, and `_geno_counts_masked`
  as its one-mask case).
- K5: per-sample missing, or (het, hom-ALT, missing), counts over the
  variants of one or two variant masks (`_sample_miss_counts` /
  `_sample_het_hom_counts`).

All counts are exact.  The host-facing functions take either the host
numpy matrix (panels of at most HOST_SMALL_GENOTYPES genotypes, counted in
numpy as plink_tpu does) or the device-resident one (one kernel launch).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .planes import _unpack_np, unpack_codes

# Panels of at most this many genotypes are counted on the host in numpy,
# as plink_tpu does (its HOST_SMALL_GENOTYPES); larger ones on the device.
HOST_SMALL_GENOTYPES = 1 << 22


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


def masked_geno_counts(packed, masks: list[np.ndarray]) -> list[np.ndarray]:
    """Per-variant int64 [V, 4] counts for each of up to three raw-sample
    masks (plink_tpu's GenoCounter / geno_counts): numpy for a host matrix,
    else one K1 launch over the device-resident [V, NB] matrix."""
    npad = packed.shape[1] * 4
    mm = np.zeros((npad, len(masks)), np.float32)
    for g, m in enumerate(masks):
        mm[: m.shape[0], g] = m
    if isinstance(packed, np.ndarray):
        return [_np_counts_masked(packed, mm[:, g]) for g in range(len(masks))]
    out = geno_counts(packed, torch.from_numpy(mm).to(packed.device)).cpu().numpy()
    return [out[g].astype(np.int64) for g in range(len(masks))]


# ---------------------------------------------------------------------------
# K5: per-sample counts
# ---------------------------------------------------------------------------


def sample_counts_plain(packed: torch.Tensor, vmasks: torch.Tensor,
                        het_hom: bool = False) -> torch.Tensor:
    """Plain version of K5: packed uint8 [V, NB], vmasks f32 [V, G] ->
    int32 [G, 4*NB] missing counts, or with `het_hom` [G, 3, 4*NB]
    (het, hom-ALT, missing)."""
    codes = unpack_codes(packed)
    classes = (1, 2, 3) if het_hom else (3,)
    out = torch.empty((vmasks.shape[1], len(classes), codes.shape[1]),
                      dtype=torch.int32, device=packed.device)
    for g in range(vmasks.shape[1]):
        rows = codes[vmasks[:, g] > 0]
        for i, c in enumerate(classes):
            out[g, i] = (rows == c).sum(dim=0)
    return out if het_hom else out[:, 0]


def sample_counts(packed: torch.Tensor, vmasks: torch.Tensor,
                  het_hom: bool = False) -> torch.Tensor:
    """K5: packed uint8 [V, NB], vmasks f32 [V, G] (0/1, G <= 2) -> int32
    [G, 4*NB] per-sample missing counts over the variants of each mask, or
    with `het_hom` [G, 3, 4*NB] (het, hom-ALT, missing).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("sample_counts: packed must be uint8 [V, NB]")
    V, nb = packed.shape
    if vmasks.dtype != torch.float32 or vmasks.dim() != 2 \
            or vmasks.shape[0] != V or not 1 <= vmasks.shape[1] <= 2:
        raise ValueError("sample_counts: vmasks must be float32 [V, G<=2]")
    if vmasks.device != packed.device:
        raise ValueError("sample_counts: packed and vmasks on different devices")
    if not (packed.is_contiguous() and vmasks.is_contiguous()):
        raise ValueError("sample_counts: inputs must be contiguous")
    if packed.device.type == "cpu":
        return sample_counts_plain(packed, vmasks, het_hom)
    if packed.device.type != "cuda":
        raise ValueError(f"sample_counts: unsupported device {packed.device}")
    G = vmasks.shape[1]
    out = torch.zeros((G, 3 if het_hom else 1, 4 * nb), dtype=torch.int32,
                      device=packed.device)
    _cuda.launch("sample_counts", packed.data_ptr(), nb, V, vmasks.data_ptr(),
                 G, int(het_hom), out.data_ptr())
    return out if het_hom else out[:, 0]


def _vmask_tensor(vmasks: list[np.ndarray], device) -> torch.Tensor:
    return torch.from_numpy(np.stack(vmasks, axis=1).astype(np.float32)).to(device)


def sample_missing_counts(packed, sample_ct: int,
                          vmasks: list[np.ndarray]) -> np.ndarray:
    """Per-sample missing-genotype counts over the variants of each variant
    mask: int64 [G, sample_ct].  numpy for a host matrix, else one K5
    launch over the device-resident [V, NB] matrix."""
    if isinstance(packed, np.ndarray):
        miss = _unpack_np(packed) == 3
        return np.stack([(miss & (np.asarray(vm)[:, None] > 0)).sum(axis=0)
                         [:sample_ct].astype(np.int64) for vm in vmasks])
    out = sample_counts(packed, _vmask_tensor(vmasks, packed.device))
    return out[:, :sample_ct].cpu().numpy().astype(np.int64)


def sample_het_hom_counts(packed: torch.Tensor, sample_ct: int,
                          vmask: np.ndarray) -> np.ndarray:
    """Per-sample [3, sample_ct] (het, hom-ALT, missing) int64 counts over
    the variants of `vmask`, from the device-resident [V, NB] matrix."""
    out = sample_counts(packed, _vmask_tensor([vmask], packed.device),
                        het_hom=True)
    return out[0, :, :sample_ct].cpu().numpy().astype(np.int64)

"""Genotype plane decode: host helpers and the plain PyTorch decode.

Genotypes travel host->device as 2-bit-packed uint8 ([V, ceil(N/4)], pgen
encoding 0=hom-REF 1=het 2=hom-ALT 3=missing, sample 4b+k in bits 2k..2k+1
of byte b).  The CUDA kernels decode inside their own loops; `unpack_codes`
is the plain version their reference implementations use.
"""

from __future__ import annotations

import numpy as np
import torch


def _unpack_np(packed: np.ndarray) -> np.ndarray:
    """uint8 [V, NB] -> code matrix [V, NB*4] on host."""
    v, nb = packed.shape
    out = np.empty((v, nb, 4), dtype=np.uint8)
    for k in range(4):
        out[:, :, k] = (packed >> (2 * k)) & 3
    return out.reshape(v, nb * 4)


def _pack_np(codes: np.ndarray, npad: int) -> np.ndarray:
    """code matrix [V, n] -> packed uint8 [V, npad/4] on host."""
    v, n = codes.shape
    buf = np.zeros((v, npad), dtype=np.uint8)
    buf[:, :n] = codes
    buf = buf.reshape(v, npad // 4, 4)
    return (
        buf[:, :, 0] | (buf[:, :, 1] << 2) | (buf[:, :, 2] << 4) | (buf[:, :, 3] << 6)
    ).astype(np.uint8)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., NB] -> uint8 codes [..., NB*4]; padding samples decode to
    0 (hom-REF) and are masked by the caller."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed.unsqueeze(-1) >> shifts) & 3
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def planes(packed: torch.Tensor, mask: torch.Tensor):
    """packed [vb, NB], mask [npad] -> (valid, het, homalt) [vb, npad] in the
    mask's float type, with valid = nonmissing * mask and the other two
    multiplied by valid (plink_tpu/ops/glm.py _plane_cols)."""
    codes = unpack_codes(packed)
    valid = (codes != 3).to(mask.dtype) * mask[None, :]
    het = (codes == 1).to(mask.dtype) * valid
    homalt = (codes == 2).to(mask.dtype) * valid
    return valid, het, homalt

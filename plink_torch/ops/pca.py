"""Streaming randomized-PCA operators: kernels K9 `pca_x` (X q) and K10
`pca_xt` (X^T b), `csrc/pca_apply.cu`, with their plain PyTorch versions.

The standardised genotype matrix X [M, n] (plink_tpu/ops/pca.py
`_normed_block`: Z[v, i] = coef[v, class of the call] * smask[i], 0 for a
missing call; excluded and padded variants have coef 0) never exists on the
card: both kernels decode the packed codes on the way into shared memory.
Inputs, as plink_tpu's functions take them: packed uint8 [nb, vb, NB], coef
f32 [nb, vb, 3], smask f32 [npad], q f32 [npad, L] or b f32 [nb, vb, L].

Numerics follow JAX's HIGHEST contract (full f32 products, no TF32): each
f32 accumulator sums at most 2,048 terms and the runs are added in f64, in
a fixed order, so two card runs give identical bytes.  The wrappers run the
plain version for CPU tensors and launch the kernels for CUDA tensors (or
raise).  plink_tpu's mesh dispatchers (`*_any`) belong to the multi-GPU
work and are not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .planes import unpack_codes

RUN = 2048  # terms per f32 accumulator in the kernels


def pca_inputs_from_numpy(packed: np.ndarray, coef: np.ndarray,
                          smask: np.ndarray, q_or_b: np.ndarray,
                          device="cpu") -> tuple:
    """plink_tpu's numpy operands (packed uint8 [nb, vb, NB], coef f32
    [nb, vb, 3], smask f32 [npad], q [npad, L] or b [nb, vb, L] f32) as this
    port's tensors on `device`."""
    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return (t(packed, np.uint8), t(coef, np.float32), t(smask, np.float32),
            t(q_or_b, np.float32))


def _normed_block(pk: torch.Tensor, cf: torch.Tensor, smask: torch.Tensor) -> torch.Tensor:
    """Plain decode: packed [vb, NB] uint8 + coef [vb, 3] + sample mask
    [npad] -> standardised dosages [vb, npad] in coef's type (missing -> 0)."""
    codes = unpack_codes(pk).long()
    z = torch.gather(cf, 1, codes.clamp(max=2))
    z = torch.where(codes == 3, torch.zeros((), dtype=z.dtype, device=z.device), z)
    return z * smask.to(z.dtype)[None, :]


def x_apply_plain(packed, coef, smask, q):
    """Plain version of K9 over every block: [nb, vb, L] in q's type."""
    return torch.stack([_normed_block(packed[b], coef[b], smask).to(q.dtype) @ q
                        for b in range(packed.shape[0])])


def xt_apply_plain(packed, coef, smask, b):
    """Plain version of K10 over every block: [npad, L] in b's type."""
    acc = torch.zeros((packed.shape[2] * 4, b.shape[2]), dtype=b.dtype,
                      device=b.device)
    for k in range(packed.shape[0]):
        acc += _normed_block(packed[k], coef[k], smask).to(b.dtype).t() @ b[k]
    return acc


def xtx_apply_plain(packed, coef, smask, q):
    """Plain (X^T X) q: X q then X^T of it, block by block, in q's type."""
    acc = torch.zeros_like(q)
    for k in range(packed.shape[0]):
        z = _normed_block(packed[k], coef[k], smask).to(q.dtype)
        acc += z.t() @ (z @ q)
    return acc


def _check(name: str, packed, coef, smask, vec, per_block: bool) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 3 or not packed.is_contiguous():
        raise ValueError(f"{name}: packed must be contiguous uint8 [nb, vb, NB]")
    nb, vb, nbytes = packed.shape
    if coef.dtype not in (torch.float32, torch.float64) or not coef.is_contiguous() \
            or tuple(coef.shape) != (nb, vb, 3):
        raise ValueError(f"{name}: coef must be contiguous float [nb, vb, 3]")
    if smask.dim() != 1 or smask.shape[0] != 4 * nbytes or not smask.is_contiguous():
        raise ValueError(f"{name}: smask must be contiguous [npad = 4 * NB]")
    want = (nb, vb) if per_block else (4 * nbytes,)
    if vec.dim() != len(want) + 1 or tuple(vec.shape[:-1]) != want \
            or not vec.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous {list(want) + ['L']}")
    if any(x.device != packed.device for x in (coef, smask, vec)):
        raise ValueError(f"{name}: inputs on different devices")
    if packed.device.type == "cuda" and not all(
            x.dtype == torch.float32 for x in (coef, smask, vec)):
        raise ValueError(f"{name}: the kernel takes float32 coef, smask and operand")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {packed.device}")


def _launch_x(packed, coef, smask, q, k: int, part, out) -> None:
    """K9 on block k: out [vb, L] = Z_k q."""
    _cuda.launch("pca_x", packed[k].data_ptr(), packed.shape[2], packed.shape[1],
                 coef[k].data_ptr(), smask.data_ptr(), smask.shape[0],
                 q.data_ptr(), q.shape[1], part.data_ptr(), out.data_ptr())


def _launch_xt(packed, coef, smask, b, k: int, acc) -> None:
    """K10 on block k: acc [npad, L] f64 += Z_k^T b."""
    _cuda.launch("pca_xt", packed[k].data_ptr(), packed.shape[2], packed.shape[1],
                 coef[k].data_ptr(), smask.data_ptr(), smask.shape[0],
                 b.data_ptr(), b.shape[1], acc.data_ptr())


def _x_scratch(packed, L: int) -> torch.Tensor:
    """K9's per-split f32 partial sums [ceil(npad / RUN), vb, L]."""
    splits = -(-packed.shape[2] * 4 // RUN)
    return torch.empty((splits, packed.shape[1], L), dtype=torch.float32,
                       device=packed.device)


def x_apply(packed, coef, smask, q):
    """K9: X q streamed, one launch per block -> [nb, vb, L] f32 (the caller
    trims the variant pad).  CPU tensors take the plain version."""
    _check("x_apply", packed, coef, smask, q, per_block=False)
    if packed.device.type == "cpu":
        return x_apply_plain(packed, coef, smask, q)
    out = torch.empty((*packed.shape[:2], q.shape[1]), dtype=torch.float32,
                      device=packed.device)
    part = _x_scratch(packed, q.shape[1])
    for k in range(packed.shape[0]):
        _launch_x(packed, coef, smask, q, k, part, out[k])
    return out


def xt_apply(packed, coef, smask, b):
    """K10: X^T b streamed, one launch per block in block order, the blocks'
    sums carried in f64 -> [npad, L] f32.  CPU tensors take the plain
    version."""
    _check("xt_apply", packed, coef, smask, b, per_block=True)
    if packed.device.type == "cpu":
        return xt_apply_plain(packed, coef, smask, b)
    acc = torch.zeros((smask.shape[0], b.shape[2]), dtype=torch.float64,
                      device=packed.device)
    for k in range(packed.shape[0]):
        _launch_xt(packed, coef, smask, b[k], k, acc)
    return acc.float()


def xtx_apply(packed, coef, smask, q):
    """(X^T X) q streamed: per block, K9 (t = Z_k q, f32) then K10 (acc +=
    Z_k^T t, carried in f64) -> [npad, L] f32.  CPU tensors take the plain
    version."""
    _check("xtx_apply", packed, coef, smask, q, per_block=False)
    if packed.device.type == "cpu":
        return xtx_apply_plain(packed, coef, smask, q)
    L = q.shape[1]
    t = torch.empty((packed.shape[1], L), dtype=torch.float32, device=packed.device)
    part = _x_scratch(packed, L)
    acc = torch.zeros((smask.shape[0], L), dtype=torch.float64, device=packed.device)
    for k in range(packed.shape[0]):
        _launch_x(packed, coef, smask, q, k, part, t)
        _launch_xt(packed, coef, smask, t, k, acc)
    return acc.float()

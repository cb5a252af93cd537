"""Genotype counting: kernels K1 (`csrc/geno_counts.cu`), K5
(`csrc/sample_counts.cu`) and K21 / K22 (`csrc/plane_weighted.cu`) with
their plain versions.

- K1: per-variant (hom-REF, het, hom-ALT, missing) counts for up to three
  sample masks in one pass over the packed genotypes (plink_tpu/ops/counts.py
  `_geno_counts_multimask` / `_geno_counts_scan`, and `_geno_counts_masked`
  as its one-mask case).
- K5: per-sample missing, or (het, hom-ALT, missing), counts over the
  variants of one or two variant masks (`_sample_miss_counts` /
  `_sample_het_hom_counts`).
- K21 / K22: per-sample and per-variant weighted sums of the genotype
  planes for K weight sets in one launch (`_sample_plane_weighted` /
  `_variant_plane_weighted`), in f64 or f32; --het, --check-sex,
  --score, --sample-counts and --variant-score call them.

K1 / K5 counts are exact.  Their host-facing functions take either the host
numpy matrix (panels of at most HOST_SMALL_GENOTYPES genotypes, counted in
numpy as plink_tpu does) or the device-resident one (one kernel launch);
K21 / K22's take the device-resident one.
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


# A packed byte's four 2-bit codes as (het, hom-ALT, missing) counts in
# 21-bit fields of one int64: summing a row of bytes sums each field, and a
# row of fewer than 2^21 samples cannot carry into the next field.
_FIELD_BITS = 21
_BYTE_FIELDS = np.array([sum(1 << (_FIELD_BITS * (((b >> (2 * k)) & 3) - 1))
                             for k in range(4) if (b >> (2 * k)) & 3)
                         for b in range(256)], np.int64)


def geno_counts_plain(packed: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: packed uint8 [V, NB], masks f32 [4*NB, G] ->
    int32 [G, V, 4]; hom-REF = |mask| - het - hom-ALT - missing.  Bytes
    whose four samples are all in the mask are counted whole through a
    256-entry table; the samples of the other bytes the mask touches are
    decoded one by one."""
    V, nb = packed.shape
    lut = torch.from_numpy(_BYTE_FIELDS).to(packed.device)
    field = (1 << _FIELD_BITS) - 1
    step = max(1, (1 << 25) // max(nb, 1))  # rows a pass: ~256 MB of int64
    out = torch.empty((masks.shape[1], V, 4), dtype=torch.int32,
                      device=packed.device)
    for g in range(masks.shape[1]):
        m = masks[:, g] > 0
        m4 = m.reshape(nb, 4)
        full = m4.all(dim=1)
        part = m4.any(dim=1) & ~full
        every = bool(full.all())
        part_m = m4[part].reshape(-1)
        cts = torch.empty((V, 3), dtype=torch.int64, device=packed.device)
        for r0 in range(0, V, step):
            pk = packed[r0:r0 + step]
            f = lut[(pk if every else pk[:, full]).long()].sum(dim=1)
            c = torch.stack([(f >> (_FIELD_BITS * i)) & field for i in range(3)], 1)
            if part_m.any():
                cm = unpack_codes(pk[:, part])[:, part_m]
                c += torch.stack([(cm == k).sum(dim=1) for k in (1, 2, 3)], 1)
            cts[r0:r0 + step] = c
        out[g, :, 1:] = cts.to(torch.int32)
        out[g, :, 0] = int(m.sum()) - cts.sum(dim=1).to(torch.int32)
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
    """Per-variant int64 [V, 4] counts for each raw-sample mask (plink_tpu's
    GenoCounter / geno_counts / geno_counts_multimask): numpy for a host
    matrix, else one K1 launch per three masks over the device-resident
    [V, NB] matrix."""
    npad = packed.shape[1] * 4
    mm = np.zeros((npad, len(masks)), np.float32)
    for g, m in enumerate(masks):
        mm[: m.shape[0], g] = m
    if isinstance(packed, np.ndarray):
        return [_np_counts_masked(packed, mm[:, g]) for g in range(len(masks))]
    out = []
    for g0 in range(0, len(masks), 3):
        cts = geno_counts(packed, torch.from_numpy(
            np.ascontiguousarray(mm[:, g0 : g0 + 3])).to(packed.device))
        out += [c.astype(np.int64) for c in cts.cpu().numpy()]
    return out


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


# ---------------------------------------------------------------------------
# K21 / K22: weighted plane sums
# ---------------------------------------------------------------------------

# elements of one [rows, samples(, K)] temporary of the plain versions
_PLAIN_ELEMS = 1 << 24
# K21 in f32: variants one split sums in f32 before the splits are added in
# f64, so 0/1 selector sums are exact integers at any variant count (as
# plink_tpu's f32 blocks added on the host)
F32_SPLIT_ROWS = 1 << 24


def _planes4(codes: torch.Tensor, dtype) -> tuple:
    """(hom-REF, het, hom-ALT, missing) 0/1 planes of codes, as plink_tpu's
    _sample_plane_weighted forms them."""
    b0 = (codes & 1).to(dtype)
    b1 = ((codes >> 1) & 1).to(dtype)
    miss = b0 * b1
    return 1.0 - b0 - b1 + miss, b0 - miss, b1 - miss, miss


def _spw_splits(V: int, nb: int, f64: bool) -> int:
    """K21's variant splits: ~8 blocks of 256 byte-threads per SM in flight,
    and in f32 at most F32_SPLIT_ROWS variants a split.  The plain version
    takes the same splits, so both sum in one order."""
    splits = max(1, min(-(-V // 64), -(-1056 // max(1, -(-nb // 256)))))
    return splits if f64 else max(splits, -(-V // F32_SPLIT_ROWS))


def sample_plane_weighted_plain(packed: torch.Tensor,
                                wts: torch.Tensor) -> torch.Tensor:
    """Plain version of K21: packed uint8 [V, NB], wts [V, 4, K] (f64 or f32)
    -> float64 [K, 4*NB]: sum over variants and planes of the weight times
    the 0/1 plane, in the kernel's order, so the card and the CPU give the
    same bytes (a report's 6-digit text can sit on an exact decimal tie,
    which the last bit of the sum decides): each sample's sum takes, variant
    by variant in each of K21's splits, the weight of its genotype's plane
    plus 0 x the other three (exactly that weight where they are finite,
    NaN where one is not, as plink_tpu's four products give), in the
    weights' type; the splits are added in f64 in index order."""
    V, nb = packed.shape
    K = wts.shape[2]
    eff = wts.clone()
    for c in range(4):
        for p in range(4):
            if p != c:
                eff[:, c] += 0.0 * wts[:, p]
    splits = _spw_splits(V, nb, wts.dtype == torch.float64)
    rows = -(-V // splits)
    step = max(1, min(rows, _PLAIN_ELEMS // max(4 * nb * K, 1)))
    out = None
    for s0 in range(0, V, rows):
        acc = torch.zeros((4 * nb, K), dtype=wts.dtype, device=packed.device)
        for r0 in range(s0, min(V, s0 + rows), step):
            r1 = min(r0 + step, s0 + rows, V)
            codes = unpack_codes(packed[r0:r1]).long()
            x = torch.gather(eff[r0:r1], 1, codes[:, :, None].expand(-1, -1, K))
            for r in range(r1 - r0):
                acc += x[r]
        part = acc.t().double()
        out = part if out is None else out + part
    return out


def sample_plane_weighted(packed: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """K21: packed uint8 [V, NB], wts [V, 4, K] float64 or float32 (weights
    of the hom-REF, het, hom-ALT and missing planes for K weight sets) ->
    float64 [K, 4*NB] per-sample sums, accumulated in the weights' type (f32
    within splits of at most F32_SPLIT_ROWS variants, added in f64).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("sample_plane_weighted: packed must be uint8 [V, NB]")
    V, nb = packed.shape
    if wts.dtype not in (torch.float64, torch.float32) or wts.dim() != 3 \
            or wts.shape[0] != V or wts.shape[1] != 4 or wts.shape[2] < 1:
        raise ValueError("sample_plane_weighted: wts must be float64/float32 "
                         "[V, 4, K]")
    if wts.device != packed.device:
        raise ValueError("sample_plane_weighted: packed and wts on different "
                         "devices")
    if not (packed.is_contiguous() and wts.is_contiguous()):
        raise ValueError("sample_plane_weighted: inputs must be contiguous")
    if packed.device.type == "cpu":
        return sample_plane_weighted_plain(packed, wts)
    if packed.device.type != "cuda":
        raise ValueError(f"sample_plane_weighted: unsupported device {packed.device}")
    K = wts.shape[2]
    f64 = wts.dtype == torch.float64
    splits = _spw_splits(V, nb, f64)
    out = torch.empty((K, 4 * nb), dtype=torch.float64, device=packed.device)
    part = torch.empty((splits, K, 4 * nb), dtype=wts.dtype,
                       device=packed.device) if splits > 1 or not f64 else None
    _cuda.launch("sample_plane_weighted", packed.data_ptr(), nb, V,
                 wts.data_ptr(), K, int(f64), splits, _cuda.ptr(part),
                 out.data_ptr())
    return out


def variant_plane_weighted_plain(packed: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """Plain version of K22: packed uint8 [V, NB], w [4*NB, K] (f64 or f32)
    -> [V, K, 3] sums of the (het, hom-ALT, valid) planes times the sample
    weights (products, as plink_tpu's dots), chunked over variants."""
    V, nb = packed.shape
    K = w.shape[1]
    out = torch.empty((V, K, 3), dtype=w.dtype, device=packed.device)
    step = max(1, _PLAIN_ELEMS // max(4 * nb * K, 1))
    for r0 in range(0, V, step):
        _, het, alt, miss = _planes4(unpack_codes(packed[r0:r0 + step]), w.dtype)
        for q, plane in enumerate((het, alt, 1.0 - miss)):
            out[r0:r0 + step, :, q] = (plane[:, :, None] * w[None]).sum(dim=1)
    return out


def variant_plane_weighted(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K22: packed uint8 [V, NB], w [4*NB, K] float64 or float32 sample
    weights (0 on pad samples) -> [V, K, 3] per-variant sums over the het,
    hom-ALT and valid planes, in the weights' type.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("variant_plane_weighted: packed must be uint8 [V, NB]")
    V, nb = packed.shape
    if w.dtype not in (torch.float64, torch.float32) or w.dim() != 2 \
            or w.shape[0] != 4 * nb or w.shape[1] < 1:
        raise ValueError("variant_plane_weighted: w must be float64/float32 "
                         "[4*NB, K]")
    if w.device != packed.device:
        raise ValueError("variant_plane_weighted: packed and w on different "
                         "devices")
    if not (packed.is_contiguous() and w.is_contiguous()):
        raise ValueError("variant_plane_weighted: inputs must be contiguous")
    if packed.device.type == "cpu":
        return variant_plane_weighted_plain(packed, w)
    if packed.device.type != "cuda":
        raise ValueError(f"variant_plane_weighted: unsupported device {packed.device}")
    K = w.shape[1]
    wt = w.t().contiguous()  # [K, 4*NB]: a lane's four samples in one vector load
    # sample splits so that ~8 blocks of 8 warps per SM are in flight
    splits = max(1, min(-(-nb // 1024), -(-1056 // max(1, -(-V // 32)))))
    out = torch.empty((V, K, 3), dtype=w.dtype, device=packed.device)
    part = torch.empty((splits, V, K, 3), dtype=w.dtype,
                       device=packed.device) if splits > 1 else None
    _cuda.launch("variant_plane_weighted", packed.data_ptr(), nb, V, wt.data_ptr(),
                 K, int(w.dtype == torch.float64), splits, _cuda.ptr(part),
                 out.data_ptr())
    return out


def weighted_sample_sums(packed: torch.Tensor, sample_ct: int, wts: np.ndarray,
                         f64: bool = True) -> np.ndarray:
    """Per-sample weighted plane sums over the device-resident [V, NB]
    matrix (plink_tpu's sample_plane_weighted, for K weight sets in one
    K21 launch): wts [V, 4, K] -> float64 [K, sample_ct].  `f64=False`
    rounds the weights to float32 and sums in float32 (within splits of
    F32_SPLIT_ROWS variants, added in float64), as plink_tpu's cast and its
    host sum of the blocks do."""
    w = torch.from_numpy(np.ascontiguousarray(
        wts, dtype=np.float64 if f64 else np.float32))
    out = sample_plane_weighted(packed, w.to(packed.device))
    return out[:, :sample_ct].cpu().numpy()


def weighted_variant_sums(packed: torch.Tensor, sample_ct: int, w: np.ndarray,
                          f64: bool = True) -> np.ndarray:
    """Per-variant (het, hom-ALT, valid) weighted sums over the
    device-resident [V, NB] matrix (plink_tpu's variant_plane_weighted, one
    K22 launch): w [sample_ct, K] sample weights -> float64 [V, K, 3]."""
    wpad = np.zeros((packed.shape[1] * 4, w.shape[1]),
                    dtype=np.float64 if f64 else np.float32)
    wpad[:sample_ct] = w
    out = variant_plane_weighted(packed, torch.from_numpy(wpad).to(packed.device))
    return out.cpu().numpy().astype(np.float64)

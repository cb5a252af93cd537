"""Host-side 2-bit genotype packing utilities (numpy).

Internal genotype code convention follows the pgen main data track
(pgen_spec.tex:431-436): 0 = homozygous REF, 1 = het REF-ALT, 2 = double ALT,
3 = missing.  PLINK1 .bed uses a different 2-bit encoding (0 = hom A1/ALT,
1 = missing, 2 = het, 3 = hom A2/REF; pgen_spec.tex:429-433); translation
tables below convert packed bytes in one vectorized gather.
"""

from __future__ import annotations

import numpy as np

# Map each 2-bit bed code to pgen code: bed 0->2, 1->3, 2->1, 3->0.
_BED2PGEN_2BIT = np.array([2, 3, 1, 0], dtype=np.uint8)
_PGEN2BED_2BIT = np.array([3, 2, 0, 1], dtype=np.uint8)


def _byte_translation_table(code_map: np.ndarray) -> np.ndarray:
    """Build a 256-entry table translating all four 2-bit fields of a byte."""
    b = np.arange(256, dtype=np.uint16)
    out = np.zeros(256, dtype=np.uint16)
    for shift in (0, 2, 4, 6):
        out |= code_map[(b >> shift) & 3].astype(np.uint16) << shift
    return out.astype(np.uint8)


BED2PGEN_BYTE = _byte_translation_table(_BED2PGEN_2BIT)
PGEN2BED_BYTE = _byte_translation_table(_PGEN2BED_2BIT)

# Per-byte genotype-category count tables: _COUNT_TABLE[cat][byte] = number of
# 2-bit fields in `byte` equal to cat.  Used for host-side counting fallbacks.
_COUNT_TABLE = np.zeros((4, 256), dtype=np.uint8)
for _cat in range(4):
    _b = np.arange(256)
    _c = np.zeros(256, dtype=np.uint8)
    for _shift in (0, 2, 4, 6):
        _c += ((_b >> _shift) & 3) == _cat
    _COUNT_TABLE[_cat] = _c


def bytes_per_variant(sample_ct: int) -> int:
    return (sample_ct + 3) // 4


def unpack2(packed: np.ndarray, sample_ct: int) -> np.ndarray:
    """[..., ceil(N/4)] uint8 packed -> [..., N] uint8 codes."""
    packed = np.asarray(packed, dtype=np.uint8)
    lead = packed.shape[:-1]
    nb = packed.shape[-1]
    out = np.empty(lead + (nb * 4,), dtype=np.uint8)
    out[..., 0::4] = packed & 3
    out[..., 1::4] = (packed >> 2) & 3
    out[..., 2::4] = (packed >> 4) & 3
    out[..., 3::4] = (packed >> 6) & 3
    return out[..., :sample_ct]


def pack2(codes: np.ndarray) -> np.ndarray:
    """[..., N] uint8 codes -> [..., ceil(N/4)] uint8 packed (zero padded)."""
    codes = np.asarray(codes, dtype=np.uint8)
    lead = codes.shape[:-1]
    n = codes.shape[-1]
    nb = (n + 3) // 4
    padded = np.zeros(lead + (nb * 4,), dtype=np.uint8)
    padded[..., :n] = codes
    return (
        padded[..., 0::4]
        | (padded[..., 1::4] << 2)
        | (padded[..., 2::4] << 4)
        | (padded[..., 3::4] << 6)
    )


def patch_packed_inplace(packed: np.ndarray, sample_ids: np.ndarray, vals: np.ndarray) -> None:
    """Set packed[sample_ids] = vals (2-bit fields), in place, vectorized."""
    if sample_ids.size == 0:
        return
    byte_idx = (sample_ids >> 2).astype(np.int64)
    shift = ((sample_ids & 3) * 2).astype(np.uint8)
    clear_mask = ~(np.uint8(3) << shift)
    set_bits = (vals.astype(np.uint8) << shift).astype(np.uint8)
    # Difflist sample IDs are strictly increasing, but several can share a
    # byte; combine per-byte first to keep this a pure gather/scatter.
    np.bitwise_and.at(packed, byte_idx, clear_mask)
    np.bitwise_or.at(packed, byte_idx, set_bits)


def invert_packed(packed: np.ndarray) -> np.ndarray:
    """Swap genotype categories 0 and 2 (REF/ALT rotation) on packed bytes."""
    # code ^ 2 maps 0<->2 and 1<->3; we must keep 1 and 3 fixed, so use a table.
    table = _byte_translation_table(np.array([2, 1, 0, 3], dtype=np.uint8))
    return table[packed]


def count_categories_packed(packed: np.ndarray, sample_ct: int) -> np.ndarray:
    """Per-variant genotype category counts from packed rows. [V, nb] -> [V, 4]."""
    packed = np.atleast_2d(packed)
    nb = bytes_per_variant(sample_ct)
    tail = sample_ct & 3
    counts = np.empty((packed.shape[0], 4), dtype=np.int64)
    body = packed[:, : nb - 1] if tail else packed[:, :nb]
    for cat in range(4):
        counts[:, cat] = _COUNT_TABLE[cat][body].sum(axis=1, dtype=np.int64)
    if tail:
        last = unpack2(packed[:, nb - 1 : nb], 4)[:, :tail]
        for cat in range(4):
            counts[:, cat] += (last == cat).sum(axis=1)
    return counts

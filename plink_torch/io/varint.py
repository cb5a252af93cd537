"""Vectorized base-128 varint and pgen difflist codecs.

The .pgen format (reference: pgen_spec.tex:354-421)
stores sparse genotype updates as "difflists": a varint element count, group
leader sample IDs at fixed width, per-group byte sizes, an optional packed
2-bit genotype array, and a stream of varint-encoded sample-ID deltas.

The reference decodes these with scalar C++ (2.0/include/pgenlib_misc.cc,
ParseDifflistHeader / ParseAndApplyDifflist).  Here the varint stream is
decoded with numpy array operations: terminator bytes (high bit clear) mark
varint boundaries, and each varint's digits are combined with a segmented
shift-accumulate.  A C++ fast path can replace this later; the numpy path is
the reference implementation used by tests.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_U64 = np.uint64


def decode_varints(buf: np.ndarray, count: int, offset: int = 0) -> tuple[np.ndarray, int]:
    """Decode `count` base-128 varints from uint8 array `buf` starting at `offset`.

    Returns (values as uint32 array of length count, end offset).
    """
    if count == 0:
        return np.empty(0, dtype=_U32), offset
    # A uint32 varint spans at most 5 bytes, so never scan further than that
    # (buf may be a whole multi-variant record block)
    data = buf[offset : offset + 5 * count]
    # Find terminator bytes (high bit clear). Each varint ends at one.
    is_term = (data & 0x80) == 0
    term_idx = np.flatnonzero(is_term)
    if term_idx.size < count:
        raise ValueError("varint stream truncated")
    term_idx = term_idx[:count]
    end = int(term_idx[-1]) + 1
    data = data[:end]
    # Start index of each varint.
    starts = np.empty(count, dtype=np.int64)
    starts[0] = 0
    starts[1:] = term_idx[:-1] + 1
    lengths = term_idx - starts + 1
    maxlen = int(lengths.max())
    if maxlen > 5:
        raise ValueError("varint longer than 5 bytes (uint32 overflow)")
    # Gather digits into a (count, maxlen) matrix, padding with zeros.
    gather = starts[:, None] + np.arange(maxlen, dtype=np.int64)[None, :]
    valid = np.arange(maxlen, dtype=np.int64)[None, :] < lengths[:, None]
    digits = np.where(valid, data[np.minimum(gather, end - 1)], 0).astype(_U32)
    digits &= 0x7F
    vals = np.zeros(count, dtype=_U32)
    for k in range(maxlen):
        vals |= digits[:, k] << _U32(7 * k)
    return vals, offset + end


def encode_varints(vals: np.ndarray) -> bytes:
    """Encode an array of nonnegative ints as base-128 varints."""
    vals = np.asarray(vals, dtype=np.uint64)
    if vals.size == 0:
        return b""
    # Number of 7-bit digits per value (at least 1).
    nbits = np.zeros(vals.shape, dtype=np.int64)
    tmp = vals.copy()
    while True:
        nz = tmp > 0
        if not nz.any():
            break
        nbits[nz] += 1
        tmp >>= np.uint64(7)
    nbits = np.maximum(nbits, 1)
    total = int(nbits.sum())
    out = np.empty(total, dtype=np.uint8)
    ends = np.cumsum(nbits)
    starts = ends - nbits
    maxlen = int(nbits.max())
    shifted = vals.copy()
    for k in range(maxlen):
        active = nbits > k
        idx = starts[active] + k
        digit = (shifted[active] & np.uint64(0x7F)).astype(np.uint8)
        is_last = nbits[active] == (k + 1)
        out[idx] = np.where(is_last, digit, digit | 0x80)
        shifted >>= np.uint64(7)
    return out.tobytes()


def encode_varint(val: int) -> bytes:
    out = bytearray()
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: np.ndarray, offset: int) -> tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = int(buf[offset])
        offset += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, offset
        shift += 7


def _sample_id_width(sample_ct: int) -> int:
    """Byte width of group-leader sample IDs (pgen_spec.tex:376-379)."""
    if sample_ct <= (1 << 8):
        return 1
    if sample_ct <= (1 << 16):
        return 2
    if sample_ct <= (1 << 24):
        return 3
    return 4


def _read_fixed_width_ints(buf: np.ndarray, offset: int, count: int, width: int) -> tuple[np.ndarray, int]:
    nbytes = count * width
    raw = buf[offset : offset + nbytes]
    if raw.size < nbytes:
        raise ValueError("difflist truncated")
    if width == 1:
        vals = raw.astype(_U32)
    elif width == 2:
        vals = raw.view("<u2").astype(_U32)
    elif width == 3:
        m = raw.reshape(count, 3).astype(_U32)
        vals = m[:, 0] | (m[:, 1] << _U32(8)) | (m[:, 2] << _U32(16))
    else:
        vals = raw.view("<u4").astype(_U32)
    return vals, offset + nbytes


def decode_difflist(
    buf: np.ndarray, offset: int, sample_ct: int, has_genotypes: bool
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Decode one difflist (pgen_spec.tex:354-421).

    Returns (sample_ids uint32[L], genovals uint8[L] or None, end offset).
    """
    L, offset = decode_varint(buf, offset)
    if L == 0:
        return np.empty(0, dtype=_U32), (np.empty(0, dtype=np.uint8) if has_genotypes else None), offset
    G = (L + 63) // 64
    width = _sample_id_width(sample_ct)
    leaders, offset = _read_fixed_width_ints(buf, offset, G, width)
    # G-1 per-group byte sizes of the final (delta varint) component; unused
    # for sequential decode but must be skipped.
    offset += G - 1
    genovals = None
    if has_genotypes:
        gbytes = (L + 3) // 4
        packed = buf[offset : offset + gbytes]
        offset += gbytes
        expanded = np.empty(gbytes * 4, dtype=np.uint8)
        expanded[0::4] = packed & 3
        expanded[1::4] = (packed >> 2) & 3
        expanded[2::4] = (packed >> 4) & 3
        expanded[3::4] = (packed >> 6) & 3
        genovals = expanded[:L]
    # L - G delta varints.
    deltas, offset = decode_varints(buf, L - G, offset)
    sample_ids = np.empty(L, dtype=_U32)
    sample_ids[0::64] = leaders
    if L > G:
        # Positions of the deltas within each group: indices not divisible by 64.
        mask = np.ones(L, dtype=bool)
        mask[0::64] = False
        # cumulative sums within groups: do a full cumsum trick per group.
        vals = np.zeros(L, dtype=np.int64)
        vals[mask] = deltas.astype(np.int64)
        vals[0::64] = leaders.astype(np.int64)
        # segmented cumsum: subtract the running total at each group boundary
        csum = np.cumsum(vals)
        group_start_csum = csum[0::64] - leaders.astype(np.int64)
        sample_ids = (csum - np.repeat(group_start_csum, 64)[:L]).astype(_U32)
    return sample_ids, genovals, offset


def encode_difflist(sample_ids: np.ndarray, genovals: np.ndarray | None, sample_ct: int) -> bytes:
    """Encode a difflist; inverse of decode_difflist."""
    L = int(sample_ids.size)
    out = bytearray(encode_varint(L))
    if L == 0:
        return bytes(out)
    sample_ids = np.asarray(sample_ids, dtype=np.int64)
    G = (L + 63) // 64
    width = _sample_id_width(sample_ct)
    leaders = sample_ids[0::64]
    lead = np.zeros((G, 4), dtype=np.uint8)
    lv = leaders.astype(np.uint64)
    for k in range(4):
        lead[:, k] = (lv >> np.uint64(8 * k)).astype(np.uint8)
    out += lead[:, :width].tobytes()
    # Per-group delta varint payloads.
    mask = np.ones(L, dtype=bool)
    mask[0::64] = False
    deltas = np.diff(sample_ids, prepend=0)[mask]
    payload = encode_varints(deltas)
    # Compute per-group byte sizes of the payload (groups have 63 deltas each,
    # last group L - 64*(G-1) - 1 deltas).
    if G > 1:
        # Exact byte length of each delta varint; full groups have 63 deltas.
        dl = np.ones(deltas.size, dtype=np.int64)
        tmp = deltas >> 7
        while (tmp > 0).any():
            dl[tmp > 0] += 1
            tmp >>= 7
        cs = np.concatenate([[0], np.cumsum(dl)])
        j = np.arange(G - 1)
        per_group = cs[63 * (j + 1)] - cs[63 * j]
        if (per_group < 63).any() or (per_group > 255 + 63).any():
            raise ValueError("difflist group size out of encodable range")
        out += (per_group - 63).astype(np.uint8).tobytes()
    if genovals is not None:
        g = np.asarray(genovals, dtype=np.uint8)
        gbytes = (L + 3) // 4
        padded = np.zeros(gbytes * 4, dtype=np.uint8)
        padded[:L] = g
        packed = padded[0::4] | (padded[1::4] << 2) | (padded[2::4] << 4) | (padded[3::4] << 6)
        out += packed.tobytes()
    out += payload
    return bytes(out)

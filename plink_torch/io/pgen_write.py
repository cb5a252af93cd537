""".pgen writer.

Writes standard mode-0x10 files with per-record compression selection
(dense / 1-bit / difflist / LD-diff), mirroring the behavior of the
reference single-threaded writer (2.0/include/pgenlib_write.{h,cc},
SpgwAppendBiallelicGenovec) without copying its structure: representation
choice is by encoded byte cost, computed from vectorized category counts.

Two-pass layout handling (pgen_spec.tex:108-116): record bodies are written
to the file after a reserved header region sized for the worst-case
length-byte width; the header is backfilled on close.
"""

from __future__ import annotations

import numpy as np

from . import pack
from .pgen_read import MAGIC
from .varint import encode_difflist

_VBLOCK = 1 << 16


def _choose_onebit_pair(counts: np.ndarray) -> tuple[int, int, int]:
    """Pick the two most common categories; return (code_byte, low, high)."""
    order = np.argsort(-counts, kind="stable")
    a, b = sorted((int(order[0]), int(order[1])))
    code = {(0, 1): 1, (0, 2): 2, (0, 3): 3, (1, 2): 5, (1, 3): 6, (2, 3): 9}[(a, b)]
    return code, a, b


def _difflist_cost(n_entries: int, sample_ct: int) -> int:
    """Approximate encoded byte size of a difflist with genotype values."""
    if n_entries == 0:
        return 1
    G = (n_entries + 63) // 64
    width = 1 if sample_ct <= 256 else 2 if sample_ct <= 65536 else 3 if sample_ct <= (1 << 24) else 4
    # varint len (<=3 bytes typical) + leaders + group sizes + genovals + ~2B/delta
    return 3 + G * width + (G - 1) + (n_entries + 3) // 4 + 2 * (n_entries - G)


class PgenWriter:
    """Streaming .pgen writer (hardcalls; mode 0x10)."""

    def __init__(
        self,
        path: str,
        sample_ct: int,
        variant_ct: int,
        use_ld: bool = True,
        trusted_ref: bool = False,
        with_dosage: bool = False,
        with_phase: bool = False,
        with_multiallelic: bool = False,
        nonref_flags: "np.ndarray | None" = None,
    ):
        self.path = path
        self.sample_ct = sample_ct
        self.variant_ct = variant_ct
        self.use_ld = use_ld
        self._trusted_ref = trusted_ref
        # explicit per-variant provisional-REF flags (fmt provref code 3);
        # used by the VCF importer when ##INFO PR is a Flag key (ref
        # info_pr_exists -> nonref_flags, 2.0/plink2_import.cc:3097-3300)
        self._nonref_flags = (
            None if nonref_flags is None
            else np.asarray(nonref_flags, dtype=bool)
        )
        if self._nonref_flags is not None \
                and self._nonref_flags.size != variant_ct:
            raise ValueError("nonref_flags length != variant_ct")
        self._with_dosage = with_dosage
        self._with_phase = with_phase
        self._with_multiallelic = with_multiallelic
        self._nb = pack.bytes_per_variant(sample_ct)
        self._f = open(path, "wb")
        self._vrtypes: list[int] = []
        self._rec_lens: list[int] = []
        self._block_offsets: list[int] = []
        self._ld_base: np.ndarray | None = None  # unpacked codes of last non-LD record
        self._written = 0
        # Reserve header space: size the length field from the worst-case
        # record body across every enabled track (the reference widens the
        # same way via vrec_len_byte_ct, pgenlib_write.cc SpgwInitPhase1).
        n_blocks = (variant_ct + _VBLOCK - 1) >> 16
        max_body = self._nb
        if with_phase:
            # dense hardcalls + explicit-form leader byte + (N+1 presence
            # bits) + up-to-N phaseinfo bits
            max_body = max(max_body,
                           self._nb + 1 + (sample_ct + 1 + 7) // 8
                           + (sample_ct + 7) // 8)
        if with_multiallelic:
            # dense main + fmt byte + two N-bit arrays + <=4B/sample values
            # (+ phase track when both enabled)
            ma_body = (self._nb + 1 + 2 * ((sample_ct + 7) // 8)
                       + 6 * sample_ct)
            if with_phase:
                ma_body += (1 + (sample_ct + 1 + 7) // 8
                            + (sample_ct + 7) // 8)
            max_body = max(max_body, ma_body)
        if with_dosage:
            # dense hardcalls (+ phase track if enabled) + presence bitarray
            # + 2 bytes/sample dosage values; when phase is also enabled the
            # explicit-dphase tracks #7-8 add a D-bit bitarray + int16s
            dosage_extra = (sample_ct + 7) // 8 + 2 * sample_ct
            if with_phase:
                dosage_extra += (sample_ct + 7) // 8 + 2 * sample_ct
            max_body = max(max_body, max_body + dosage_extra)
        self._max_body = max_body
        self._len_bytes = (1 if max_body < (1 << 8) else
                           2 if max_body < (1 << 16) else
                           3 if max_body < (1 << 24) else 4)
        self._vr8 = with_dosage or with_phase or with_multiallelic  # 8-bit vrtypes
        header_size = 12 + 8 * n_blocks
        for b in range(n_blocks):
            vct = min(_VBLOCK, variant_ct - (b << 16))
            header_size += (vct if self._vr8 else (vct + 1) // 2) \
                + self._len_bytes * vct
            if self._nonref_flags is not None:
                header_size += (vct + 7) // 8
        self._data_start = header_size
        self._f.write(b"\x00" * header_size)

    # ------------------------------------------------------------------
    def _push_record(self, vrtype: int, body: bytes) -> None:
        if len(body) >= (1 << (8 * self._len_bytes)):
            raise ValueError(
                f"record body ({len(body)} B) exceeds length-field capacity "
                f"({self._len_bytes} B); writer mis-sized (max_body="
                f"{self._max_body})")
        self._f.write(body)
        self._vrtypes.append(vrtype)
        self._rec_lens.append(len(body))

    def append_codes(self, codes: np.ndarray) -> None:
        """Append one or more variants given unpacked uint8 codes [*, N]."""
        codes = np.atleast_2d(np.asarray(codes, dtype=np.uint8))
        if codes.shape[0] >= 8:
            from ..native import get_lib

            lib = get_lib()
            if lib is not None and hasattr(lib, "pgen_encode_rows"):
                self._append_batch_native(lib, np.ascontiguousarray(codes))
                return
        for row in codes:
            self._append_one(row)

    def _append_batch_native(self, lib, codes: np.ndarray) -> None:
        """Batch hardcall encode through the native mirror of _append_one
        (byte-identical; see native/pgen_decode.cc pgen_encode_rows)."""
        import ctypes

        B, N = codes.shape
        if self._written + B > self.variant_ct:
            raise ValueError("more variants appended than declared")
        nb = (N + 3) // 4
        ld = np.zeros(N, np.uint8)
        ld_valid = np.zeros(1, np.int64)
        if self._ld_base is not None:
            ld[:] = self._ld_base
            ld_valid[0] = 1
        chunk = max(1, min(B, (1 << 26) // max(nb, 1)))
        r0 = 0
        while r0 < B:
            r1 = min(B, r0 + chunk)
            nb_rows = r1 - r0
            out = np.empty(nb_rows * nb + 64, np.uint8)
            offs = np.zeros(nb_rows + 1, np.int64)
            vts = np.zeros(nb_rows, np.uint8)
            nbytes = lib.pgen_encode_rows(
                codes[r0:r1].ctypes.data_as(ctypes.c_void_p), nb_rows, N,
                self._written, 1 if self.use_ld else 0,
                ld.ctypes.data_as(ctypes.c_void_p),
                ld_valid.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p), out.size,
                offs.ctypes.data_as(ctypes.c_void_p),
                vts.ctypes.data_as(ctypes.c_void_p),
            )
            if nbytes < 0:
                # capacity miss (can't happen: chosen body <= dense size);
                # scalar fallback keeps correctness anyway
                for row in codes[r0:r1]:
                    self._append_one(row)
                r0 = r1
                continue
            lens = np.diff(offs)
            if int(lens.max(initial=0)) >= (1 << (8 * self._len_bytes)):
                raise ValueError(
                    f"record body ({int(lens.max())} B) exceeds length-field "
                    f"capacity ({self._len_bytes} B); writer mis-sized "
                    f"(max_body={self._max_body})")
            base = self._f.tell()
            for i in range(nb_rows):
                if ((self._written + i) & (_VBLOCK - 1)) == 0:
                    self._block_offsets.append(base + int(offs[i]))
            self._f.write(out[:nbytes].tobytes())
            self._vrtypes.extend(int(v) for v in vts)
            self._rec_lens.extend(int(x) for x in lens)
            self._written += nb_rows
            r0 = r1
        if ld_valid[0]:
            self._ld_base = ld

    @staticmethod
    def _phase_track_bytes(pp: np.ndarray, pi_swapped: np.ndarray) -> bytes:
        """Auxiliary track #2/#3 bytes for one variant given phasepresent
        bits over the het universe (H bits) and the swapped bits of the
        phased subset (pgen_spec.tex:541-560)."""
        pp = np.asarray(pp, np.uint8)
        pi = np.asarray(pi_swapped, np.uint8)
        if pp.all():
            bits = np.concatenate([[0], pi])
            return np.packbits(
                np.asarray(bits, np.uint8), bitorder="little").tobytes()
        first = np.concatenate([[1], pp])
        out = np.packbits(
            np.asarray(first, np.uint8), bitorder="little").tobytes()
        out += np.packbits(pi, bitorder="little").tobytes()
        return out

    def append_codes_multiallelic(
        self, row: np.ndarray, ids01, a01, ids10, lo10, hi10,
        allele_ct: int, phasepresent=None, phaseinfo=None,
    ) -> None:
        """Append one multiallelic variant: dense hardcalls + auxiliary
        track #1 (vrtype 0x08).

        With phasepresent/phaseinfo ([N] bool), also writes the hardcall-
        phase track (vrtype 0x10).  The het universe for phase bits is the
        main-track code-1 set UNION the aux1b entries with lo != hi, in
        sample-ID order (GetAux1bHetIncr, 2.0/include/pgenlib_read.cc:7728:
        raw_het_ct += rare10_ct - hom22_ct)."""
        if not self._with_multiallelic:
            raise ValueError("writer not opened with with_multiallelic=True")
        row = np.asarray(row, dtype=np.uint8)
        at_block_start = (self._written & (_VBLOCK - 1)) == 0
        if at_block_start:
            self._block_offsets.append(self._f.tell())
        body = pack.pack2(row).tobytes()
        vrtype = 0
        if len(np.asarray(ids01)) or len(np.asarray(ids10)):
            vrtype |= 0x08
            body += multiallelic_track(row, ids01, a01, ids10, lo10, hi10,
                                       allele_ct)
        if phasepresent is not None:
            het = row == 1
            i10 = np.asarray(ids10, np.int64)
            if i10.size:
                l10 = np.asarray(lo10, np.int64)
                h10 = np.asarray(hi10, np.int64)
                het = het.copy()
                het[i10[l10 != h10]] = True
            het_idx = np.flatnonzero(het)
            pp = np.asarray(phasepresent, bool)[het_idx]
            if pp.any():
                vrtype |= 0x10
                pi = np.asarray(phaseinfo, bool)[het_idx][pp]
                body += self._phase_track_bytes(pp, pi)
        self._push_record(vrtype, body)
        self._ld_base = row.copy()
        self._written += 1

    def append_codes_with_dosage(
        self, row: np.ndarray, dosage_ids: np.ndarray, dosage_vals: np.ndarray
    ) -> None:
        """Append one variant with a dosage-bitarray track (vrtype 0x60:
        dense hardcalls + sample-presence bitarray + 16384-scale uint16
        values; pgenlib_misc.h:1043)."""
        if not self._with_dosage:
            raise ValueError("writer not opened with with_dosage=True")
        row = np.asarray(row, dtype=np.uint8)
        N = self.sample_ct
        at_block_start = (self._written & (_VBLOCK - 1)) == 0
        if at_block_start:
            self._block_offsets.append(self._f.tell())
        body = pack.pack2(row).tobytes()
        present = np.zeros(N, np.uint8)
        present[np.asarray(dosage_ids, dtype=np.int64)] = 1
        body += np.packbits(present, bitorder="little").tobytes()
        order = np.argsort(np.asarray(dosage_ids, dtype=np.int64))
        body += np.asarray(dosage_vals, dtype="<u2")[order].tobytes()
        self._push_record(0x60, body)
        self._ld_base = row.copy()
        self._written += 1

    def append_codes_with_phase(
        self, row: np.ndarray, phasepresent: np.ndarray,
        phaseinfo: np.ndarray, dosage_ids=None, dosage_vals=None,
        dphase_ids=None, dphase_deltas=None,
    ) -> None:
        """Append one variant with a hardcall-phase track (vrtype 0x10,
        pgenlib_misc.h:1004): explicit phasepresent form (first track bit 1,
        then het_ct presence bits, then one phaseinfo bit per phased het;
        1 = swapped "1|0").  phasepresent/phaseinfo are [N] bool, only het
        positions consulted.

        With dphase_ids/dphase_deltas (explicit dosage-phase, must be a
        subset of dosage_ids), also writes aux tracks #7-8
        (pgen_spec.tex:650-671): a bitarray over the dosage entries plus
        int16 deltas = 16384 * (left - right haplotype ALT dosage)."""
        if not self._with_phase:
            raise ValueError("writer not opened with with_phase=True")
        row = np.asarray(row, dtype=np.uint8)
        N = self.sample_ct
        at_block_start = (self._written & (_VBLOCK - 1)) == 0
        if at_block_start:
            self._block_offsets.append(self._f.tell())
        body = pack.pack2(row).tobytes()
        vrtype = 0
        het_idx = np.flatnonzero(row == 1)
        pp = np.asarray(phasepresent, bool)[het_idx]
        if pp.any():
            vrtype |= 0x10
            pi = np.asarray(phaseinfo, bool)[het_idx][pp]
            if pp.all():
                bits = np.concatenate([[0], pi.astype(np.uint8)])
                body += np.packbits(
                    np.asarray(bits, np.uint8), bitorder="little"
                ).tobytes()
            else:
                # explicit form: [1]+phasepresent bits, then phaseinfo from
                # the next byte boundary (pgenlib_read.cc:6844)
                first = np.concatenate([[1], pp.astype(np.uint8)])
                body += np.packbits(
                    np.asarray(first, np.uint8), bitorder="little"
                ).tobytes()
                body += np.packbits(
                    pi.astype(np.uint8), bitorder="little"
                ).tobytes()
        if dosage_ids is not None and self._with_dosage:
            vrtype |= 0x60
            dids = np.asarray(dosage_ids, dtype=np.int64)
            present = np.zeros(N, np.uint8)
            present[dids] = 1
            body += np.packbits(present, bitorder="little").tobytes()
            order = np.argsort(dids)
            body += np.asarray(dosage_vals, dtype="<u2")[order].tobytes()
            if dphase_ids is not None and len(np.asarray(dphase_ids)):
                vrtype |= 0x80
                dpids = np.asarray(dphase_ids, dtype=np.int64)
                # track #7: D-bit bitarray in ascending-dosage-id order
                sorted_dids = dids[order]
                sel = np.isin(sorted_dids, dpids)
                body += np.packbits(
                    sel.astype(np.uint8), bitorder="little").tobytes()
                # track #8: int16 deltas in the same ascending order
                dorder = np.argsort(dpids)
                body += np.asarray(
                    dphase_deltas, dtype="<i2")[dorder].tobytes()
        self._push_record(vrtype, body)
        self._ld_base = row.copy()
        self._written += 1

    def append_packed(self, packed: np.ndarray) -> None:
        packed = np.atleast_2d(np.asarray(packed, dtype=np.uint8))
        if packed.shape[0] >= 8:
            # vectorized unpack + native batch encode
            self.append_codes(pack.unpack2(packed, self.sample_ct))
            return
        for row in packed:
            self._append_one(pack.unpack2(row, self.sample_ct))

    def _append_one(self, row: np.ndarray) -> None:
        """Representation choice is a faithful port of
        PwcAppendBiallelicGenovecMain (2.0/include/pgenlib_write.cc:915):
        difflist viability via the sample_ct/8 threshold, LD considered
        first with the difflist_len - sample_ct/64 threshold (inverted LD
        on strictly fewer diffs), 1-bit when the two rare categories sum
        below N/16, then plain difflist, else dense.  Mirrored bit-for-bit
        by the native batch encoder (native/pgen_decode.cc
        encode_row_cc)."""
        if self._written >= self.variant_ct:
            raise ValueError("more variants appended than declared")
        N = self.sample_ct
        at_block_start = (self._written & (_VBLOCK - 1)) == 0
        if at_block_start:
            self._block_offsets.append(self._f.tell())
        counts = np.bincount(row, minlength=4).astype(np.int64)
        most = 1 if counts[1] > counts[0] else 0
        second = 1 - most
        largest, second_largest = int(counts[most]), int(counts[second])
        for g in (2, 3):
            c = int(counts[g])
            if c > second_largest:
                if c > largest:
                    second_largest, second = largest, most
                    largest, most = c, g
                else:
                    second_largest, second = c, g
        difflist_len = N - largest
        rare2 = difflist_len - second_largest
        d8, d64 = N // 8, N // 64
        max_dl = min(d8, d8 - 2 * d64 + rare2)
        viable = (most != 1) and (difflist_len <= max_dl)

        if (self.use_ld and self._ld_base is not None
                and not at_block_start and difflist_len > d64):
            thr = (difflist_len - d64) if viable else max_dl
            base = self._ld_base
            diff_mask = row != base
            ld_diff = int(diff_mask.sum())
            inv_row = row.copy()
            inv_row[row == 0] = 2
            inv_row[row == 2] = 0
            inv_mask = inv_row != base
            ld_inv = int(inv_mask.sum())
            if ld_diff < thr or ld_inv < thr:
                inv = ld_inv < ld_diff
                if inv:
                    sids = np.flatnonzero(inv_mask).astype(np.uint32)
                    body = encode_difflist(sids, inv_row[sids], N)
                else:
                    sids = np.flatnonzero(diff_mask).astype(np.uint32)
                    body = encode_difflist(sids, row[sids], N)
                self._push_record(2 + int(inv), body)
                self._written += 1
                return

        self._ld_base = row.copy()
        if not viable and rare2 < N // 16:
            a, b = (most, second) if most < second else (second, most)
            code = {(0, 1): 1, (0, 2): 2, (0, 3): 3, (1, 2): 5,
                    (1, 3): 6, (2, 3): 9}[(a, b)]
            bits = np.zeros(N, dtype=np.uint8)
            bits[row == b] = 1
            body = bytes([code]) + np.packbits(
                bits, bitorder="little").tobytes()
            sids = np.flatnonzero((row != a) & (row != b)).astype(np.uint32)
            body += encode_difflist(sids, row[sids], N)
            self._push_record(1, body)
            self._written += 1
            return
        if viable:
            sids = np.flatnonzero(row != most).astype(np.uint32)
            body = encode_difflist(sids, row[sids], N)
            self._push_record(4 + most, body)
            self._written += 1
            return
        self._push_record(0, pack.pack2(row).tobytes())
        self._written += 1

    # ------------------------------------------------------------------
    def close(self) -> None:
        if self._written != self.variant_ct:
            raise ValueError(f"declared {self.variant_ct} variants, wrote {self._written}")
        f = self._f
        f.seek(0)
        f.write(MAGIC + bytes([0x10]))
        f.write(np.asarray([self.variant_ct, self.sample_ct], dtype="<u4").tobytes())
        # 4-bit vrtypes, fixed len_bytes, no allele counts, provisional-ref "all"
        # (matching plink2's default when converting PLINK1 data; callers with
        # trusted REF should flip to 0x40 via trusted_ref=True in the future).
        if self._nonref_flags is not None:
            fmt = (self._len_bytes - 1) | 0xC0  # explicit nonref track
        else:
            fmt = (self._len_bytes - 1) | (
                0x40 if self._trusted_ref else 0x80)
        if self._vr8:
            fmt |= 4  # 8-bit vrtype storage
        f.write(bytes([fmt]))
        f.write(np.asarray(self._block_offsets, dtype="<u8").tobytes())
        vrtypes = np.asarray(self._vrtypes, dtype=np.uint8)
        rec_lens = np.asarray(self._rec_lens, dtype=np.uint64)
        for b in range(len(self._block_offsets)):
            vstart = b << 16
            vct = min(_VBLOCK, self.variant_ct - vstart)
            vt = vrtypes[vstart : vstart + vct]
            if self._vr8:
                f.write(vt.tobytes())
            else:
                if vct & 1:
                    vt = np.concatenate([vt, np.zeros(1, dtype=np.uint8)])
                packed_vt = (vt[0::2] | (vt[1::2] << 4)).astype(np.uint8)
                f.write(packed_vt.tobytes())
            lens = rec_lens[vstart : vstart + vct]
            lraw = np.empty((vct, self._len_bytes), dtype=np.uint8)
            for k in range(self._len_bytes):
                lraw[:, k] = (lens >> np.uint64(8 * k)).astype(np.uint8)
            f.write(lraw.tobytes())
            if self._nonref_flags is not None:
                bits = self._nonref_flags[vstart : vstart + vct]
                f.write(np.packbits(bits.astype(np.uint8),
                                    bitorder="little").tobytes())
        assert f.tell() == self._data_start, "header size mismatch"
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def write_bed(path: str, packed_pgen: np.ndarray, sample_ct: int | None = None) -> None:
    """Write PLINK1 variant-major .bed from pgen-encoded packed rows.

    Padding 2-bit fields in the final byte are zeroed (hom-A1 in bed coding),
    matching the reference writer's convention.
    """
    packed_pgen = np.atleast_2d(packed_pgen)
    bed = pack.PGEN2BED_BYTE[packed_pgen]
    if sample_ct is not None and (sample_ct & 3) and bed.shape[1]:
        keep = np.uint8((1 << (2 * (sample_ct & 3))) - 1)
        bed[:, -1] &= keep
    with open(path, "wb") as f:
        f.write(MAGIC + b"\x01")
        f.write(bed.tobytes())


def write_pgen_simple(path: str, packed_pgen: np.ndarray, sample_ct: int) -> None:
    """Write fixed-width mode-0x02 .pgen (all records dense)."""
    packed_pgen = np.atleast_2d(packed_pgen)
    with open(path, "wb") as f:
        f.write(MAGIC + b"\x02")
        f.write(np.asarray([packed_pgen.shape[0], sample_ct], dtype="<u4").tobytes())
        f.write(bytes([0x40]))  # no vrtype info, no allele cts, all REF trusted
        f.write(packed_pgen.tobytes())


class MultiallelicWriterMixin:
    pass


def _pack_bits(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, np.uint8), bitorder="little").tobytes()


def _pack_vals(vals: np.ndarray, width: int) -> bytes:
    """Fixed-width little-bit-order packed array (pgen_spec.tex:488-499)."""
    K = len(vals)
    if K == 0 or width == 0:
        return b""
    bits = np.zeros(K * width, np.uint8)
    v = np.asarray(vals, np.int64)
    for b in range(width):
        bits[b::width] = (v >> b) & 1
    return _pack_bits(bits)


def _cat1_width(n_alt: int) -> int:
    if n_alt == 2:
        return 0
    if n_alt == 3:
        return 1
    if n_alt <= 5:
        return 2
    if n_alt <= 17:
        return 4
    if n_alt <= 257:
        return 8
    return 16


def _cat2_width(n_alt: int) -> int:
    if n_alt <= 4:
        return 2
    if n_alt <= 16:
        return 4
    if n_alt <= 256:
        return 8
    return 16


def multiallelic_track(row: np.ndarray, ids01, a01, ids10, lo10, hi10,
                       allele_ct: int) -> bytes:
    """Auxiliary track #1 bytes (format 0 bitarrays,
    pgen_spec.tex:469-541) for one variant whose base hardcalls are `row`
    (REF-ALTx coded 1, ALTx-ALTy coded 2)."""
    n_alt = allele_ct - 1
    cat1 = np.flatnonzero(row == 1)
    cat2 = np.flatnonzero(row == 2)
    ids01 = np.asarray(ids01, np.int64)
    ids10 = np.asarray(ids10, np.int64)
    f01 = 15 if ids01.size == 0 else 0
    f10 = 15 if ids10.size == 0 else 0
    body = bytes([f01 | (f10 << 4)])
    if f01 == 0:
        sel = np.isin(cat1, ids01)
        body += _pack_bits(sel)
        order = np.argsort(ids01)
        body += _pack_vals(np.asarray(a01, np.int64)[order] - 2,
                           _cat1_width(n_alt))
    if f10 == 0:
        sel = np.isin(cat2, ids10)
        body += _pack_bits(sel)
        order = np.argsort(ids10)
        lo = np.asarray(lo10, np.int64)[order]
        hi = np.asarray(hi10, np.int64)[order]
        if n_alt == 2:
            body += _pack_bits(lo == 2)
        else:
            w = _cat2_width(n_alt)
            pairs = np.empty(2 * len(lo), np.int64)
            pairs[0::2] = lo - 1
            pairs[1::2] = hi - 1
            body += _pack_vals(pairs, w)
    return body

"""Chromosome registry (ref: 2.0/plink2_common.h:853 ChrInfo).

Human default codes: autosomes 1-22, X=23, Y=24, XY=25 (pseudo-autosomal),
MT=26; nonstandard contig names are assigned codes from 27 upward in order
of first appearance.  Code 0 = unplaced.
"""

from __future__ import annotations

import numpy as np

AUTOSOME_CT = 22
X_CODE = 23
Y_CODE = 24
XY_CODE = 25
MT_CODE = 26
_FIRST_CONTIG = 27

_SPECIAL = {"X": X_CODE, "Y": Y_CODE, "XY": XY_CODE, "MT": MT_CODE, "M": MT_CODE}
_SPECIAL_NAMES = {X_CODE: "X", Y_CODE: "Y", XY_CODE: "XY", MT_CODE: "MT"}


class ChrInfo:
    def __init__(self, autosome_ct: int = AUTOSOME_CT):
        self.autosome_ct = autosome_ct
        self._contigs: dict[str, int] = {}
        self._contig_names: list[str] = []
        self._output_chr_prefix = ""  # set to "chr" by --output-chr chrM etc.

    def code(self, name: str) -> int:
        s = name
        if s.lower().startswith("chr"):
            s = s[3:]
        u = s.upper()
        if u in _SPECIAL:
            return _SPECIAL[u]
        try:
            v = int(s)
            if 0 <= v <= MT_CODE:
                return v
        except ValueError:
            pass
        if name not in self._contigs:
            self._contigs[name] = _FIRST_CONTIG + len(self._contig_names)
            self._contig_names.append(name)
        return self._contigs[name]

    _output_numeric = False
    _mt_name = "MT"

    _output_set = False

    def name19(self, code: int) -> str:
        """1.9-style chromosome display: numeric sex/mito codes (23/24/
        25/26) by default (1.9 chrom_name_write with the default
        --output-chr 26), honoring an explicit --output-chr."""
        if self._output_set:
            return self.name(code)
        if code <= MT_CODE:
            return str(code)
        return self.name(code)

    def set_output_chr(self, mode: str) -> None:
        """--output-chr scheme (2.0/plink2_cmdline chr output modes): the MT
        spelling selects numeric vs lettered sex-chromosome codes and the
        'chr' prefix."""
        self._output_set = True
        self._output_chr_prefix = "chr" if mode.startswith("chr") else ""
        base = mode[3:] if mode.startswith("chr") else mode
        if base.startswith("0"):
            base = base[1:]
        self._output_numeric = base == "26"
        self._mt_name = "M" if base == "M" else "MT"

    def name(self, code: int) -> str:
        if code <= self.autosome_ct:
            return f"{self._output_chr_prefix}{code}"
        if code in _SPECIAL_NAMES:
            if self._output_numeric:
                return f"{self._output_chr_prefix}{code}"
            nm = _SPECIAL_NAMES[code]
            if code == MT_CODE:
                nm = self._mt_name
            return f"{self._output_chr_prefix}{nm}"
        return self._contig_names[code - _FIRST_CONTIG]

    def is_haploid(self, code: int, sex: int = 0) -> bool:
        """Whether genotypes on this chromosome are haploid for a given sex."""
        if code == Y_CODE or code == MT_CODE:
            return True
        if code == X_CODE:
            return sex == 1
        return False

    def is_autosomal(self, codes: np.ndarray) -> np.ndarray:
        return (codes >= 1) & (codes <= self.autosome_ct)

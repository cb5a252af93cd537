"""Comparison rules for the relationship outputs (KING, GRM, .rel, PCA).

One place for the rules that the CPU tests (plink_torch against plink_tpu)
and chip_smoke.py (the card against the CPU) hold two runs' files to:
- .grm.bin (and its --parallel pieces): f32 entries within GRM_BIN_ATOL
  absolute (f32 sums taken in another order);
- .grm: the i / j / count columns exact, the value within `text_rtol` of
  max(|ref|, text_floor);
- .rel: every value within `text_rtol` of max(|ref|, text_floor);
- .eigenval: within EIG_TOL relative; .eigenvec: the header and the ids
  exact, each column within EIG_TOL after matching its sign;
- .eigenvec.allele: the header and the variant / allele columns exact, each
  PC column within EIG_TOL absolute after matching its sign;
- everything else (.kin0, .king*, id files, cutoff lists, .grm.N.bin):
  byte-identical.
"""

from __future__ import annotations

import filecmp
import re

import numpy as np

GRM_BIN_ATOL = 2e-6
EIG_TOL = 1e-4


def close_floats(ref, got, rtol: float, floor: float = 1e-30) -> bool:
    """Same shape, and |got - ref| <= rtol * max(|ref|, floor) everywhere."""
    a, b = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return a.shape == b.shape and bool(
        (np.abs(a - b) <= rtol * np.maximum(np.abs(a), floor)).all())


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f]


def relationship_output_close(ext: str, ref: str, got: str,
                              text_rtol: float = 1e-5,
                              text_floor: float = 1e-30) -> bool:
    """Whether output file `got` matches `ref` under the rules above; `ext`
    names the kind (a --parallel piece's ".<k>" suffix is ignored)."""
    kind = re.sub(r"\.\d+$", "", ext)
    if kind == ".grm.bin":
        a, b = np.fromfile(ref, np.float32), np.fromfile(got, np.float32)
        return a.size == b.size > 0 and float(np.abs(a - b).max()) <= GRM_BIN_ATOL
    if kind == ".grm":
        ra, rb = _rows(ref), _rows(got)
        return ([r[:3] for r in ra] == [r[:3] for r in rb]
                and close_floats([r[3] for r in ra], [r[3] for r in rb],
                                 text_rtol, text_floor))
    if kind == ".rel":
        ra, rb = _rows(ref), _rows(got)
        return ([len(r) for r in ra] == [len(r) for r in rb]
                and close_floats(sum(ra, []), sum(rb, []), text_rtol, text_floor))
    if kind == ".eigenval":
        return close_floats(np.loadtxt(ref), np.loadtxt(got), EIG_TOL)
    if kind in (".eigenvec", ".eigenvec.allele"):
        ra, rb = _rows(ref), _rows(got)
        k = 1 if kind == ".eigenvec" else len(ra[0]) - sum(
            c.startswith("PC") for c in ra[0])
        if ra[0] != rb[0] or [r[:k] for r in ra] != [r[:k] for r in rb]:
            return False
        a = np.array([r[k:] for r in ra[1:]], np.float64)
        b = np.array([r[k:] for r in rb[1:]], np.float64)
        if a.shape != b.shape:
            return False
        b = b * np.sign((a * b).sum(axis=0))
        return float(np.abs(a - b).max()) <= EIG_TOL
    return filecmp.cmp(ref, got, shallow=False)

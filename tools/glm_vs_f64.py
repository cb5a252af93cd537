#!/usr/bin/env python3
"""Hold every variant of a plink_torch --glm report to numpy f64 fits.

Builds chip_smoke's parity panel (2,000 x 1,200, seed 1, SEX + 10 PCs, a
PHENO1 + QT1 phenotype file) in DIR, runs the port's CLI once with the
given --glm modifiers on DEVICE, and holds each variant without an ERRCODE
to chip_smoke's f64 reference of its rows (f64_variant: the logistic / Firth
fit under plink2's stopping rules, least squares for the linear report).
Per report it prints the worst difference as a fraction of the 1e-3 rule
(chip_smoke.float_allowed) against plink2's own stop, the variants above
1, and the worst against any stop an f32 fit can take there.

Usage: python tools/glm_vs_f64.py DIR DEVICE MODIFIER...
  e.g. python tools/glm_vs_f64.py /tmp/gv cpu interaction hide-covar
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv):
    import numpy as np

    import chip_smoke as cs
    from plink_torch import cli

    tmp, device, mods = argv[0], argv[1], argv[2:]
    os.makedirs(tmp, exist_ok=True)
    prefix = os.path.join(tmp, "small")
    if not os.path.exists(prefix + ".pgen"):
        cs.make_panel(prefix, *cs.SMALL)
        cs.write_both(prefix, prefix + ".both")
    os.environ.update(PLINK_TORCH_DEVICE=device, PLINK_TORCH_VB="256")
    out = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    rc = cli.main(["--pfile", prefix, "--pheno", prefix + ".both", "--covar",
                   prefix + ".cov", "--glm", *mods, "--out", out, "--silent"])
    assert rc == 0, rc
    print(f"--glm {' '.join(mods)} on {device}: {time.perf_counter() - t0:.1f}s")
    C, y, _sex, qt = cs._panel_design(prefix)
    cnames = ["SEX"] + [f"PC{i}" for i in range(1, 11)]
    keep = np.ones(len(y), bool)
    for ext in sorted(f[len("run."):] for f in os.listdir(tmp)
                      if f.startswith("run.") and ".glm." in f):
        hdr, rows = cs.read_report(os.path.join(tmp, "run." + ext))
        col = {c: hdr.index(c) for c in hdr}
        by_vid = {}
        for r in rows:
            by_vid.setdefault(r[col["ID"]], []).append(r)
        fi = col.get("FIRTH?")
        own, best = [], []
        for vid, vrows in by_vid.items():
            if any(r[col["ERRCODE"]] != "." for r in vrows):
                continue
            firth = ext.endswith("glm.firth") or (fi is not None and vrows[0][fi] == "Y")
            wants, nobs = cs.f64_variant(prefix, vrows, col, set(mods), C[:, 1:],
                                         cnames, keep, qt if "QT1" in ext else y,
                                         firth)
            fracs = []
            for want in wants:
                try:
                    fracs.append(cs.hold_to_f64(vid, vrows, col, [want], nobs))
                except AssertionError as e:
                    fracs.append(float(e.args[0][1]))
            own.append((fracs[0], vid))
            best.append((min(fracs), vid))
        own.sort(reverse=True)
        best.sort(reverse=True)
        print(f"{ext}: {len(own)} variants; against plink2's stop worst "
              f"{own[0][0]:.4f} ({own[0][1]}), {sum(f > 1 for f, _ in own)} above 1; "
              f"against any stop worst {best[0][0]:.4f} ({best[0][1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

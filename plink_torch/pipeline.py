"""Command pipeline (ref: Plink2Core, 2.0/plink2.cc:836), as far as this port
runs it: load a .pgen/.bed fileset, apply --pheno, run --glm.

Every other flag raises NotPortedError before anything runs; the run never
falls back to plink_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import NotPortedError
from .cli import Config
from .dataset import load_dataset
from .utils.logging import RunLogger, set_logger

# Config fields this port runs; a field set away from its default names a
# flag that is not yet ported
_PORTED_FIELDS = {
    "pfile", "bfile", "out", "glm", "glm_modifiers", "pheno", "pheno_name",
    "covar", "covar_name", "nonfounders", "input_missing_phenotype",
    "output_chr", "seed", "silent", "threads", "memory", "argv",
}


def _unported_flags(cfg: Config) -> list[str]:
    out = []
    for f in dataclasses.fields(Config):
        if f.name in _PORTED_FIELDS:
            continue
        default = f.default if f.default is not dataclasses.MISSING \
            else f.default_factory()
        if getattr(cfg, f.name) != default:
            out.append("--" + f.name.replace("_", "-"))
    return out


def _load(cfg: Config, device):
    """The input fileset (--pfile / --bfile; every other input flag is
    refused by _unported_flags before this runs)."""
    if not (cfg.pfile or cfg.bfile):
        raise ValueError("no input fileset specified (--pfile/--bfile)")
    return load_dataset(cfg.pfile or cfg.bfile, device,
                        missing_pheno=cfg.input_missing_phenotype)


def run_pipeline(cfg: Config, device) -> int:
    bad = _unported_flags(cfg)
    if bad:
        raise NotPortedError(
            f"{', '.join(bad)}: not yet ported to plink_torch.")
    log = RunLogger(cfg.out, silent=cfg.silent)
    set_logger(log)
    log.banner(["plink2t"] + cfg.argv)
    if cfg.seed is not None:
        np.random.seed(cfg.seed)
    try:
        ds = _load(cfg, device)
        log.log(
            f"{ds.raw_variant_ct} variants and {ds.raw_sample_ct} samples loaded."
        )
        if cfg.output_chr != "MT":
            ds.vi.chr_info.set_output_chr(cfg.output_chr)
        if cfg.pheno:
            # 2.0 psam input: --pheno APPENDS to the psam phenotype columns;
            # they are only dropped when --pheno-name is also given (ref
            # ignore_psam_phenos, 2.0/plink2.cc:955).  plink1 filesets
            # (.fam col-6 phenotype): --pheno REPLACES the fam phenotype.
            from .commands.glm import _match_rows, _read_table
            from .io.psam import _build_pheno

            id_mode, ids, colnames, vals = _read_table(cfg.pheno)
            rows = _match_rows(ds, id_mode, ids)
            n_raw = ds.raw_sample_ct
            phenos = {} if (cfg.pheno_name or cfg.pfile is None) \
                else dict(ds.si.phenos)
            for c_, nm_ in enumerate(colnames):
                col = ["NA"] * n_raw
                for r_, idx in enumerate(rows):
                    if idx >= 0:
                        col[idx] = vals[r_][c_]
                phenos[nm_] = _build_pheno(nm_, col)
            ds.si.phenos = phenos
        if cfg.glm:
            from .commands.glm import run_glm

            with log.phase("--glm"):
                run_glm(ds, cfg, log)
        log.log(f"End of run; total wall-clock {log.elapsed():.2f}s.")
        return 0
    except Exception as e:
        log.log(f"Error: {e}")
        raise
    finally:
        log.close()

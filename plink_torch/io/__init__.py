from .pgen_read import PgenReader
from .pgen_write import PgenWriter, write_bed, write_pgen_simple
from .psam import PhenoCol, SampleInfo, read_psam, write_psam
from .pvar import VariantInfo, read_bim, read_pvar, write_bim, write_pvar

__all__ = [
    "PgenReader",
    "PgenWriter",
    "write_bed",
    "write_pgen_simple",
    "PhenoCol",
    "SampleInfo",
    "read_psam",
    "write_psam",
    "VariantInfo",
    "read_bim",
    "read_pvar",
    "write_bim",
    "write_pvar",
]

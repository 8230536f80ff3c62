"""The host half of ``pgen_tpu/pipeline/export_raw.py``, copied: the token
tables, the result type and the leading sample cells of a ``.raw`` row
(``_sample_prefixes``, ``_sex_str``, ``_pheno_str``) and of a ``.ped`` row
(``_ped_prefixes``). Only the imports differ. Left out: ``export_raw`` and
``export_ped`` (their decode is pgen_tpu's host unpack); the port's are
``pipeline/export_raw.py``, which decodes on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.utils.timer import StageTimer

# token tables: code -> emitted bytes, fixed width so one np.take +
# tobytes() builds the row; the "\t." missing cell widens to "\tNA" in a
# single bytes.replace afterwards (no other "\t." can occur: every other
# cell is a digit)
_TOKENS_A = np.frombuffer(b"\t0\t1\t2\t.", dtype=np.uint8).reshape(4, 2)
_TOKENS_AD = np.frombuffer(
    b"\t0\t0\t1\t1\t2\t0\t.\t.", dtype=np.uint8
).reshape(4, 4)


@dataclass
class ExportResult:
    fmt: str
    num_variants: int
    num_samples: int
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def _sex_str(v: str) -> str:
    v = v.strip()
    if v in ("1", "M", "m"):
        return "1"
    if v in ("2", "F", "f"):
        return "2"
    return "NA"


def _pheno_str(v: str) -> str:
    v = v.strip()
    return "NA" if v in ("-9", ".", "") else v


def _sample_prefixes(psam, sam_idx) -> list:
    """FID IID PAT MAT SEX PHENOTYPE prefix cells per kept sample."""
    iids = psam.get_column_strs("IID")

    def col_or(name, default):
        if name in psam.columns:
            return psam.get_column_strs(name)
        return None if default is None else [default] * psam.num_rows

    fids = col_or("FID", "0")
    pats = col_or("PAT", "0")
    mats = col_or("MAT", "0")
    sexes = col_or("SEX", None)
    phenos = col_or("PHENO1", None)
    out = []
    for s in sam_idx:
        s = int(s)
        sex = _sex_str(sexes[s]) if sexes is not None else "NA"
        ph = _pheno_str(phenos[s]) if phenos is not None else "NA"
        out.append(f"{fids[s]}\t{iids[s]}\t{pats[s]}\t{mats[s]}\t{sex}\t{ph}")
    return out


def _ped_prefixes(psam, sam_idx) -> list:
    """PLINK1 .ped leading fields: FID IID PAT MAT SEX PHENO with the
    classic conventions (unknown sex -> 0, missing phenotype -> -9)."""
    iids = psam.get_column_strs("IID")

    def col_or(name):
        return psam.get_column_strs(name) if name in psam.columns else None

    fids = col_or("FID")
    pats = col_or("PAT")
    mats = col_or("MAT")
    sexes = col_or("SEX")
    phenos = col_or("PHENO1")
    out = []
    for s in sam_idx:
        s = int(s)
        sex = "0"
        if sexes is not None:
            v = sexes[s].strip()
            sex = "1" if v in ("1", "M", "m") else (
                "2" if v in ("2", "F", "f") else "0"
            )
        ph = "-9"
        if phenos is not None:
            v = phenos[s].strip()
            ph = v if v not in ("-9", ".", "") else "-9"
        out.append(
            f"{fids[s] if fids else '0'}\t{iids[s]}\t"
            f"{pats[s] if pats else '0'}\t{mats[s] if mats else '0'}\t"
            f"{sex}\t{ph}"
        )
    return out

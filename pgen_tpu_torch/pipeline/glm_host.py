"""The host half of ``pgen_tpu/pipeline/glm.py``, copied: the run result,
the model detection and the phenotype/covariate column readers. Only the
imports differ. Left out: ``glm_pfile``, whose runs import pgen_tpu's
jax-importing ``ops/glm.py``; the port's is ``pipeline/glm.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

log = get_logger(__name__)

MISSING_CODES = {"", ".", "NA", "na", "nan", "NaN", "-9"}


@dataclass
class GlmRunResult:
    pheno_name: str
    model: str  # "linear" | "logistic"
    num_variants: int
    num_samples: int  # analysis cohort size
    num_dropped: int  # kept samples excluded for missing pheno/covars
    n_obs: np.ndarray
    beta: np.ndarray
    se: np.ndarray
    t_stat: np.ndarray  # T_STAT (linear) / Z_STAT (logistic)
    p: np.ndarray
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def detect_model(y: np.ndarray, model: str) -> tuple:
    """plink2 model choice: case/control phenotypes run logistic.

    `model` is "auto" (logistic iff values are {1,2} plink coding or
    already {0,1}), "linear", or "logistic". Returns (model, y) with
    case/control recoded to 0/1 for the logistic path."""
    if model not in ("auto", "linear", "logistic"):
        raise ValueError(f"glm: unknown model {model!r}")
    vals = np.unique(y[~np.isnan(y)])
    is_12 = np.isin(vals, (1.0, 2.0)).all()
    is_01 = np.isin(vals, (0.0, 1.0)).all()
    if model == "linear":
        return "linear", y
    if model == "logistic":
        if is_12 and not is_01:
            return "logistic", y - 1.0
        if not np.isin(vals, (0.0, 1.0)).all():
            raise ValueError(
                "glm: --logistic needs a case/control phenotype "
                "(1/2 plink coding or 0/1)"
            )
        return "logistic", y
    if is_12 and not is_01:
        return "logistic", y - 1.0
    if is_01:
        return "logistic", y
    return "linear", y


def parse_numeric_column(values, colname: str) -> np.ndarray:
    """psam column -> f64 with NaN for missing; M/F (any case) -> 1/2."""
    out = np.empty(len(values), dtype=np.float64)
    for i, raw in enumerate(values):
        s = raw.strip()
        if s in MISSING_CODES:
            out[i] = np.nan
            continue
        try:
            out[i] = float(s)
        except ValueError:
            u = s.upper()
            if u == "M":
                out[i] = 1.0
            elif u == "F":
                out[i] = 2.0
            else:
                raise ValueError(
                    f"glm: {colname} value {raw!r} is not numeric "
                    f"(missing codes: NA . -9; sex letters M/F)"
                ) from None
    return out


def _external_column(path: str, colname: str, psam_iids) -> np.ndarray:
    """plink2 --pheno/--covar file join: a TSV with an IID column (header
    `#IID`/`IID`, or `#FID IID ...`) joined onto the psam's sample order.
    Samples absent from the file get NaN (missing). Duplicate IIDs in the
    file error (ambiguous join)."""
    raw = _external_strs(path, colname, psam_iids)
    return parse_numeric_column(raw, f"{path}:{colname}")


def _external_strs(path: str, colname: str, psam_iids) -> list:
    """The raw-string form of the --pheno/--covar join (categorical
    columns: fst --pheno-name); absent samples get 'NA'."""
    with open(path) as fh:
        header = fh.readline()
        if not header:
            raise ValueError(f"glm: {path} is empty")
        cols = header.lstrip("#").rstrip("\n").split("\t")
        if "IID" not in cols:
            raise ValueError(
                f"glm: {path} header needs an IID column (has: "
                f"{', '.join(cols)})"
            )
        iid_j = cols.index("IID")
        try:
            col_j = cols.index(colname)
        except ValueError:
            raise ValueError(
                f"glm: {path} has no column {colname!r} (has: "
                f"{', '.join(cols)})"
            ) from None
        vals = {}
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(iid_j, col_j):
                continue
            iid = parts[iid_j]
            if iid in vals:
                raise ValueError(f"glm: {path} lists IID {iid!r} twice")
            vals[iid] = parts[col_j]
    return [vals.get(iid, "NA") for iid in psam_iids]

"""The host half of ``pgen_tpu/pipeline/roh.py``, copied: the result type and
the CHROM runs a scan walks. Only the imports differ. Left out:
``roh_report`` (its het/missing matrices come from pgen_tpu's host
unpack); the port's is ``pipeline/roh.py``, which builds them on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from pgen_tpu_torch.utils.timer import StageTimer


@dataclass
class RohResult:
    num_variants: int
    num_samples: int
    num_segments: int
    out_paths: list
    timer: StageTimer = field(default_factory=StageTimer)


def _chrom_runs(chroms: list):
    """Maximal contiguous runs of equal CHROM value: [(chrom, lo, hi))."""
    runs = []
    lo = 0
    for i in range(1, len(chroms) + 1):
        if i == len(chroms) or chroms[i] != chroms[lo]:
            runs.append((chroms[lo], lo, i))
            lo = i
    return runs

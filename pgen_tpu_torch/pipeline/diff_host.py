"""The host half of ``pgen_tpu/pipeline/diff.py``, copied: the GT text of a
code, the result type and the first-occurrence key match. Only the imports
differ. Left out: ``diff_pgen``; the port's is ``pipeline/diff.py``, which
compares on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu_torch.utils.timer import StageTimer

_GT = ["0/0", "0/1", "1/1", "./."]


@dataclass
class DiffResult:
    num_variants: int      # matched variant pairs
    num_samples: int       # shared samples
    num_discordant: int
    num_cells: int         # compared (variant, sample) cells
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def _first_occurrence_match(ka: np.ndarray, kb: np.ndarray):
    """(aidx, bidx): for each A key present in B, the first matching row
    on each side. Vectorized: stable argsort + searchsorted."""
    # first occurrence per duplicate A key
    _, a_first = np.unique(ka, return_index=True)
    a_first.sort()
    ka_f = ka[a_first]
    order = np.argsort(kb, kind="stable")
    skb = kb[order]
    pos = np.searchsorted(skb, ka_f)
    pos_c = np.minimum(pos, max(len(skb) - 1, 0))
    valid = (pos < len(skb)) & (skb[pos_c] == ka_f) if len(skb) else (
        np.zeros(len(ka_f), dtype=bool)
    )
    aidx = a_first[valid]
    bidx = order[pos[valid]]
    return aidx, bidx

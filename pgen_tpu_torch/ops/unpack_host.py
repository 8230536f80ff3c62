"""Host (numpy) 2-bit unpack — jax-free by design.

These live apart from ops/unpack.py (the Pallas kernels) so that host
pipelines importing them never pay the ~1 s jax/pallas import: the CLI's
default native path runs whole filters without touching jax at all.
Semantics are the reference extraction (pgen-rs/src/pfile.rs:
171-175): byte ``s // 4``, bits ``(s % 4) * 2``, LSB-first.

Copied from ``pgen_tpu/ops/unpack_host.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

from __future__ import annotations

import numpy as np


def unpack_codes_reference(packed: np.ndarray, num_samples: int) -> np.ndarray:
    """Scalar-style numpy oracle for tests: (V, R) u8 -> (V, S) u8 codes."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((packed.shape[0], num_samples), dtype=np.uint8)
    for s in range(num_samples):
        out[:, s] = (packed[:, s // 4] >> ((s % 4) * 2)) & 0b11
    return out


def unpack_codes_numpy(packed: np.ndarray, num_samples: int) -> np.ndarray:
    """Vectorized numpy unpack: (V, R) u8 -> (V, S) u8 codes.

    Same LSB-first extraction as the oracle, materialized as one broadcast
    shift over the 4 bit positions (byte j -> columns 4j..4j+3)."""
    packed = np.asarray(packed, dtype=np.uint8)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = (packed[:, :, None] >> shifts) & np.uint8(3)  # (V, R, 4)
    return codes.reshape(packed.shape[0], -1)[:, :num_samples]

"""Per-variant logistic association (case/control GWAS) with its moment
products on the GPU: the port of pgen_tpu's device provider in
``pgen_tpu/ops/logistic.py``.

pgen_tpu's IRLS is host code that imports no jax; its device provider only
hands it ``_device_matmul`` (:841-857), a closure that runs each
iteration's (V, S) x (S, P) moment products on the accelerator in f32.
This module ports that closure (``device_matmul``: ``torch.matmul`` in full
fp32 on ``device``, the result back as f64) and runs the port's copy of the
IRLS (``ops/logistic_host.py``) with it, at the device provider's step
tolerance of at least 1e-5. A given
``matmul`` skips pgen_tpu's sufficient-statistics paths, exactly as its
device provider does. Each iteration ships its host arrays to the card and
back, as pgen_tpu's does.

The entry points reject sample ids outside [0, num_samples) before the
reused code runs: pgen_tpu's counts path does not range-check them
(``ops/logistic.py:683-684``; ROADMAP §3).
"""

from __future__ import annotations

import numpy as np
import torch

from pgen_tpu_torch.ops.logistic_host import (
    LogisticModResult,
    _logistic_fit_multi,
    glm_logistic_numpy,
)
from pgen_tpu_torch.ops.logistic_host import glm_logistic_interaction as _glm_logistic_interaction
from pgen_tpu_torch.device import matmul_fp32, resolve_device
from pgen_tpu_torch.ops.glm import MODIFIER_COLS, check_sample_ids

# pgen_tpu's device provider tolerance (ops/logistic.py:876, :831, :1302):
# f32 moment noise in the gradient can exceed the host's 1e-7 step test.
DEVICE_TOL = 1e-5


def device_matmul(device):
    """(a, b) -> a @ b as f64 numpy, the product taken on ``device`` in full
    fp32 from f32 copies of a and b: pgen_tpu's ``_device_matmul``."""
    dev = resolve_device(device)

    def mm(a, b):
        ta = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        tb = torch.from_numpy(np.ascontiguousarray(b, dtype=np.float32)).to(dev)
        return matmul_fp32(ta, tb).cpu().numpy().astype(np.float64)

    return mm


def _covars(y, covars) -> tuple:
    y = np.asarray(y, dtype=np.float64)
    covars = (
        np.zeros((y.shape[0], 0)) if covars is None
        else np.asarray(covars, dtype=np.float64)
    )
    return y, covars


def glm_logistic(packed, num_samples: int, y, covars, device, **kw):
    """Additive model: pgen_tpu's ``glm_logistic(provider="device")`` with
    the products on ``device``. ``kw`` as ``glm_logistic_numpy``'s."""
    y, covars = _covars(y, covars)
    check_sample_ids(kw.get("sample_idx"), num_samples)
    kw = dict(kw, matmul=device_matmul(device))
    kw.setdefault("tol", DEVICE_TOL)
    return glm_logistic_numpy(packed, num_samples, y, covars, **kw)


def glm_logistic_modifier(packed, num_samples: int, y, covars, modifier: str, device,
                          block_variants: int = 256, sample_idx=None, max_iter: int = 24,
                          tol: float = 1e-7, firth: str = "fallback") -> LogisticModResult:
    """plink2 ``--glm genotypic|hethom|dominant|recessive``, logistic:
    pgen_tpu's ``glm_logistic_modifier(provider="device")``, which is
    ``_logistic_fit_multi`` with the device products and the modifier's
    genotype columns (called directly: pgen_tpu's wrapper imports its
    jax-importing ``ops.glm`` for the table)."""
    if modifier not in MODIFIER_COLS:
        raise ValueError(f"glm: unknown modifier {modifier!r}")
    y, covars = _covars(y, covars)
    check_sample_ids(sample_idx, num_samples)
    n, beta, se, z, p, joint, joint_p, niter, fused = _logistic_fit_multi(
        packed, num_samples, y, covars, block_variants, sample_idx, max_iter,
        max(tol, DEVICE_TOL), device_matmul(device), firth, MODIFIER_COLS[modifier],
    )
    return LogisticModResult(n, beta, se, z, p, joint, joint_p, niter, fused)


def glm_logistic_interaction(packed, num_samples: int, y, covars, device,
                             tol: float = 1e-7, **kw):
    """plink2 ``--glm interaction``, logistic: pgen_tpu's
    ``glm_logistic_interaction(provider="device")``, the device products
    handed in as ``matmul``. ``kw`` as pgen_tpu's (block_variants,
    sample_idx, max_iter, firth)."""
    check_sample_ids(kw.get("sample_idx"), num_samples)
    return _glm_logistic_interaction(
        packed, num_samples, y, covars, provider="numpy",
        matmul=device_matmul(device), tol=max(tol, DEVICE_TOL), **kw,
    )

"""Build and load the port's CUDA kernels (``csrc/``).

At first use ``nvcc`` compiles ``csrc/genotype.cu`` for ``sm_90a`` into a
shared library with a plain C interface, which ctypes loads. Nothing here
includes PyTorch's headers, so the build takes seconds rather than the
minutes of ``torch.utils.cpp_extension.load``.

The library lands in ``build/pgen_tpu_torch/libpgen_kernels_<sha16>.so`` at
the root of the checkout, keyed by a hash of the sources and the flags (as
``pgen_tpu/native/lib.py`` keys its C++ build); a changed source builds a
new file. Each build writes a temporary file and renames it into place, so
concurrent first uses never load a half-written library. A failed build
raises with nvcc's stderr: there is no fallback. ptxas' report of each
kernel's registers, shared memory and spills (``-Xptxas -v``) is kept beside
the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("genotype.cu", "genotype.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pgen_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# launch counts are read-modify-writes shared by the emission threads of
# --threads (pipeline/filter.py), so each count is taken under this lock
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def build() -> Path:
    """Compile the kernels unless the library for these sources and flags
    exists; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libpgen_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".build-", suffix=".so")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "genotype.cu")]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {r.returncode}: {' '.join(cmd)}\n"
                f"{r.stderr}"
            )
        so.with_suffix(".log").write_text(r.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call. Every pointer and the stream
    are ``c_void_p`` and every size ``c_int64``: with ctypes' default int
    conversion a 64-bit pointer would be cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pgen_unpack_codes.argtypes = [ptr, ptr, i64, i64, ptr]
    lib.pgen_genotype_text.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.pgen_subset_text.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.pgen_pack_codes.argtypes = [ptr, ptr, i64, i64, ptr]
    lib.pgen_subset_repack.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.pgen_genotype_text_transposed.argtypes = [ptr, ptr, i64, i64, ptr]
    lib.pgen_text_from_codes.argtypes = [ptr, ptr, i64, i64, ptr]
    lib.pgen_gt_counts.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.pgen_sample_counts.argtypes = [ptr, ptr, i64, i64, ptr]
    lib.pgen_gt_counts_masked.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.pgen_glm_planes.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.pgen_score_dosage.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.pgen_grm_z.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, ptr]
    lib.pgen_ld_r2_band.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.pgen_pca_approx_pass.argtypes = [ptr] * 5 + [i64] * 5 + [ptr]
    lib.pgen_pca_approx_scratch_bytes.argtypes = [i64, i64]
    lib.pgen_pca_approx_scratch_bytes.restype = i64
    lib.pgen_relatedness_bits.argtypes = [ptr, ptr] + [i64] * 5 + [ptr]
    lib.pgen_relatedness_gram.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    for fn in (
        lib.pgen_unpack_codes, lib.pgen_genotype_text, lib.pgen_subset_text,
        lib.pgen_pack_codes, lib.pgen_subset_repack,
        lib.pgen_genotype_text_transposed, lib.pgen_text_from_codes,
        lib.pgen_gt_counts, lib.pgen_sample_counts, lib.pgen_gt_counts_masked,
        lib.pgen_glm_planes,
        lib.pgen_score_dosage, lib.pgen_grm_z, lib.pgen_ld_r2_band, lib.pgen_pca_approx_pass,
        lib.pgen_relatedness_bits, lib.pgen_relatedness_gram,
    ):
        fn.restype = ctypes.c_int
    lib.pgen_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pgen_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(wrapper, symbol: str, t: torch.Tensor, *args) -> None:
    """Launch ``wrapper``'s kernel through the library function ``symbol``
    with ``args`` and PyTorch's current stream on t's card, and count it on
    ``wrapper.launches``.

    The launchers run on the calling thread's current device, so t's device
    is made current around the call. A launcher that reports a CUDA error
    raises here: a refused launch never runs, and a later synchronise would
    not report it.
    """
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        status = getattr(load(), symbol)(*args, stream)
    if status != 0:
        msg = load().pgen_cuda_error_string(status).decode()
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error {status} ({msg})")
    with _COUNT_LOCK:
        wrapper.launches += 1

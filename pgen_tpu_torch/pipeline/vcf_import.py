"""VCF -> PGEN import on one GPU: the port of
``pgen_tpu/pipeline/vcf_import.py`` with its ``device`` provider.

Everything but the pack is the port's copy of pgen_tpu's host code
(``pipeline/vcf_import_host.py``): the BGZF windows, the header parse, the
newline-aligned chunking and the vectorized GT parse ``_parse_chunk_numpy``
(the host half of pgen_tpu's ``device`` provider). A malformed row raises
the copy's ``VcfImportError`` with pgen_tpu's message, naming the same row. The .psam and .pvar are written as pgen_tpu writes
them, and the .pgen's variant count is patched at the end.

Per chunk:

  parse   host parse of the chunk: (rows, N) u8 codes and the .pvar bytes
  h2d     codes into the pinned staging tensor (grown on demand: chunks hold
          whole lines, so their row counts vary), then the copy to the device
  kernel  pack_codes (K4)
  d2h     copy of the records to a pinned host buffer
  write   append records to OUT.pgen and rows to OUT.pvar

The loop is synchronous, as in ``pipeline/filter.py``. Output bytes equal
pgen_tpu's for every provider.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from pgen_tpu_torch.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
)
from pgen_tpu_torch.pipeline.vcf_import_host import (
    DEFAULT_CHUNK_BYTES,
    VCF_FIXED_COLUMNS,
    ImportResult,
    _chunk_spans,
    _gz_windows,
    _header_complete,
    _parse_chunk_numpy,
    _parse_header,
    _stream_chunks,
)
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer
from pgen_tpu_torch.device import resolve_device, synchronize
from pgen_tpu_torch.ops.pack import pack_codes

log = get_logger("torch.vcf_import")


class _Packer:
    """pack_codes (K4) on one chunk's codes, through pinned buffers that
    grow to the largest chunk seen."""

    def __init__(self, dev: torch.device, timer: StageTimer):
        self.dev, self.timer = dev, timer
        self.cuda = dev.type == "cuda"
        self.codes_host = torch.empty(0, dtype=torch.uint8)
        self.packed_host = torch.empty(0, dtype=torch.uint8)

    @staticmethod
    def _grown(buf: torch.Tensor, n: int) -> torch.Tensor:
        """buf, or a pinned buffer a quarter larger than n when buf is too
        small (chunk sizes differ by a few lines)."""
        if buf.numel() >= n:
            return buf
        return torch.empty(n + n // 4, dtype=torch.uint8, pin_memory=True)

    def pack(self, codes: np.ndarray) -> np.ndarray:
        """(rows, N) u8 codes -> (rows, ceil(N/4)) u8 records on the host."""
        rows, n_samples = codes.shape
        if not self.cuda:
            with self.timer.stage("kernel", codes.nbytes):
                return pack_codes(torch.from_numpy(codes)).numpy()
        rec = (n_samples + 3) // 4
        with self.timer.stage("h2d", codes.nbytes):
            self.codes_host = self._grown(self.codes_host, codes.size)
            staged = self.codes_host[: codes.size].view(rows, n_samples)
            np.copyto(staged.numpy(), codes)
            dev_codes = staged.to(self.dev, non_blocking=True)
            synchronize(self.dev)
        with self.timer.stage("kernel", codes.nbytes):
            packed = pack_codes(dev_codes)
            synchronize(self.dev)
        with self.timer.stage("d2h", rows * rec):
            self.packed_host = self._grown(self.packed_host, rows * rec)
            out = self.packed_host[: rows * rec].view(rows, rec)
            out.copy_(packed, non_blocking=True)
            synchronize(self.dev)
        return out.numpy()


def import_vcf(
    vcf_path: str | Path,
    out_prefix: str | Path | None = None,
    device: str | torch.device = "cuda",
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> ImportResult:
    """Import a GT-bearing VCF (.vcf or .vcf.gz) into
    OUT_PREFIX.{pgen,pvar,psam} with the pack on ``device`` (``"cuda"``,
    which must be available, or ``"cpu"``).

    Same arguments (``device`` in place of ``provider``) and output bytes as
    pgen_tpu's ``import_vcf``; ``out_prefix`` defaults to the input path
    without ``.vcf[.gz]``.
    """
    vcf_path = str(vcf_path)
    dev = resolve_device(device)
    timer = StageTimer()

    if out_prefix is None:
        out_prefix = vcf_path
        for suf in (".vcf.gz", ".vcf"):
            if out_prefix.endswith(suf):
                out_prefix = out_prefix[: -len(suf)]
                break
    out_prefix = str(out_prefix)

    if vcf_path.endswith(".gz"):
        with timer.stage("read"):
            win_iter, total = _gz_windows(vcf_path, max(chunk_bytes, 8 << 20))
        with timer.stage("header"):
            head = np.zeros(0, dtype=np.uint8)
            for w in win_iter:
                head = w if not len(head) else np.concatenate([head, w])
                if _header_complete(head):
                    break
            comments, samples, body_start = _parse_header(head, vcf_path)
        chunks = _stream_chunks(head[body_start:], win_iter, chunk_bytes)
    else:
        with timer.stage("read"):
            buf = np.memmap(vcf_path, dtype=np.uint8, mode="r")
            total = buf.nbytes
        with timer.stage("header"):
            comments, samples, body_start = _parse_header(buf, vcf_path)
        if len(buf) > body_start and buf[-1] != ord("\n"):
            buf = np.concatenate([buf, np.array([ord("\n")], dtype=np.uint8)])
        chunks = (
            np.ascontiguousarray(buf[s:e]) for s, e in _chunk_spans(buf, body_start, chunk_bytes)
        )
    n_samples = len(samples)

    with timer.stage("psam"):
        with open(f"{out_prefix}.psam", "wb") as fh:
            fh.write(b"#IID\n")
            fh.write(("\n".join(samples) + "\n").encode())

    packer = _Packer(dev, timer)
    num_variants = 0
    with open(f"{out_prefix}.pvar", "wb") as pvar, open(f"{out_prefix}.pgen", "wb") as pgen:
        pvar.write(comments)
        pvar.write(("#" + "\t".join(VCF_FIXED_COLUMNS[:8]) + "\n").encode())
        pgen.write(PGEN_MAGIC + bytes([FIXED_WIDTH_STORAGE_MODE]))
        pgen.write(struct.pack("<II", 0, n_samples))  # variant count patched at end
        pgen.write(bytes([MODE2_FORMAT_BYTE]))
        for chunk in chunks:
            with timer.stage("parse", chunk.nbytes):
                codes, pvar_bytes, rows = _parse_chunk_numpy(
                    chunk, n_samples, vcf_path, num_variants
                )
            if not rows:
                continue
            packed = packer.pack(codes)
            with timer.stage("write", packed.nbytes + len(pvar_bytes)):
                pgen.write(packed)
                pvar.write(pvar_bytes)
            num_variants += rows
        pgen.seek(3)
        pgen.write(struct.pack("<I", num_variants))

    log.info("import (%s): %s", dev, timer.report())
    return ImportResult(
        out_prefix=out_prefix,
        num_variants=num_variants,
        num_samples=n_samples,
        bytes_read=total,
        timer=timer,
    )

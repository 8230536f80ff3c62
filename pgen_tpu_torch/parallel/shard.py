"""Variant shards of the filter to VCF, in one process or in worker
processes on one GPU: the port of ``pgen_tpu/parallel/shard.py``
(``filter --shards N [--shard-index I]``, ``--workers N [--resume]``).

Every process derives the same masks, kept rows and byte offset of every
output row from the metadata (``derive_row_layout``), so the ordered merge
is arithmetic: a shard writes its rows at their offsets of one shared
``.vcf``, or as a standalone part (BGZF parts for a ``.vcf.gz``, which the
parent concatenates in shard order and indexes). Copied verbatim from
pgen_tpu (only the imports differ): ``plan_shards``, ``_shard_part_path``,
``_manifest_path``, ``_write_manifest``, ``_concat_gz_parts``,
``_index_merged_gz``, and ``filter_to_vcf_parallel`` with the manifest,
the ``PGEN_TPU_TEST_FAIL_SHARD`` test hook and every message, changed in
two places only: it passes ``device`` to each worker and to
``_index_merged_gz`` (which takes it to count ``GT_*`` there), and its
``_record`` keeps the report each worker puts beside pgen_tpu's tuple,
which it returns on a ``ParallelFilterResult``. The port's own:

- ``filter_to_vcf_sharded``: pgen_tpu's layout arithmetic, its standalone
  and shared-file modes and BGZF parts, with each block's text made by the
  port's ``_BlockRows`` (``pipeline/filter.py``: gather, H2D, K2 keep-all
  or K3 kept samples, D2H, assembly) through the same emitters as the
  one-process filter (``emit_mapped``, ``emit_stream``). Every shard runs
  on the card ``device`` names (bare ``cuda``: the process's current card).
  Its row layout is ``pipeline/filter.py``'s ``derive_row_layout``: with
  ``provider="device"`` the ``GT_*`` predicates' genotypes are counted on
  that card (K8, K9, K14), in every shard and worker and again in
  ``_index_merged_gz``, as pgen_tpu counts them on its device; otherwise
  on the host (the native C++ counts, or numpy). The port's multi-card
  filter is ``--provider device`` without ``--shards`` or ``--workers``
  (``pipeline/mesh_filter.py``).
- ``_worker_entry``: pgen_tpu's, which also reports the worker's launches
  of K2, K3 and the counts K8, K9 and K14, the time it entered, its seconds of work, and its pinned host
  and peak device bytes; ``--stats`` prints one line a worker.
- ``_mp_context``: pgen_tpu's picks ``fork`` unless jax is loaded, for
  jax's threads. A worker of the port runs CUDA, and a process forked
  from a parent that has initialised CUDA cannot; nor is a fork safe from
  a parent whose torch (OpenMP) thread pool has run, which may hold its
  locks in the child, and the port imports torch with every module, so
  whether the parent's pool has run cannot be told from here. So the
  port starts its workers with ``forkserver`` (a server process started
  clean, which imports this module once and forks each worker from
  there), never ``fork``, unless ``PGEN_TPU_MP_CONTEXT`` names another
  method; a forced ``fork`` after CUDA was initialised raises. The parent
  never resolves the device: it hands each worker the device string.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from pgen_tpu_torch.device import resolve_device
from pgen_tpu_torch.pipeline.filter import (
    derive_row_layout,
    emit_mapped,
    emit_stream,
    plan_blocks,
)
from pgen_tpu_torch.pipeline.filter_host import (
    BGZF_EOF,
    FilterResult,
    _resolve_provider,
    _write_all,
    emit_tabix_index,
)
from pgen_tpu_torch.pipeline.vcf import DEFAULT_SOURCE_TAG
from pgen_tpu_torch.utils.log import get_logger
from pgen_tpu_torch.utils.timer import StageTimer

log = get_logger("torch.shard")


@dataclass
class ParallelFilterResult(FilterResult):
    """A ``--workers`` run's result: shard index -> the report its worker
    put on the queue (``_worker_entry``), for each shard run this time."""

    worker_reports: dict = field(default_factory=dict)


def _mp_context():
    """The multiprocessing context of the workers: ``forkserver``, or the
    method ``PGEN_TPU_MP_CONTEXT`` names. ``fork`` is refused once this
    process has initialised CUDA (the module docstring says why)."""
    import multiprocessing as mp

    forced = os.environ.get("PGEN_TPU_MP_CONTEXT")
    if forced == "fork" and torch.cuda.is_initialized():
        raise RuntimeError(
            "PGEN_TPU_MP_CONTEXT=fork: this process has initialised CUDA, which "
            "a forked worker cannot use; use forkserver or spawn"
        )
    ctx = mp.get_context(forced or "forkserver")
    if ctx.get_start_method() == "forkserver":
        # the server imports the workers' code once; each worker forks from it
        ctx.set_forkserver_preload([__name__])
    return ctx


# the kernels a shard can launch, whose counts a worker reports and --stats
# prints: the text (K2, K3) and the GT_* counts of provider="device" (K8,
# K9, K14)
REPORTED = ("genotype_text", "subset_text_from_packed", "gt_counts_device",
            "sample_counts_device", "gt_counts_masked")


def reported_wrappers() -> dict:
    """The wrapper of each kernel in ``REPORTED`` by name; its ``launches``
    counts its kernel's launches."""
    from pgen_tpu_torch.ops import gt_stats, gt_text

    return {name: getattr(gt_text, name, None) or getattr(gt_stats, name) for name in REPORTED}


def _worker_entry(result_q, index: int, kwargs: dict, inject_fail: bool = False) -> None:
    """Process entry point: run one shard, report its result on the queue.

    pgen_tpu's tuple (index, variants kept, samples kept, bytes written) is
    followed by this worker's report: its launches of K2, K3, K8, K9 and
    K14 (``REPORTED``, counted from 0 here, whatever a forked parent had
    counted), ``entered`` (the
    epoch second it started), ``seconds`` (its shard's wall), ``pinned``
    (its peak pinned host bytes) and ``device_peak`` (its peak device
    bytes), the last two 0 on the CPU. ``inject_fail`` is the test hook
    (PGEN_TPU_TEST_FAIL_SHARD, evaluated in the parent so it works under
    any start method).
    """
    entered = time.time()
    if inject_fail:
        raise RuntimeError(f"injected failure for shard {index} (test hook)")
    wrappers = reported_wrappers()
    for w in wrappers.values():
        w.launches = 0
    res = filter_to_vcf_sharded(**kwargs)
    dev = torch.device(kwargs.get("device", "cuda"))
    cuda = dev.type == "cuda" and torch.cuda.is_initialized()
    report = {
        **{name: w.launches for name, w in wrappers.items()},
        "entered": entered,
        "seconds": time.time() - entered,
        "pinned": torch.cuda.host_memory_stats().get("allocated_bytes.peak", 0) if cuda else 0,
        "device_peak": torch.cuda.max_memory_allocated(dev) if cuda else 0,
    }
    result_q.put(
        (
            index,
            res.num_variants_kept,
            res.num_samples_kept,
            res.bytes_written,
            report,
        )
    )


def _shard_part_path(out_file: str, index: int) -> str:
    return f"{out_file}.shard{index:04d}.part"


def _manifest_path(out_file: str) -> str:
    return f"{out_file}.manifest.json"


def _write_manifest(path: str, manifest: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)


def _concat_gz_parts(out_file: str, num_workers: int) -> int:
    """Concatenate standalone BGZF shard parts + EOF marker into out_file.

    BGZF members are independently decompressible, so byte concatenation
    of per-shard .gz streams is itself a valid BGZF file (SAM spec §4.1).
    """
    total = 0
    fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for i in range(num_workers):
            part = _shard_part_path(out_file, i)
            with open(part, "rb") as f:
                while True:
                    chunk = f.read(8 << 20)
                    if not chunk:
                        break
                    _write_all(fd, memoryview(chunk))
                    total += len(chunk)
        _write_all(fd, memoryview(BGZF_EOF))
        total += len(BGZF_EOF)
    finally:
        os.close(fd)
    for i in range(num_workers):
        os.unlink(_shard_part_path(out_file, i))
    return total


def filter_to_vcf_parallel(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    device: str = "cuda",
    num_workers: int = 2,
    block_variants: int = 1 << 16,
    resume: bool = False,
    index: bool = False,
    index_format: str = "auto",
) -> FilterResult:
    """Run the shards in parallel worker processes, one shard each.

    For plain .vcf output the single-file ordered merge needs no
    coordination: every worker derives the same offsets and pwrites its own
    byte range. For .vcf.gz each worker writes a standalone BGZF stream
    (compressed sizes aren't precomputable) and the parent concatenates the
    parts in shard order — BGZF members concatenate losslessly.

    A JSON manifest ({out}.manifest.json) tracks per-shard status; if some
    workers fail, rerunning with ``resume=True`` re-executes only the
    shards not marked done and completes the identical file. The manifest
    is removed on success. This is the single-host stand-in for the
    multi-host deployment (one process per host).
    """
    if num_workers <= 1:
        return filter_to_vcf_sharded(
            pfile_prefix,
            var_query=var_query,
            sam_query=sam_query,
            out_file=out_file,
            provider=provider,
            device=device,
            num_shards=1,
            block_variants=block_variants,
            index=index,
            index_format=index_format,
        )
    if index and not str(out_file or f"{pfile_prefix}.pgen-rs.vcf").endswith(".gz"):
        raise ValueError("--index requires a .gz (BGZF) output file")
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)
    gz = out_file.endswith(".gz")

    mpath = _manifest_path(out_file)
    params = {
        "pfile_prefix": str(pfile_prefix),
        "var_query": var_query,
        "sam_query": sam_query,
        "num_workers": num_workers,
        "gz": gz,
    }
    if resume and os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("params") != params:
            raise ValueError(
                f"{mpath} was written for different parameters; rerun "
                "without resume (or delete the manifest)"
            )
    else:
        manifest = {
            "version": 1,
            "params": params,
            "shards": [
                {"index": i, "status": "pending"} for i in range(num_workers)
            ],
        }
    _write_manifest(mpath, manifest)

    pending = [s["index"] for s in manifest["shards"] if s["status"] != "done"]
    ctx = _mp_context()
    result_q = ctx.Queue()
    procs = {}
    for i in pending:
        p = ctx.Process(
            target=_worker_entry,
            args=(
                result_q,
                i,
                dict(
                    pfile_prefix=pfile_prefix,
                    var_query=var_query,
                    sam_query=sam_query,
                    out_file=_shard_part_path(out_file, i) if gz else out_file,
                    provider=provider,
                    device=device,
                    num_shards=num_workers,
                    shard_index=i,
                    block_variants=block_variants,
                    standalone=gz,
                    gz=gz,
                ),
                os.environ.get("PGEN_TPU_TEST_FAIL_SHARD") == str(i),
            ),
        )
        p.start()
        procs[i] = p

    # Drain results as workers finish so done shards are checkpointed even
    # if a sibling later fails (a dead worker never reports, so poll
    # liveness instead of blocking on a fixed result count).
    import queue as queue_mod

    results = {}
    reports = {}

    def _record(item):
        idx, nv, ns, nbytes, report = item
        reports[idx] = report
        results[idx] = (nv, ns, nbytes)
        shard = manifest["shards"][idx]
        shard["status"] = "done"
        shard["bytes_written"] = nbytes
        shard["variants_kept"] = nv
        shard["samples_kept"] = ns
        _write_manifest(mpath, manifest)

    alive = set(procs)
    while alive:
        try:
            _record(result_q.get(timeout=0.1))
        except queue_mod.Empty:
            pass
        for i in list(alive):
            if not procs[i].is_alive():
                procs[i].join()
                alive.discard(i)
    # Results can trail the process exit: a clean worker flushes its queue
    # payload before exiting, but the parent may see the pipe readable only
    # after is_alive() already went false — one Empty window would then
    # mis-mark a finished shard as failed. Keep draining until every
    # zero-exit worker has reported (bounded, in case one exited 0 without
    # ever reporting).
    import time as time_mod

    deadline = time_mod.monotonic() + 10.0
    while (
        any(p.exitcode == 0 and i not in results for i, p in procs.items())
        and time_mod.monotonic() < deadline
    ):
        try:
            _record(result_q.get(timeout=0.2))
        except queue_mod.Empty:
            pass
    while True:  # final sweep of anything else buffered
        try:
            _record(result_q.get_nowait())
        except queue_mod.Empty:
            break

    failed = []
    for i, p in procs.items():
        p.join()
        if p.exitcode != 0 or i not in results:
            failed.append((i, p.exitcode))
            manifest["shards"][i]["status"] = "failed"
    if failed:
        _write_manifest(mpath, manifest)
        raise RuntimeError(
            f"shard workers failed: {failed}; completed shards are recorded "
            f"in {mpath} — rerun with resume=True (--resume) to finish"
        )

    done = [s for s in manifest["shards"] if s["status"] == "done"]
    # Shard counts: every worker computes the same global masks, so any
    # reporter's kept counts are authoritative; bytes sum over shards.
    nv = max((s["variants_kept"] for s in done), default=0)
    ns = max((s["samples_kept"] for s in done), default=0)
    if gz:
        parts = [_shard_part_path(out_file, i) for i in range(num_workers)]
        if all(os.path.exists(p) for p in parts):
            bytes_written = _concat_gz_parts(out_file, num_workers)
        elif os.path.exists(out_file) and not any(os.path.exists(p) for p in parts):
            # resume after a crash in the concat..manifest-unlink window:
            # the merge already completed (parts are consumed atomically
            # after the full write), so the file is the finished output
            bytes_written = os.path.getsize(out_file)
        else:
            raise RuntimeError(
                f"{out_file}: shard parts are incomplete but the manifest "
                "says all shards are done; delete the manifest and rerun"
            )
    else:
        bytes_written = os.path.getsize(out_file)
    # The filter itself is complete: drop the manifest BEFORE indexing so
    # an index failure (e.g. non-integer POS) can't strand an all-done
    # manifest whose parts were already consumed by the merge.
    os.unlink(mpath)
    if index:
        # The merged file is a complete BGZF stream; the parent re-derives
        # the row layout (one metadata predicate pass — a second genotype
        # pass only for GT_* queries) and indexes it.
        _index_merged_gz(
            out_file, pfile_prefix, var_query, sam_query, provider, index_format,
            device,
        )
    return ParallelFilterResult(
        out_path=out_file,
        num_variants_kept=nv,
        num_samples_kept=ns,
        bytes_written=bytes_written,
        timer=StageTimer(),
        worker_reports=reports,
    )


def _index_merged_gz(
    gz_path: str,
    pfile_prefix: str,
    var_query,
    sam_query,
    provider: str,
    index_format: str,
    device: str = "cuda",
) -> str:
    """Index a merged sharded .vcf.gz: re-derive the deterministic row
    layout (the same arithmetic every worker used) and emit .tbi/.csi."""
    from pgen_tpu_torch.pipeline.filter import derive_row_layout, emit_tabix_index

    lay = derive_row_layout(pfile_prefix, var_query, sam_query, provider, device=device)
    return emit_tabix_index(
        gz_path,
        lay.pvar,
        lay.var_idx,
        lay.prefix_sizes,
        lay.row_fixed,
        len(lay.header_bytes),
        fmt=index_format,
    )


def plan_shards(num_kept: int, num_shards: int) -> list:
    """Contiguous, balanced partition of kept-variant positions.

    Returns [(lo, hi)] with lo/hi indices into the kept-variant list; shard
    sizes differ by at most 1. Contiguity keeps each shard's .pgen reads a
    single byte range and the output merge order-preserving by construction.
    """
    bounds = [(num_kept * i) // num_shards for i in range(num_shards + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(num_shards)]


def filter_to_vcf_sharded(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    num_shards: int = 1,
    shard_index: int | None = None,
    block_variants: int = 1 << 16,
    source_tag: str = DEFAULT_SOURCE_TAG,
    standalone: bool = False,
    gz: bool | None = None,
    index: bool = False,
    index_format: str = "auto",
    device: str = "cuda",
) -> FilterResult:
    """Shard the kept variants over ``num_shards`` workers writing one VCF,
    the genotype text of each block made on ``device`` (``"cuda"``, which
    must be available, or ``"cpu"``).

    Same arguments and output bytes as pgen_tpu's ``filter_to_vcf_sharded``:
    with shard_index=None all shards run in this process (sequentially);
    otherwise only that shard's rows are written (plus the header, by shard
    0) into the common preallocated output file. With standalone=True the
    shard writes its own bytes from offset 0 of its own file (files
    concatenate to the full VCF in shard order). BGZF output (``gz=True``,
    default inferred from the .gz suffix) runs sequentially (EOF appended)
    or standalone (no EOF: the concatenating caller appends it); the
    shared-file mode cannot compress. ``provider="device"`` counts the
    ``GT_*`` predicates' genotypes on ``device`` (K8, K9, K14), over every
    row in each shard, as pgen_tpu's device provider does; ``auto`` counts
    them on the host.
    """
    provider = _resolve_provider(provider)
    dev = resolve_device(device)
    timer = StageTimer()
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)
    if gz is None:
        gz = out_file.endswith(".gz")
    if gz and shard_index is not None and not standalone:
        raise ValueError(
            "bgzf (.gz) output cannot target a shared sharded file "
            "(compressed offsets aren't precomputable); use "
            "filter_to_vcf_parallel (standalone parts) or a single shard"
        )
    if index and (not gz or shard_index is not None):
        raise ValueError(
            "--index with shards requires a complete .gz file "
            "(run all shards in one process, or use --workers)"
        )
    if block_variants < 1:
        raise ValueError(f"block_variants must be positive, got {block_variants}")

    lay = derive_row_layout(
        pfile_prefix, var_query, sam_query, provider, source_tag, timer, dev
    )
    var_idx = lay.var_idx
    header_bytes, prefix_sizes, row_fixed = lay.header_bytes, lay.prefix_sizes, lay.row_fixed

    # Every worker derives the same shard plan and byte offsets: the
    # order-preserving merge is pure arithmetic.
    shards = plan_shards(len(var_idx), num_shards)

    def shard_byte_start(lo: int) -> int:
        # bytes of all rows before kept-position lo
        return len(header_bytes) + int(prefix_sizes[lo]) + lo * row_fixed

    # Byte base: 0 for the shared file; the shard's own start offset when
    # writing a standalone per-shard file (header only in shard 0's file).
    base = 0
    local_total = lay.total
    if standalone:
        if shard_index is None:
            raise ValueError("standalone mode needs an explicit shard_index")
        s_lo, s_hi = shards[shard_index]
        base = 0 if shard_index == 0 else shard_byte_start(s_lo)
        local_total = shard_byte_start(s_hi) - base

    my_shards = range(num_shards) if shard_index is None else [shard_index]
    emits_header = shard_index is None or shard_index == 0
    blocks = []
    for si in my_shards:
        lo, hi = shards[si]
        pos = shard_byte_start(lo) - base
        planned = plan_blocks(lay, lo, hi, pos, block_variants)
        end = planned[-1][2] + planned[-1][3] if planned else pos
        if end != shard_byte_start(hi) - base:
            raise RuntimeError("shard offset accounting bug")
        blocks += planned

    if gz:
        from pgen_tpu_torch.native import HAVE_NATIVE

        if not HAVE_NATIVE:
            raise RuntimeError(
                "bgzf (.gz) output requires the native runtime (C++ toolchain)"
            )
        # Compressed sizes are unknowable up front: stream-append BGZF
        # members in shard order instead of writing at fixed offsets.
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            written = emit_stream(lay, dev, blocks, fd, True, timer,
                                  header_bytes if emits_header else None,
                                  eof=shard_index is None)
        finally:
            os.close(fd)
        if index:
            with timer.stage("index"):
                emit_tabix_index(
                    out_file, lay.pvar, var_idx, prefix_sizes, row_fixed,
                    len(header_bytes), fmt=index_format,
                )
        log.info("filter shards (%s): %s", dev, timer.report())
        return FilterResult(
            out_path=out_file,
            num_variants_kept=len(var_idx),
            num_samples_kept=len(lay.sam_idx),
            bytes_written=written,
            timer=timer,
        )

    # Blocks format directly into the mapped file, as the one-process
    # filter does. In shared-file mode each shard maps the same file and
    # writes disjoint ranges; ftruncate only when the size differs, so an
    # existing same-size output keeps its pages and a sibling's rows.
    import mmap as mmap_mod

    fd = os.open(out_file, os.O_RDWR | os.O_CREAT, 0o644)
    written = 0
    try:
        if os.fstat(fd).st_size != local_total:
            os.ftruncate(fd, local_total)
        if local_total > 0:
            mm = mmap_mod.mmap(fd, local_total)
            out_arr = np.frombuffer(mm, dtype=np.uint8)
            try:
                if emits_header:
                    out_arr[: len(header_bytes)] = np.frombuffer(header_bytes, dtype=np.uint8)
                    written += len(header_bytes)
                emit_mapped(lay, dev, blocks, out_arr, timer)
                written += sum(b[3] for b in blocks)
            finally:
                out_arr = None
                try:
                    mm.close()
                except BufferError:
                    # an in-flight exception's traceback can pin a view of
                    # the mapping; let the original error propagate (the
                    # mapping is released when the frames are collected)
                    pass
    finally:
        os.close(fd)

    log.info("filter shards (%s): %s", dev, timer.report())
    return FilterResult(
        out_path=out_file,
        num_variants_kept=len(var_idx),
        num_samples_kept=len(lay.sam_idx),
        bytes_written=written,  # header already counted when emitted
        timer=timer,
    )

"""``pca --approx`` with its subspace kept on the device, and the bulk
``.eigenvec`` writer.

On the CPU (the kernels' plain versions): the port's ``pca_approx`` against
the benchmark's plain reference (``benchmark/reference/pca_approx.py``:
the same subspace iteration from the same start, float64) on seeded
records, held to the ``pca_approx`` traffic's own limits; planted faults in
the port fail them. The writer's text is the f-string a value that it
replaced, byte for byte, on the C++ runtime's path and on its fallback.
On a card (skipped without one): K13's pass at UK Biobank's 488,377
samples against its plain version. The file imports no jax, so that its
card test runs with ``--noconftest``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.reference import pca_approx as ref  # noqa: E402
from pgen_tpu_torch.native import HAVE_NATIVE  # noqa: E402
from pgen_tpu_torch.ops import pca as port_pca  # noqa: E402
from pgen_tpu_torch.ops.pack import subset_repack_plain  # noqa: E402
from pgen_tpu_torch.pipeline import pca as port_pipeline  # noqa: E402

TRAFFIC = json.loads((Path(__file__).resolve().parents[1]
                      / "benchmark/traffic/pca_approx.json").read_text())
LIMITS = {k: v for k, v in TRAFFIC["limits"].items() if k != "eigenvec_bytes_wrong"}
K, ITERS = 4, 8


def _records(n_var, n_samples, seed):
    """Uniform record bytes, as the benchmark's filesets draw them."""
    rec = (2 * n_samples + 7) // 8
    return np.random.default_rng(seed).integers(0, 256, (n_var, rec), dtype=np.uint8)


def _numbers(got, records, n_samples, seed):
    """The traffic's two numbers of ``got`` against the reference run on
    the same records (a cohort's re-packed) from the same start."""
    recs = ref.on_device(records, "cpu")
    vals, vecs = ref.subspace_pca(recs, n_samples, K, ITERS, 8, seed)
    return ref.compare([(got.eigenvalues, got.eigenvectors)], recs, n_samples, vals, vecs)[0]


@pytest.mark.parametrize("n_samples,n_var,block", [(37, 700, 128), (61, 900, 256),
                                                   (200, 1500, 512), (403, 1200, 1 << 14)])
def test_pca_approx_matches_the_benchmark_reference(n_samples, n_var, block):
    """S % 4 = 1, 1, 0, 3; several blocks a pass and one."""
    records = _records(n_var, n_samples, n_samples)
    got = port_pca.pca_approx(records, n_samples, K, "cpu", block_variants=block, iters=ITERS,
                              seed=n_samples + 1)
    numbers = _numbers(got, records, n_samples, n_samples + 1)
    assert all(numbers[k] <= v for k, v in LIMITS.items()), numbers
    assert got.eigenvectors.shape == (n_samples, K) and got.m_used > 0


def test_pca_approx_of_a_cohort_matches_the_reference_on_its_records():
    """A cohort (unsorted, a gap): the reference runs on the cohort's own
    records, re-packed."""
    n_samples = 90
    records = _records(1000, n_samples, 3)
    idx = np.random.default_rng(4).permutation(n_samples)[:53].astype(np.int32)
    got = port_pca.pca_approx(records, n_samples, K, "cpu", block_variants=300, iters=ITERS,
                              sample_idx=idx, seed=9)
    mine = subset_repack_plain(torch.from_numpy(records), torch.from_numpy(idx)).numpy()
    numbers = _numbers(got, mine, len(idx), 9)
    assert all(numbers[k] <= v for k, v in LIMITS.items()), numbers


def _drop_last_block(inner):
    def blocks(records, dev, rows, *args):
        out = list(inner(records, dev, rows, *args))
        return iter(out[:-1])
    return blocks


def _rr_unscaled(inner):
    def pass_maker(*args, **kw):
        fn = inner(*args, **kw)
        calls = []

        def pass_fn(q):
            y, m = fn(q)
            calls.append(1)
            return (y, 1) if len(calls) == ITERS + 1 else (y, m)
        return pass_fn
    return pass_maker


@pytest.mark.parametrize("fault", ["a pass skipped", "a block dropped from each pass",
                                   "Rayleigh-Ritz on an unscaled y", "a column negated"])
def test_planted_faults_fail_the_traffic_checks(fault, monkeypatch):
    n_samples = 61
    records = _records(900, n_samples, 5)
    iters = ITERS - 1 if fault == "a pass skipped" else ITERS
    if fault == "a block dropped from each pass":
        monkeypatch.setattr(port_pca, "stage_blocks", _drop_last_block(port_pca.stage_blocks))
    elif fault == "Rayleigh-Ritz on an unscaled y":
        monkeypatch.setattr(port_pca, "_make_approx_pass",
                            _rr_unscaled(port_pca._make_approx_pass))
    got = port_pca.pca_approx(records, n_samples, K, "cpu", block_variants=256, iters=iters,
                              seed=2)
    if fault == "a column negated":  # the sign rule broken for one column
        got.eigenvectors[:, 1] *= -1
    numbers = _numbers(got, records, n_samples, 2)
    assert any(numbers[k] > v for k, v in LIMITS.items()), numbers


def test_no_subspace_crosses_to_the_host():
    """The pass's y and the subspace stay tensors on the device: one d2h
    span of the k pairs, and approx_pass, orth and rayleigh_ritz spans
    under the caller's stage."""
    from pgen_tpu_torch.utils.timer import StageTimer

    timer = StageTimer()
    with timer.stage("pca_approx"):
        port_pca.pca_approx(_records(600, 41, 8), 41, K, "cpu", block_variants=256,
                            iters=ITERS, seed=1, timer=timer)
    n = 41
    st = timer.stages
    assert st["approx_pass"].calls == ITERS + 1
    assert st["approx_pass"].bytes_moved == (ITERS + 1) * 600 * ((2 * n + 7) // 8)
    assert st["stage_read"].calls == st["h2d"].calls == st["kernels"].calls == 3 * (ITERS + 1)
    assert st["orth"].calls == ITERS + 1 and st["rayleigh_ritz"].calls == 1
    assert st["d2h"].calls == 1 and st["d2h"].bytes_moved == (K + n * K) * 8
    parents = {sp.name: timer.spans[sp.parent].name for sp in timer.spans if sp.parent is not None}
    assert parents == {"approx_pass": "pca_approx", "stage_read": "approx_pass",
                       "h2d": "approx_pass", "kernels": "approx_pass", "orth": "pca_approx",
                       "rayleigh_ritz": "pca_approx", "d2h": "pca_approx"}
    # the steps between the passes are timed on the device, which on the
    # CPU is the host's time; the passes are not
    assert timer.device_seconds("orth") == pytest.approx(st["orth"].seconds)
    assert timer.device_seconds("rayleigh_ritz") == pytest.approx(st["rayleigh_ritz"].seconds)
    assert timer.device_seconds("approx_pass") is None


@pytest.mark.cuda
def test_device_seconds_are_the_work_queued_in_the_span():
    """On a card a span's device time is the work queued inside it, which
    its host time does not wait for: a sleep kernel queued behind another
    reads one sleep's time, neither 0 nor two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pgen_tpu_torch.utils.timer import StageTimer, span

    dev = torch.device("cuda", 0)
    cycles = int(torch.cuda.get_device_properties(dev).clock_rate * 1e3 * 0.02)
    torch.cuda._sleep(cycles)  # the clocks up
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    one = begin.elapsed_time(end) / 1e3  # a sleep kernel's time alone
    timer = StageTimer()
    with timer.stage("outer"):
        torch.cuda._sleep(cycles)  # queued before the span: not its time
        with span("slept", device=dev):
            torch.cuda._sleep(cycles)
    assert timer.stages["slept"].seconds < one / 2
    assert 0.8 * one < timer.device_seconds("slept") < 1.2 * one
    assert timer.device_seconds("outer") is None


# -0.0, integers, 1e-5 and 1e+17 scales, exact ties at the tenth digit, the
# switches between fixed and exponent forms, subnormals, inf and nan
SPECIAL = [-0.0, 0.0, 3.0, -2.0, 1e-5, 2.5e-5, -1.25e-5, 1e17, -3.3e17, 1234567890.5,
           1234567891.5, -0.1234567890625, 1e-10, 9.99999999949e9, 9999999999.5, 1e10,
           1.0000000005e-10, 0.0001, 9.9999999995e-5, 5e-324, 2.2250738585072014e-308,
           1.7976931348623157e308, float("inf"), float("-inf"), float("nan")]


def _values(n_rows, k, seed):
    rng = np.random.default_rng(seed)
    v = 10.0 ** rng.uniform(-13, 19, (n_rows, k)) * rng.choice([-1.0, 1.0], (n_rows, k))
    v[: n_rows // 2] = rng.standard_normal((n_rows // 2, k)) / 700.0  # eigenvector scale
    flat = v.reshape(-1)
    n = min(len(SPECIAL), flat.size)
    flat[:n] = SPECIAL[:n]
    return v


def _fstring_text(iids, vecs):
    """The writer it replaced: one f-string a value."""
    return "".join(iid + "\t" + "\t".join(f"{vecs[r, c]:.10g}" for c in range(vecs.shape[1]))
                   + "\n" for r, iid in enumerate(iids)).encode()


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
@pytest.mark.parametrize("n_rows,k", [(1, 1), (7, 3), (5000, 10), (997, 40)])
def test_eigenvec_text_is_the_fstring_text(native, n_rows, k, monkeypatch):
    if native and not HAVE_NATIVE:
        pytest.skip("the C++ runtime did not build here")
    monkeypatch.setattr(port_pipeline, "HAVE_NATIVE", native)
    vecs = _values(n_rows, k, n_rows + k)
    iids = [f"per{i}" if i % 3 else f"fam_{i}_é" for i in range(n_rows)]
    got = port_pipeline.eigenvec_text(iids, vecs)
    assert bytes(got) == _fstring_text(iids, vecs)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_write_eigenvec_is_the_old_file(native, tmp_path, monkeypatch):
    if native and not HAVE_NATIVE:
        pytest.skip("the C++ runtime did not build here")
    monkeypatch.setattr(port_pipeline, "HAVE_NATIVE", native)
    vecs = _values(300, 10, 1)
    iids = [f"per{i}" for i in range(300)]
    port_pipeline.write_eigenvec(str(tmp_path / "x.eigenvec"), iids, vecs)
    head = ("#IID\t" + "\t".join(f"PC{i + 1}" for i in range(10)) + "\n").encode()
    assert (tmp_path / "x.eigenvec").read_bytes() == head + _fstring_text(iids, vecs)


@pytest.mark.skipif(not HAVE_NATIVE, reason="the C++ runtime did not build here")
@pytest.mark.parametrize("threads", [1, 3, 64])
def test_native_rows_split_over_threads(threads):
    from pgen_tpu_torch.native import native

    vecs = _values(50, 6, 4)
    iids = [f"s{i}" * (i % 4 + 1) for i in range(50)]
    prefix = np.frombuffer(("\t".join(iids) + "\t").encode(), dtype=np.uint8)
    off = np.zeros(51, dtype=np.int64)
    off[1:] = np.flatnonzero(prefix == 9) + 1
    assert bytes(native.format_g10_rows(vecs, prefix, off, threads)) == _fstring_text(iids, vecs)
    with pytest.raises(ValueError):
        native.format_g10_rows(vecs, prefix, off[:-1], threads)


@pytest.mark.cuda
def test_pca_approx_pass_at_uk_biobank_width():
    """K13's pass at 488,377 samples (q's rows staged in 191 chunks a group
    of rows) against its plain version, from a y0 at the scale of y: used
    exact, y within ``approx_pass_tolerance``, a second pass equal bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    n_samples = 488_377
    host = _records(300, n_samples, 23)
    host[-4:] = np.array([0x00, 0x55, 0xAA, 0xFF], dtype=np.uint8)[:, None]  # constant rows
    packed = torch.from_numpy(host).to(dev)
    q = torch.randn((n_samples, 18), device=dev, generator=torch.Generator(dev).manual_seed(3))
    scale = torch.zeros((n_samples, 18), device=dev)
    port_pca.pca_approx_pass_plain(packed, n_samples, q, scale,
                                   torch.zeros((), dtype=torch.int64, device=dev))
    y0 = torch.randn(scale.shape, device=dev) * float(scale.std())
    got, want = y0.clone(), y0.clone()
    used, used_plain = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
    port_pca.pca_approx_pass(packed, n_samples, q, got, used)
    port_pca.pca_approx_pass_plain(packed, n_samples, q, want, used_plain)
    assert int(used) == int(used_plain) == 297
    tol = port_pca.approx_pass_tolerance(packed, n_samples, q, y0)
    assert bool(((got.double() - want.double()).abs() <= tol).all())
    again = y0.clone()
    port_pca.pca_approx_pass(packed, n_samples, q, again, torch.zeros_like(used))
    assert torch.equal(again, got)

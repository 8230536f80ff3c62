"""PCA by randomized subspace iteration (``pgen_tpu_torch.pipeline.pca.pca``
with ``approx=True``): every variant and sample, ``k`` components from
``iters`` passes and one more (Rayleigh-Ritz), the start drawn from the
run's seed. Every job's eigenpairs are checked, and a seeded share of the
last job's ``.eigenvec`` rows byte for byte."""

from __future__ import annotations

import numpy as np

from benchmark.fileset import rng_for
from benchmark.reference import pca_approx as ref
from benchmark.reference.fileset import read_iids, read_output, read_records
from benchmark.roofline import pca_approx as roofline

DEVICE_TIMED = ("orth", "rayleigh_ritz")


class Job:
    def __init__(self, ctx):
        from pgen_tpu_torch.pipeline.pca import pca

        self.ctx, self.entry = ctx, pca
        self.seed = ctx.seed % (1 << 63)  # the start's, for the program and the reference
        self.out = ctx.out_dir / "pca"
        self.answers = []

    def run(self, i: int):
        t = self.ctx.traffic
        res = self.entry(str(self.ctx.prefix), k=t["k"], out_prefix=str(self.out),
                         device=str(self.ctx.device), approx=True, approx_iters=t["iters"],
                         seed=self.seed)
        if i >= 0:
            self.answers.append((res.eigenvalues, res.eigenvectors))
        stages = {k: v.seconds for k, v in res.timer.stages.items()}
        # the steps between the passes, timed on the device where the
        # program times them there (``StageTimer.device_seconds``)
        device_seconds = getattr(res.timer, "device_seconds", None)
        for name in DEVICE_TIMED if device_seconds else ():
            seconds = device_seconds(name)
            if seconds is not None:
                stages[f"device:{name}"] = seconds
        return stages, roofline.least_seconds(self.ctx.config, t,
                                              {"rows": res.num_variants})

    def check(self, control: bool = False):
        t = self.ctx.traffic
        records, num_samples = read_records(self.ctx.prefix)
        recs = ref.on_device(records, self.ctx.device)
        args = (recs, num_samples, t["k"], t["iters"], t["oversample"], self.seed)
        vals, vecs = ref.subspace_pca(*args)
        answers = self.answers
        if control:
            import torch

            answers = [ref.subspace_pca(*args, dtype=torch.float32, tf32=True)]
        got = ref.compare(answers, recs, num_samples, vals, vecs)
        for g in got:
            g["eigenvec_bytes_wrong"] = 0
        if not control and answers:
            got[-1]["eigenvec_bytes_wrong"] = self._eigenvec_rows_wrong(answers[-1][1])
        limits = t["limits"]
        numbers = {name: 0.0 for name in limits}
        failed = 0
        for g in got:
            failed += any(g[name] > limits[name] for name in limits)
            numbers = {name: max(numbers[name], g[name]) for name in limits}
        return len(answers), failed, numbers

    def _eigenvec_rows_wrong(self, vecs) -> int:
        """Lines wrong among the header and a seeded eighth of the rows of
        the last job's ``.eigenvec``, against Python's f"{x:.10g}" of its
        eigenvectors, plus any lines missing or extra."""
        text = read_output(f"{self.out}.eigenvec")
        iids = read_iids(self.ctx.prefix)
        if text is None:
            return len(iids) + 1
        lines = text.split(b"\n")
        wrong = abs(len(lines) - (len(iids) + 2)) + (lines[-1] != b"")
        k = self.ctx.traffic["k"]
        wrong += lines[0] != ("#IID\t" + "\t".join(f"PC{i + 1}" for i in range(k))).encode()
        share = self.ctx.traffic["checked_share"]
        rows = np.sort(rng_for(self.ctx.seed, "eigenvec").choice(
            len(iids), size=max(1, int(len(iids) * share)), replace=False))
        vecs = np.asarray(vecs, dtype=np.float64)
        if vecs.shape != (len(iids), k):
            return wrong + len(rows)
        want = ref.eigenvec_rows(iids, vecs, rows)
        return int(wrong + sum(r + 1 >= len(lines) or lines[r + 1] != w
                               for r, w in zip(rows.tolist(), want)))

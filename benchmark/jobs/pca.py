"""Exact PCA (``pgen_tpu_torch.pipeline.pca.pca``): the GRM of every
variant and sample, then its top ``k`` eigenpairs; every job's eigenpairs
are checked."""

from __future__ import annotations

import torch

from benchmark.reference import pca as ref
from benchmark.reference.fileset import read_records
from benchmark.roofline import pca as roofline


class Job:
    def __init__(self, ctx):
        from pgen_tpu_torch.pipeline.pca import pca

        self.ctx, self.entry = ctx, pca
        self.answers = []

    def run(self, i: int):
        res = self.entry(str(self.ctx.prefix), k=self.ctx.traffic["k"],
                         out_prefix=str(self.ctx.out_dir / "pca"), device=str(self.ctx.device))
        if i >= 0:
            self.answers.append((res.eigenvalues, res.eigenvectors))
        stages = {k: v.seconds for k, v in res.timer.stages.items()}
        return stages, roofline.least_seconds(self.ctx.config, self.ctx.traffic,
                                              {"used_rows": res.num_used})

    def check(self, control: bool = False):
        records, num_samples = read_records(self.ctx.prefix)
        k = self.ctx.traffic["k"]
        g = ref.grm(records, num_samples, self.ctx.device)
        vals, _ = ref.top_eigen(g, k)
        answers = self.answers
        if control:
            answers = [ref.top_eigen(ref.grm(records, num_samples, self.ctx.device, torch.float32),
                                     k)]
        limits = self.ctx.traffic["limits"]
        numbers = {name: 0.0 for name in limits}
        failed = 0
        for v, u in answers:
            got = ref.compare(v, u, g, vals)
            failed += any(got[name] > limits[name] for name in limits)
            numbers = {name: max(numbers[name], got[name]) for name in limits}
        return len(answers), failed, numbers

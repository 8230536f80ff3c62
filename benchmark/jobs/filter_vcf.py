"""Filter to VCF by the device provider
(``pgen_tpu_torch.pipeline.mesh_filter.filter_to_vcf_mesh``): the rows
whose ALT is the traffic's allele and ``samples_per_job`` samples drawn for
each job from the seed. Every job writes a new file, as a pipeline writes
each job's output anew; a seeded share of the jobs (and the first) keep
theirs for the check, as does the last, and each other job's file is
removed once the next job has written its own. No job overwrites an
earlier job's file, whose pages the host may still be writing back."""

from __future__ import annotations

from benchmark.fileset import rng_for
from benchmark.reference import filter_vcf as ref
from benchmark.reference.fileset import lines_wrong, read_iids, read_output, read_pvar, read_records
from benchmark.roofline import filter_vcf as roofline


class Job:
    def __init__(self, ctx):
        from pgen_tpu_torch.pipeline.mesh_filter import filter_to_vcf_mesh

        self.ctx, self.entry = ctx, filter_to_vcf_mesh
        self.iids = read_iids(ctx.prefix)
        self.answers = {}  # job -> (output path, samples)
        self.last = None

    def samples(self, i: int) -> list:
        n = self.ctx.config["num_samples"]
        k = self.ctx.traffic["samples_per_job"]
        return sorted(rng_for(self.ctx.seed, f"samples{i}").choice(n, k, replace=False).tolist())

    def kept_apart(self, i: int) -> bool:
        """Whether job ``i`` is one of the seeded share checked on its own."""
        share = self.ctx.traffic["checked_share"]
        return bool(rng_for(self.ctx.seed, f"checked{i}").random() < share)

    def run(self, i: int):
        samples = self.samples(i)
        apart = i == 0 or i > 0 and self.kept_apart(i)
        out = self.ctx.out_dir / (f"job{i}.vcf" if i >= 0 else "warmup.vcf")
        res = self.entry(str(self.ctx.prefix), f'ALT == "{self.ctx.traffic["alt"]}"',
                         " || ".join(f'IID == "{self.iids[s]}"' for s in samples),
                         out_file=str(out), device=str(self.ctx.device))
        # every rank has written this job's rows (the entry ends at its
        # barrier), so no rank still writes the file removed here
        if self.ctx.rank == 0:
            if i < 0:
                out.unlink(missing_ok=True)
            elif self.last is not None and self.last[0] not in self.answers:
                self.last[1].unlink(missing_ok=True)
        if i >= 0:
            if apart:
                self.answers[i] = (out, samples)
            self.last = (i, out, samples)
        info = {"kept_rows": res.num_variants_kept,
                "kept_record_bytes": len({s >> 2 for s in samples})}
        stages = {k: v.seconds for k, v in res.timer.stages.items()}
        return stages, roofline.least_seconds(self.ctx.config, self.ctx.traffic, info)

    def check(self, control: bool = False):
        answers = dict(self.answers)
        if self.last is not None:
            answers[self.last[0]] = self.last[1:]
        records, _ = read_records(self.ctx.prefix)
        pvar = read_pvar(self.ctx.prefix)
        alt = self.ctx.traffic["alt"].encode()
        limit = self.ctx.traffic["limits"]["vcf_rows_wrong"]
        wrong, failed = 0, 0
        for _, (out, samples) in sorted(answers.items()):
            want = ref.expected_vcf(records, pvar, self.iids, alt, samples)
            got = (ref.expected_vcf(records, pvar, self.iids, alt, samples, control=True)
                   if control else read_output(out))
            w = lines_wrong(got, want)
            wrong += w
            failed += w > limit
        return len(answers), failed, {"vcf_rows_wrong": wrong}

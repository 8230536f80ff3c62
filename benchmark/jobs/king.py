"""KING table over every variant and sample
(``pgen_tpu_torch.pipeline.king.king_table``) with a kinship threshold.
Every job writes its own ``.kin0``, and every one is checked; the count
matrices the last job returns are checked too."""

from __future__ import annotations

import numpy as np

from benchmark.reference import king as ref
from benchmark.reference.fileset import lines_wrong, read_iids, read_output, read_records
from benchmark.roofline import king as roofline


def entries_wrong(got, want: np.ndarray) -> int:
    """Entries that differ (NaN equal to NaN); every entry on a shape
    mismatch."""
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape:
        return want.size
    return int(np.count_nonzero(~((got == want) | (np.isnan(got) & np.isnan(want)))))


class Job:
    def __init__(self, ctx):
        from pgen_tpu_torch.pipeline.king import king_table

        self.ctx, self.entry = ctx, king_table
        self.outputs = []
        self.last = None

    def run(self, i: int):
        out = self.ctx.out_dir / f"king{i}.kin0"
        res = self.entry(str(self.ctx.prefix), out_file=str(out), device=str(self.ctx.device),
                         min_kinship=self.ctx.traffic["min_kinship"])
        if i >= 0:
            self.outputs.append(out)
            self.last = (res.kinship, res.ibs0, res.nsnp)
        stages = {k: v.seconds for k, v in res.timer.stages.items()}
        return stages, roofline.least_seconds(self.ctx.config, self.ctx.traffic, {})

    def check(self, control: bool = False):
        records, num_samples = read_records(self.ctx.prefix)
        iids = read_iids(self.ctx.prefix)
        cnt = ref.counts(records, num_samples, self.ctx.device)
        kin, ibs0 = ref.kinship(cnt)
        min_kinship = self.ctx.traffic["min_kinship"]
        want = ref.kin0_bytes(iids, cnt, kin, ibs0, min_kinship)
        if control:
            kin_c, ibs0_c = ref.kinship(cnt, np.float32)
            files = [ref.kin0_bytes(iids, cnt, kin_c, ibs0_c, min_kinship)]
            last = (kin_c, ibs0_c, cnt["nsnp"])
        else:
            files = [read_output(p) for p in self.outputs]
            last = self.last
        limit = self.ctx.traffic["limits"]["king_mismatches"]
        per_job = [lines_wrong(got, want) for got in files]
        per_job[-1] += sum(entries_wrong(g, w) for g, w in zip(last, (kin, ibs0, cnt["nsnp"])))
        return len(files), sum(w > limit for w in per_job), {"king_mismatches": sum(per_job)}

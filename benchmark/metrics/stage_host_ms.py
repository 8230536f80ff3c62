"""Host compute a job that neither moves its input nor writes its output
(rank 0's StageTimer): king's kinship and threshold selection, pca's eigh,
in ms a job."""

from benchmark.metrics._stages import ms_a_job

STAGES = ("kinship", "king_select", "eigh")


def read(run):
    return ms_a_job(run, STAGES)

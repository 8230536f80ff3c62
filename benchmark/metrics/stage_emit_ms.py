"""Host time a job spends on its output (rank 0's StageTimer): the copy
back, row assembly, compression, writes and the text emission of the
analytics, in ms a job."""

from benchmark.metrics._stages import ms_a_job

STAGES = ("d2h", "assemble", "compress", "pwrite", "king_emit", "emit")


def read(run):
    return ms_a_job(run, STAGES)

"""Host time a job spends getting its input to the card (rank 0's
StageTimer): the metadata, the predicates, the gather or staging read of
the records, and their copy to the card, in ms a job."""

from benchmark.metrics._stages import ms_a_job

STAGES = ("metadata_load", "predicates", "gather", "stage_read", "h2d")


def read(run):
    return ms_a_job(run, STAGES)

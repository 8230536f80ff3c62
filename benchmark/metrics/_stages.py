"""Shared by the stage metrics: rank 0's StageTimer seconds of some stages,
summed, in ms a job."""


def ms_a_job(run, names: tuple):
    seen = [sum(s for k, s in job.items() if k in names) for job in run.stages
            if any(k in names for k in job)]
    if not seen:
        return None
    return 1000.0 * sum(seen) / run.jobs

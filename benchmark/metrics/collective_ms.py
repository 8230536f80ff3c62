"""Device time of NCCL's kernels on rank 0's card, in ms a job; nothing
where no collective ran."""


def read(run):
    t = run.ranks[0]["trace"]
    if t is None or t["nccl_s"] <= 0:
        return None
    return 1000.0 * t["nccl_s"] / run.jobs

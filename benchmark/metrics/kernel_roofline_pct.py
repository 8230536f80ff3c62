"""The jobs' least device time (``roofline/``) over the device time of
every kernel the program launched in the window on every card, NCCL's
left out, in %."""


def read(run):
    traces = [r["trace"] for r in run.ranks]
    if any(t is None for t in traces):
        return None
    kernel_s = sum(t["kernel_s"] for t in traces)
    if kernel_s <= 0 or not run.least_s:
        return None
    return 100.0 * sum(run.least_s) / kernel_s

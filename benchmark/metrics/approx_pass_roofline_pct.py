"""The jobs' least device time for their ``pca --approx`` passes
(``roofline/pca_approx.py``) over the device time of K13's pass kernels on
rank 0's card, read by name from the trace's ``device_ops``, in %. None
where any of the three kernels is not among them."""

KERNELS = ("pca_zq_kernel", "pca_zty_kernel", "pca_sum_kernel")


def read(run):
    t = run.ranks[0]["trace"]
    if t is None or not run.least_s:
        return None
    ops = {name.rsplit("::", 1)[-1]: s for name, s in t["device_ops"]}
    if any(ops.get(name, 0) <= 0 for name in KERNELS):
        return None
    return 100.0 * sum(run.least_s) / sum(ops[name] for name in KERNELS)

"""Device time a ``pca --approx`` job spends between its passes, on rank
0's card: each pass's scale and QR (``orth``) and the Rayleigh-Ritz step
(``rayleigh_ritz``), timed by the program with events on the card's stream
at each span's edges (``StageTimer.device_seconds``: from the end of the
pass before to the end of the step's own work), in ms a job. None where the
program does not time them on the device.
"""

from benchmark.metrics._stages import ms_a_job

STAGES = ("device:orth", "device:rayleigh_ritz")


def read(run):
    return ms_a_job(run, STAGES)

"""Host time from the process's start to the window's: imports, the
kernels' library, the fileset, the process group and the warm-up job."""


def read(run):
    return run.setup_s

"""The fileset variants of every job the window completed, over the host
time from the window's start to the end of its last job."""


def read(run):
    return run.jobs * run.cell.config["num_variants"] / run.window_s

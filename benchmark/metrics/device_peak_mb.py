"""The most device memory PyTorch held allocated during the window (its
peak reset at the window's start), on the fullest card, in MB (10^6 B)."""


def read(run):
    peak = max(r["window_peak_bytes"] for r in run.ranks)
    return peak / 1e6 if peak > 0 else None

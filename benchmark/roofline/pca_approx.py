"""Least device time of a ``pca --approx`` job: each of its ``iters`` + 1
passes makes y = Z^T (Z q) over the rows it reads, 4 S L FLOP a row in
fp32 (two products of 2 S L), against reading the records once and q and
writing y, (S, L) fp32 each; L = min(S, k + oversample). Only the passes
count: the QR and Rayleigh-Ritz steps between them are (S, L) work."""

from benchmark.fileset import record_size
from benchmark.roofline.peaks import HBM_BYTES_PER_S

# NVIDIA H100 Tensor Core GPU data sheet, SXM: FP32 67 TFLOPS (outside the
# tensor cores, which the pass's FMAs do not use)
FP32_FLOP_PER_S = 67e12


def least_seconds(config: dict, traffic: dict, info: dict) -> float:
    s = config["num_samples"]
    width = min(s, traffic["k"] + traffic["oversample"])
    rows = info["rows"]
    flop = 4 * s * width * rows
    nbytes = rows * record_size(s) + 2 * s * width * 4
    return (max(1, traffic["iters"]) + 1) * max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)

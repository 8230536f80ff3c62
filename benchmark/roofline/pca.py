"""Least device time of an exact GRM: Z'Z in float64 over the used
variants, its triangle only (S (S + 1) FLOP a variant), at the fp64 peak,
against reading the records once and writing the (S, S) float64 GRM."""

from benchmark.roofline.peaks import FP64_FLOP_PER_S, HBM_BYTES_PER_S


def least_seconds(config: dict, traffic: dict, info: dict) -> float:
    v, s = config["num_variants"], config["num_samples"]
    flop = info["used_rows"] * s * (s + 1)
    nbytes = v * ((2 * s + 7) // 8) + s * s * 8
    return max(flop / FP64_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)

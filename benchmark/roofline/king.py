"""Least device time of a KING table over every sample: the four count
Grams of 0/1 planes as .b1 AND-POPC products (2 operations a variant and
entry; the symmetric H'H and C'C over their triangle), against reading
the records once and writing four (S, S) int32 Grams."""

from benchmark.roofline.peaks import B1_OPS_PER_S, HBM_BYTES_PER_S


def least_seconds(config: dict, traffic: dict, info: dict) -> float:
    v, s = config["num_variants"], config["num_samples"]
    ops = v * (2 * s * (s + 1) + 2 * 2 * s * s)
    nbytes = v * ((2 * s + 7) // 8) + 4 * s * s * 4
    return max(ops / B1_OPS_PER_S, nbytes / HBM_BYTES_PER_S)

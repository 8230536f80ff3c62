"""Least device time of a filter to VCF with a device-lowered ALT predicate:
the ALT byte of every variant read, the record bytes that hold the kept
samples of every kept row read, and the kept rows' GT text (4 bytes a
sample) written, at the memory bandwidth. No arithmetic bounds it."""

from benchmark.roofline.peaks import HBM_BYTES_PER_S


def least_seconds(config: dict, traffic: dict, info: dict) -> float:
    k = traffic["samples_per_job"]
    kept = info["kept_rows"]
    nbytes = config["num_variants"] + kept * info["kept_record_bytes"] + kept * 4 * k
    return nbytes / HBM_BYTES_PER_S

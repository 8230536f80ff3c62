"""Each job kind's least device time, one module a kind
(``least_seconds(config, traffic, info)``), from the fileset's shapes and
the peaks of ``peaks.py``: the larger of the job's operations at the peak
of their kind and its bytes at the memory bandwidth, each input byte read
once and each output byte written once."""

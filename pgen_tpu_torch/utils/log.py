"""Logging for pgen_tpu.

All diagnostics go to stderr: stdout is reserved for ``query`` output rows
(the reference prints query results to stdout and nothing else on the success
path — pgen-rs/src/pfile.rs:98; its stray header printlns live only in
dead code, see SURVEY.md §5 "Metrics / logging").

Copied from ``pgen_tpu/utils/log.py``: only the imports differ, and
citations of the reference tool's sources read ``pgen-rs/``.
"""

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s pgen_tpu.%(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"pgen_tpu.{name}")
    if not logging.getLogger("pgen_tpu").handlers:
        root = logging.getLogger("pgen_tpu")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("PGEN_TPU_LOG", "WARNING").upper())
        root.propagate = False
    return logger

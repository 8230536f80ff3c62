"""Plain references of each job kind, one module a kind, and the plain
readers of a fileset (``fileset.py``). They import numpy and torch only:
nothing of ``pgen_tpu_torch``, ``pgen_tpu`` or ``jax``."""

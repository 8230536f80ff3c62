"""The benchmark of ``pgen_tpu_torch`` on NVIDIA GPUs (``run.py``).

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``pgen_tpu``; the plain
references under ``reference/`` import nothing of ``pgen_tpu_torch`` either.
"""

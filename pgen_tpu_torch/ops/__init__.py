"""Genotype ops on torch tensors: each wrapper launches its CUDA kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor."""

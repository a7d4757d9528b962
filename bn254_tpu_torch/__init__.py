"""PyTorch + CUDA port of the batched BN254 pairing (see README.md)."""

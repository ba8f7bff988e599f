"""Batch secp256k1 verification on the card: host prep, the hand-written
CUDA kernel and its plain PyTorch version, and the verify engine."""

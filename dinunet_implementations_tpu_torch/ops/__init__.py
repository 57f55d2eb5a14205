"""Kernels written by hand for the card, each with its plain PyTorch version."""

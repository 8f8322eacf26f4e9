"""Quantization, attention and the hand-written kernels K1 / K2."""

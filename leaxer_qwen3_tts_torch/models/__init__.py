"""Transformer, embedding, MTP and vocoder modules on torch tensors."""

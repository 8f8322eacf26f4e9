"""Prompt assembly, sampling, the generation loop and parameters."""

"""Metrics, logging and profiling."""

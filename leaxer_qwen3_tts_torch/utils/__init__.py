"""Metrics."""

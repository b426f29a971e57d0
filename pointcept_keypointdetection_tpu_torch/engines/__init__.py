"""Batch assembly helpers."""

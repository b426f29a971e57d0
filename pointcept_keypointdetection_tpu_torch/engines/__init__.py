"""Batch assembly, the trainer, its hooks and the CLI defaults."""

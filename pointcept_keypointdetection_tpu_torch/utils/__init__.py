"""Config loading and registries (the port's own copies)."""

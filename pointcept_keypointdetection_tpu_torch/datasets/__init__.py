"""Padded-slot collation (the port's own copy)."""

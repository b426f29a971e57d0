"""Losses over padded point batches: the criteria builder, cross-entropy and Lovász-softmax."""

from .builder import LOSSES, Criteria, build_criteria  # noqa: F401
from . import lovasz, misc  # noqa: F401  (register the losses)

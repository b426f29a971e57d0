"""Data: padded-slot collation, the loader, the config's transforms and the synthetic dataset."""

from .builder import DATASETS, build_dataset  # noqa: F401
from . import synthetic  # noqa: F401  (registers SyntheticKeypointDataset)

"""Data: padded-slot collation, the loader, the config's transforms and the datasets."""

from .builder import DATASETS, build_dataset  # noqa: F401
from . import keypoint_dataset, pigseg, semantic_kitti, synthetic  # noqa: F401  (register the datasets)

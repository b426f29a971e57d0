"""The port's dataset registry (names as in the JAX package's configs)."""

from ..utils.registry import Registry

DATASETS = Registry("datasets")


def build_dataset(cfg, **default_args):
    return DATASETS.build(cfg, **default_args)

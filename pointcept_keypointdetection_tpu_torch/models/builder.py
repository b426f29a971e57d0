"""The port's own model registry (names as in the JAX package's configs) and
seeded weight initialisation."""

import math

import torch
from torch import nn

from ..utils.registry import Registry

MODELS = Registry("models")


def build_model(cfg, **default_args):
    return MODELS.build(cfg, **default_args)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the flax initialisers' scales.

    Linear: truncated lecun normal (std 1/sqrt(fan_in), cut at 2 std), zero
    bias.  Sparse-conv and KPConv weights (3-d ``weight`` / ``stem_weight``),
    Swin3D's 4-d cRSE tables and ST-v1m2's 2-d ``rpe_table``: truncated
    normal 0.02 cut at +-0.04.  Norms keep ones,
    zeros and unit running variance.  ``generator`` must live on the
    parameters' device."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features)
            nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
    for name, param in model.named_parameters():
        if param.dim() >= 3 or name.endswith("rpe_table"):
            nn.init.trunc_normal_(param, std=0.02, a=-0.04, b=0.04, generator=generator)
    return model


@torch.no_grad()
def cast_parameters(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Float parameters to ``dtype``, buffers (the BN running statistics) kept as they are:
    ``bench.py:172-180``'s cast of the params collection.  Never ``model.to(dtype)``,
    which would round the statistics too."""
    for param in model.parameters():
        if param.is_floating_point():
            param.data = param.data.to(dtype)
    return model

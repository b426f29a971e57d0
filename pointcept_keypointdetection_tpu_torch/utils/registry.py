"""String -> class registries with config-driven instantiation.

The PyTorch package's own copy of ``pointcept_keypointdetection_tpu/utils/
registry.py`` (the port imports nothing from the JAX package): named
registries, `build_from_cfg` popping a ``type`` key and kwarg-instantiating,
default-args merging, and registration both as a decorator and as a direct
call.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


def build_from_cfg(cfg: Dict, registry: "Registry", default_args: Optional[Dict] = None) -> Any:
    """Instantiate an object from a config dict.

    ``cfg`` must contain ``type`` (a registered name or a class); remaining
    keys become constructor kwargs, with ``default_args`` filling gaps.
    """
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg:
        if default_args is None or "type" not in default_args:
            raise KeyError(f'`cfg` or `default_args` must contain the key "type", got {cfg}')
    if not isinstance(registry, Registry):
        raise TypeError(f"registry must be a Registry object, got {type(registry)}")

    args = dict(cfg)
    if default_args is not None:
        for name, value in default_args.items():
            args.setdefault(name, value)

    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or valid type, got {type(obj_type)}")
    try:
        return obj_cls(**args)
    except Exception as e:
        raise type(e)(f"{obj_cls.__name__}: {e}") from e


class Registry:
    """A registry mapping names to classes/functions.

    Example::

        MODELS = Registry("models")

        @MODELS.register_module()
        class SpUNet: ...

        model = MODELS.build(dict(type="SpUNet", in_channels=6))
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    @property
    def name(self):
        return self._name

    def get(self, key: str):
        return self._module_dict.get(key)

    def build(self, cfg: Dict, **default_args) -> Any:
        return build_from_cfg(cfg, self, default_args=default_args or None)

    def _register(self, module, name=None, force=False):
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f"module must be a class or a function, got {type(module)}")
        names = [module.__name__] if name is None else ([name] if isinstance(name, str) else list(name))
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self.name}")
            self._module_dict[n] = module

    def register_module(self, name=None, force=False, module=None):
        """Register a module; usable as ``@R.register_module()`` or plain call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(mod):
            self._register(mod, name=name, force=force)
            return mod

        return _decorator

"""Trainer hooks: the registry, the lifecycle base and the hooks of the
repo's offset-keypoint training config (counterparts of
``pointcept_keypointdetection_tpu/engines/hooks/``)."""

from ...utils.registry import Registry

HOOKS = Registry("hooks")


def build_hooks(cfg):
    return [HOOKS.build(dict(c)) for c in (cfg or [])]


class HookBase:
    """The lifecycle (`hooks/default.py`); ``trainer`` is set by the trainer."""

    trainer = None

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass


from . import keypoint_evaluator, misc  # noqa: E402,F401  (register the hooks)

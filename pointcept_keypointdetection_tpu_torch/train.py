"""Training entry point of the port, the counterpart of ``tools/train.py``:

    python -m pointcept_keypointdetection_tpu_torch.train --config-file configs/<ds>/<exp>.py \\
        [--device cuda|cpu] [--options key=value a.b.c=value ...]

It trains on the card unless ``--device cpu`` is given.  Checkpoints go to
``<save_path>/model/`` (``model_last.pth``, ``model_best.pth``); the save
path defaults to ``exp/<ds>/<exp>``.  One process on one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .engines.defaults import default_argument_parser, default_config_parser, default_setup
from .engines.train import TRAINERS


def main(argv: Optional[Sequence[str]] = None):
    args = default_argument_parser().parse_args(argv)
    if args.num_processes > 1:
        raise NotImplementedError("multi-device training is not ported yet")
    cfg = default_config_parser(args.config_file, args.options)
    cfg = default_setup(cfg)
    trainer_cfg = dict(cfg.get("train") or {"type": "DefaultTrainer"})
    trainer_cfg.update(cfg=cfg, device=args.device)
    trainer = TRAINERS.build(trainer_cfg)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

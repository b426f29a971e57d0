"""Testing entry point of the port, the counterpart of ``tools/test.py``:

    python -m pointcept_keypointdetection_tpu_torch.test --config-file configs/<ds>/<exp>.py \\
        [--device cuda|cpu] [--options weight=<.ckpt or .pth> key=value ...]

It builds the config's tester (``test = dict(type=...)``, ``SemSegTester``
by default) over ``data.test`` and runs it on the card unless ``--device
cpu`` is given.  The weight is ``weight=`` or the save path's
``model/model_best`` (then ``model_last``); results go to
``<save_path>/result/``.  One process on one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .engines.defaults import default_argument_parser, default_config_parser, default_setup
from .engines.test import TESTERS


def main(argv: Optional[Sequence[str]] = None):
    args = default_argument_parser().parse_args(argv)
    if args.num_processes > 1:
        raise NotImplementedError("multi-device testing is not ported yet")
    cfg = default_config_parser(args.config_file, args.options)
    cfg = default_setup(cfg)
    tester_cfg = dict(cfg.get("test") or {"type": "SemSegTester"})
    tester_cfg.update(cfg=cfg, device=args.device)
    tester = TESTERS.build(tester_cfg)
    return tester.test()


if __name__ == "__main__":
    main()

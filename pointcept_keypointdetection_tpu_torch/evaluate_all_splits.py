"""The config's tester over several splits: the counterpart of ``tools/evaluate_all_splits.py``.

    python -m pointcept_keypointdetection_tpu_torch.evaluate_all_splits \\
        --config-file configs/synthetic/semseg-spunet-r3-test.py [--weight W] [--splits train val] \\
        [--device cuda|cpu]

For each split the config is parsed afresh (``default_config_parser``, with ``weight=``), its
``data.test`` (else ``data.val``) is re-pointed at the split, and the config's tester
(``test = dict(type=...)``, ``SemSegTester`` by default) runs over it.  Then the summary:
``=== All-split summary ===`` and one line per split, ``<split> mIoU=... mAcc=... allAcc=...`` (each
metric ``:.4f``).  ``SemSegTester`` needs a test-mode dataset, so a config whose ``data.val`` is
not (the pigseg configs, which have no ``data.test``) raises here as it does in JAX.  It runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Optional, Sequence

from .engines.defaults import default_config_parser
from .engines.test import TESTERS


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Returns {split: the tester's metrics}."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None)
    parser.add_argument("--splits", nargs="+", default=["train", "val"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    results = {}
    for split in args.splits:
        cfg = default_config_parser(args.config_file, {"weight": args.weight} if args.weight else None)
        test_cfg = copy.deepcopy(dict(cfg.data.get("test", cfg.data.val)))
        test_cfg["split"] = split
        cfg.data.test = test_cfg
        tester_cfg = dict(cfg.get("test", {"type": "SemSegTester"}))
        tester_cfg.update(cfg=cfg, device=args.device)
        tester = TESTERS.build(tester_cfg)
        results[split] = tester.test()

    print("\n=== All-split summary ===")
    for split, r in results.items():
        print(split, " ".join(f"{k}={v:.4f}" for k, v in r.items()))
    return results


if __name__ == "__main__":
    main()

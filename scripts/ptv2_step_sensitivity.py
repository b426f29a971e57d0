#!/usr/bin/env python3
"""How far a 1e-7 relative nudge of the input features moves one PT-v2m2 keypoint training step's gradients on
the CPU, at the card-vs-CPU step's setting of ``chip_smoke.py`` phase 41 (``keypoint_ptv2.py`` at its widths,
slot 8192, batch 2 of its data, one Block per stage, no drop path): with every ReLU free, then with the
unnudged step's ReLU decisions held (``chip_smoke.ReluTies``), then with its segment-max winners held too
(``chip_smoke.MaxTies``).  What is left with both held is the step's own f32 rounding sensitivity; what goes
away is its ties.  Prints the worst gradient change of each, relative to max(1, max|grad|) per tensor.

    python3 scripts/ptv2_step_sensitivity.py          # the CPU, ~1 min at 8 threads
"""

import copy
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset  # noqa: E402
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate  # noqa: E402
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device  # noqa: E402
from pointcept_keypointdetection_tpu_torch.models import build_model, init_weights  # noqa: E402
from pointcept_keypointdetection_tpu_torch.models import point_transformer_v2  # noqa: E402


def main() -> None:
    with tempfile.TemporaryDirectory() as root:
        cs.write_keypoint_clouds(root)
        cfg = cs.recipe_config(cs.LAST_CONFIGS["ptv2"], root, os.path.join(root, "exp"))
        bb = cs.keypoint_backbone(cfg)
        model_cfg = dict(cfg.model)
        model_cfg["backbone_conf"] = dict(bb, enc_depths=(1,) * 4, dec_depths=(1,) * 4, drop_path_rate=0.0)
        np.random.seed(5)
        ds = build_dataset(dict(cfg.data.train))
        batch_np = collate([ds[i] for i in range(cs.KP_CPU_BATCH)], cfg.slot_size, np.random)
    initial = copy.deepcopy(init_weights(build_model(model_cfg), torch.Generator().manual_seed(3)).state_dict())
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal(batch_np["feat"].shape)).float()

    def grads(eps: float) -> dict:
        model = build_model(model_cfg)
        model.load_state_dict(initial)
        b = sample_to_device(batch_np, "cpu")
        b["feat"] = b["feat"] * (1 + eps * noise)
        out = model.train()(build_point_batch(b, batch_np["num_samples"]), b, torch.Generator().manual_seed(0))
        out["loss"].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    def worst(got: dict, ref: dict):
        return max(((got[n] - ref[n]).abs().max().item() / max(1.0, ref[n].abs().max().item()), n) for n in ref)

    sites = ((point_transformer_v2, "segment_max"),)
    relu, maxes = cs.ReluTies(), cs.MaxTies(sites)
    with relu.record(), maxes.record():
        ref = grads(0.0)
    print(f"ReLUs free: worst gradient change {worst(grads(1e-7), ref)}")
    held = cs.ReluTies(relu.masks)
    with held.replay():
        print(f"ReLU decisions held: worst gradient change {worst(grads(1e-7), ref)}, {len(held.ties)} ReLU ties")
    held, winners = cs.ReluTies(relu.masks), cs.MaxTies(sites, maxes.winners)
    with held.replay(), winners.replay():
        print(f"ReLU decisions and segment-max winners held: worst gradient change {worst(grads(1e-7), ref)}, "
              f"{len(held.ties)} ReLU ties, {len(winners.ties)} segment-max ties")


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    main()

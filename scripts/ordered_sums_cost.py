"""What the card's segment sums cost in row order: ``segment_sum`` (``index_add_``, which adds with
atomics on the card, in an order that changes from run to run) against ``segment_sum_in_order``
(``index_put_`` with ``accumulate``: the CPU's row order, the CPU's bits) on real training steps.

    python3 scripts/ordered_sums_cost.py       # from the repository root, one CUDA card

For each training step -- the ScanNet SpUNet recipe (batch 8, slot 131072), semseg-spunet-r3 (batch
4), the offset-keypoint PT-v3 trainer (batch 8), and the OctFormer and Swin3D keypoint recipes (batch
8, on seeded pig clouds), each at its config's widths with seeded weights -- it records every segment
sum of one step on the card (``ops/segment.py``'s own, and those inside ``segment_mean`` and
``segment_reduce``), then times each both ways, forward and, where the rows carry a gradient, backward
(CUDA events, the median of 5 runs of 10 calls), and checks that the in-order sum repeats bit for bit
and gives the CPU's bits.  Then the whole step both ways, every segment sum of the port in row order
against the path as it runs (host clock, one warm-up each, then 2 steps each in the order: as the
path runs, in order, in order, as the path runs), and whether two steps give the same gradients bit
for bit either way.  The card's name and power limit stand beside every time.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)

import chip_smoke as cs  # noqa: E402
from pointcept_keypointdetection_tpu_torch.ops import segment  # noqa: E402

REPS, RUNS, STEPS = 10, 5, 2
ATOMIC, IN_ORDER = segment.segment_sum, segment.segment_sum_in_order


@contextlib.contextmanager
def patched(replacement):
    """Every segment sum of the port (``segment_sum``, the sums inside ``segment_mean`` and
    ``segment_reduce``, SpUNet's parent sums, ``segment_sum_in_order``) through
    ``replacement(the function it replaces, data, ids, m)``."""
    saved = (segment.segment_sum, segment._REDUCERS["sum"], cs.spunet_module.segment_sum, segment.segment_sum_in_order)
    atomic = lambda data, ids, m: replacement(ATOMIC, data, ids, m)  # noqa: E731
    segment.segment_sum = segment._REDUCERS["sum"] = cs.spunet_module.segment_sum = atomic
    segment.segment_sum_in_order = lambda data, ids, m: replacement(IN_ORDER, data, ids, m)
    try:
        yield
    finally:
        (segment.segment_sum, segment._REDUCERS["sum"], cs.spunet_module.segment_sum,
         segment.segment_sum_in_order) = saved


def in_order(plain, data, ids, m):
    return IN_ORDER(data, ids, m)


def one_step(model, batch_np) -> dict:
    model.zero_grad(set_to_none=True)
    batch = cs.sample_to_device(batch_np, "cuda")
    point = cs.build_point_batch(batch, batch_np["num_samples"])
    out = model(point, batch, torch.Generator().manual_seed(0))
    out["loss"].float().backward()
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def time_call(fn, data, ids, m) -> float:
    """ms per call, forward and (where ``data`` carries a gradient) backward."""
    x = data.detach().clone().requires_grad_(data.requires_grad)
    grad = torch.ones((m,) + data.shape[1:], dtype=data.dtype, device=data.device) if data.requires_grad else None

    def call():
        out = fn(x, ids, m)
        if grad is not None:
            out.backward(grad)

    call()
    runs = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / REPS)
    return statistics.median(runs)


def measure(label: str, cfg, batch_np) -> dict:
    model = cs.init_weights(cs.build_model(dict(cfg.model)), torch.Generator().manual_seed(3)).cuda().train()
    calls = []

    def record(plain, data, ids, m):
        calls.append((data.detach().clone().requires_grad_(data.requires_grad), ids.clone(), m, plain is IN_ORDER))
        return plain(data, ids, m)

    with patched(record):
        one_step(model, batch_np)
    atomic_ms = ordered_ms = 0.0
    for data, ids, m, already in calls:
        a = time_call(ATOMIC, data, ids, m)
        o = time_call(IN_ORDER, data, ids, m)
        atomic_ms, ordered_ms = atomic_ms + a, ordered_ms + o
        first, again = (IN_ORDER(data.detach(), ids, m) for _ in range(2))
        cpu = IN_ORDER(data.detach().cpu(), ids.cpu(), m)
        if not (torch.equal(first, again) and torch.equal(first.cpu(), cpu)):
            raise AssertionError(f"{label}: the in-order sum of {tuple(data.shape)} rows does not give the CPU's bits")
        print(f"{label}: sum of {tuple(data.shape)} {str(data.dtype)[6:]} rows into {m}"
              f"{' (grad)' if data.requires_grad else ''}{' (already in order)' if already else ''}: index_add_ "
              f"{a:.4f} ms, in order {o:.4f} ms {cs.stamp()}")
    steps = {"as the path runs": [], "in order": []}
    grads = {"as the path runs": [], "in order": []}
    for key in steps:  # one warm-up each
        with patched(in_order) if key == "in order" else contextlib.nullcontext():
            one_step(model, batch_np)
    for key in ("as the path runs", "in order", "in order", "as the path runs"):
        with patched(in_order) if key == "in order" else contextlib.nullcontext():
            for _ in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g = one_step(model, batch_np)
                torch.cuda.synchronize()
                steps[key].append((time.perf_counter() - t0) * 1e3)
                if len(grads[key]) < 2:
                    grads[key].append(g)
                del g
    repeat = {key: all(torch.equal(a, g[1][name]) for name, a in g[0].items()) for key, g in grads.items()}
    median = {key: statistics.median(v) for key, v in steps.items()}
    print(f"{label}: {len(calls)} segment sums per step: index_add_ {atomic_ms:.4f} ms, in order {ordered_ms:.4f} ms "
          f"(CUDA events); step median as the path runs {median['as the path runs']:.2f} ms, all in order "
          f"{median['in order']:.2f} ms (host clock, {2 * STEPS} steps each: {steps}); two steps give the same "
          f"gradients bit for bit: {repeat}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"{cs.stamp()}")
    del model, grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return dict(calls=len(calls), atomic_ms=atomic_ms, ordered_ms=ordered_ms, **median)


def first_batch(cfg, batch: int):
    np.random.seed(5)
    ds = cs.build_dataset(dict(cfg.data.train))
    return cs.collate([ds[i] for i in range(batch)], cfg.slot_size, np.random)


def main() -> None:
    cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as root:
        cs.write_keypoint_clouds(root)
        cases = (("scannet spunet", cs.spunet_train_config(os.path.join(root, "s"))),
                 ("semseg_r3", cs.semseg_r3_train_config(os.path.join(root, "r"))),
                 ("ptv3 offset keypoint", cs.train_config()),
                 ("octformer recipe", cs.recipe_config(cs.OCT_CONFIG, root, os.path.join(root, "o"))),
                 ("swin3d recipe", cs.recipe_config(cs.SWIN_VOTE_CONFIG, root, os.path.join(root, "w"))))
        for label, cfg in cases:
            measure(label, cfg, first_batch(cfg, cfg.batch_size))


if __name__ == "__main__":
    main()

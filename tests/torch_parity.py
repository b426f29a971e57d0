"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both the JAX package and
the port.  Torch runs on one thread: the suite runs several xdist workers.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

torch.set_num_threads(1)


def slotted_scene(rng: np.random.Generator, num_samples: int, slot: int, n_valid: int, span: int) -> Dict:
    """``num_samples`` slots of ``n_valid`` unique voxels in [0, span)^3, pads last in each slot."""
    grid = np.zeros((num_samples * slot, 3), np.int32)
    valid = np.zeros(num_samples * slot, bool)
    for b in range(num_samples):
        cells = rng.choice(span**3, n_valid, replace=False)
        g = np.stack(np.unravel_index(cells, (span,) * 3), 1)
        grid[b * slot : b * slot + n_valid] = g
        valid[b * slot : b * slot + n_valid] = True
    coord = (grid + rng.uniform(0, 1, grid.shape)).astype(np.float32) * 0.05
    return dict(grid_coord=grid, valid=valid, coord=coord, batch=np.repeat(np.arange(num_samples), slot))


def _seeded_leaf(name: str, shape, rng: np.random.Generator) -> np.ndarray:
    if name == "var":
        a = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        a = 0.1 * rng.normal(size=shape)
    elif name == "scale":
        a = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "bias":
        a = 0.05 * rng.normal(size=shape)
    elif name == "kernel":
        a = rng.normal(size=shape) / np.sqrt(shape[-2])
    else:  # sparse-conv weights
        a = 0.05 * rng.normal(size=shape)
    return a.astype(np.float32)


def jax_variables_like(shapes, rng: np.random.Generator) -> Dict:
    """Seeded numpy values for a flax variable tree of ``jax.eval_shape`` leaves."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    return {col: unflatten_dict({path: _seeded_leaf(path[-1], leaf.shape, rng)
                                 for path, leaf in flatten_dict(tree).items()})
            for col, tree in shapes.items()}


_FLAX_PARENTS = {("cpe", "linear"): "Dense_0", ("cpe", "norm"): "LayerNorm_0", ("mlp", "fc1"): "Dense_0",
                 ("mlp", "fc2"): "Dense_1"}


def jax_variables_for(model: torch.nn.Module, rng: np.random.Generator) -> Dict:
    """Seeded flax variables for the port's OffsetKeypoint, Keypoint, VoteKeypoint,
    PigBodyRegressor, DefaultSegmentorV2 or PointGroup PT-v3m1 or PT-v3plus ``model``, named as
    the JAX model names them, without tracing it.  Only for
    configs whose stages have one Block each (no ``nn.scan`` stacks);
    ``convert.py`` maps the result back onto the model's names."""
    from flax.traverse_util import unflatten_dict

    linears = {name for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    flat = {}
    for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
        *parents, leaf = name.split(".")
        if parents[:2] == ["head", "1"]:  # KeypointModel's norm between its Dense_0 and Dense_1
            path = ["MaskedBatchNorm_0"]
        elif parents[0] == "head":
            path = [f"Dense_{int(parents[1]) // 2}"]
        elif parents[0] in ("seg_head", "offset_fc", "offset_norm", "offset_head", "cls_head"):
            path = [parents[0]]
        else:  # backbone.<...>
            path = ["PointTransformerV3_0"] + [_FLAX_PARENTS.get(pair, pair[1]) for pair in zip(parents, parents[1:])]
        shape = tuple(tensor.shape)
        if ".".join(parents) in linears and leaf == "weight":
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight" and tensor.dim() == 1:
            leaf = "scale"
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        flat[(col, *path, leaf)] = _seeded_leaf(leaf, shape, rng)
    return unflatten_dict(flat)


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def keypoint_batch(seed: int, num_samples: int, slot: int, pads: int, span: int, num_keypoints: int = 6,
                   pitch: float = 0.05) -> Dict:
    """``num_samples`` slots of ``slot - pads`` unique voxels in [0, span)^3 (one point per voxel, as
    GridSample leaves a cloud) and ``pads`` pad rows at the origin, coordinates at ``pitch``, 4 input
    channels, keypoints and scales."""
    rng = np.random.default_rng(seed)
    b = slotted_scene(rng, num_samples, slot, slot - pads, span)
    b["coord"] = ((b["grid_coord"] + rng.uniform(0, 1, b["grid_coord"].shape)) * pitch).astype(np.float32)
    b["coord"][~b["valid"]] = 0.0
    b.pop("batch")
    b["feat"] = (rng.normal(size=(num_samples * slot, 4)) * b["valid"][:, None]).astype(np.float32)
    b["keypoint"] = rng.uniform(0.1, span * pitch, (num_samples, num_keypoints, 3)).astype(np.float32)
    b["scale"] = rng.uniform(300, 900, num_samples).astype(np.float32)
    return b


def keypoint_reference(cfg: Dict, batch: Dict, backbone_class: str, seed: int, extra: Optional[Dict] = None) -> Dict:
    """A JAX ``Keypoint<Backbone>`` of ``cfg`` with seeded weights (names from ``jax.eval_shape``) over
    ``batch``: its eval forward (the prediction and the backbone's features) and one training step (the
    outputs, the loss's gradient, the running statistics after it, the backbone's features, the head's
    Dropout output and norm output); and the eval forward of each model of ``extra`` ({key: cfg}, its own
    seeded weights) under ``ref["extra"][key]``.  Compiled as one function with XLA's cheaper CPU passes."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
    from pointcept_keypointdetection_tpu.models import build_model as jax_build_model

    b = {k: jnp.asarray(v) for k, v in batch.items()}
    num_samples = batch["scale"].shape[0]
    point = JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                          num_samples=num_samples)
    models = {key: jax_build_model(dict(c)) for key, c in {"main": cfg, **(extra or {})}.items()}
    variables = {key: jax_variables_like(jax.eval_shape(
        lambda m=m: m.init({"params": jax.random.PRNGKey(0)}, point, b, train=False)), np.random.default_rng(seed + i))
        for i, (key, m) in enumerate(models.items())}
    model = models["main"]

    def backbone(mdl, method):
        return method == "__call__" and type(mdl).__name__ == backbone_class

    def captured(mdl, method):  # the backbone, and the head's norm and Dropout (the mask's source)
        return backbone(mdl, method) or (method == "__call__" and (
            isinstance(mdl, fnn.Dropout) or mdl.scope.path == ("MaskedBatchNorm_0",)))

    def run(v):
        evals = {key: models[key].apply(v[key], point, b, train=False, mutable=["intermediates"],
                                        capture_intermediates=backbone) for key in models}

        def loss_fn(p):
            step, mutated = model.apply({"params": p, "batch_stats": v["main"]["batch_stats"]}, point, b, train=True,
                                        mutable=["batch_stats", "intermediates"],
                                        rngs={"dropout": jax.random.PRNGKey(7)}, capture_intermediates=captured)
            return step["loss"], (step, mutated)

        return evals, jax.value_and_grad(loss_fn, has_aux=True)(v["main"]["params"])

    evals, ((_, (step, mutated)), grads) = jax.jit(run).lower(variables).compile(FAST_COMPILE)(variables)
    name = f"{backbone_class}_0"
    forwards = {key: dict(variables=variables[key], pred=np.asarray(out["keypoint_pred"]),
                          feat=np.asarray(inter["intermediates"][name]["__call__"][0]))
                for key, (out, inter) in evals.items()}
    train_inter = mutated["intermediates"]
    main = forwards.pop("main")
    return dict(main, extra=forwards,
                step=jax.tree.map(np.asarray, step), grads=jax.tree.map(np.array, grads),
                stats=jax.tree.map(np.array, mutated["batch_stats"]),
                train_feat=np.asarray(train_inter[name]["__call__"][0]),
                dropped=np.asarray(train_inter["Dropout_0"]["__call__"][0]),
                normed=np.asarray(train_inter["MaskedBatchNorm_0"]["__call__"][0]))


def port_point(batch: Dict):
    from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch

    return PointBatch(coord=torch.from_numpy(batch["coord"]), feat=torch.from_numpy(batch["feat"]),
                      grid_coord=torch.from_numpy(batch["grid_coord"]), valid=torch.from_numpy(batch["valid"]),
                      num_samples=batch["scale"].shape[0])


def assert_close(got: torch.Tensor, ref, what: str, tol: float) -> None:
    """Within ``tol`` x max(1, max|ref|)."""
    ref = torch.tensor(np.asarray(ref))
    torch.testing.assert_close(got.detach().float(), ref, rtol=0, atol=tol * max(1.0, ref.abs().max().item()),
                               msg=lambda m: f"{what}: {m}")


def port_model(cfg: Dict, variables: Dict) -> torch.nn.Module:
    """The port's model of ``cfg`` with ``variables`` carried over by ``convert.py``, which must name every
    parameter and statistic."""
    from pointcept_keypointdetection_tpu_torch.convert import convert_variables
    from pointcept_keypointdetection_tpu_torch.models import build_model

    model = build_model(dict(cfg))
    state = convert_variables(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def check_backbone_forward(cfg: Dict, ref: Dict, batch: Dict, train: bool, tol: float) -> None:
    """The backbone's features on the valid rows in eval (the running statistics) or training mode (the batch's),
    and in eval the prediction; ``ref``: ``keypoint_reference``'s, or one of its ``extra`` (eval only)."""
    model = port_model(cfg, ref["variables"]).train(train)
    feats = {}
    model.backbone.register_forward_hook(lambda m, i, o: feats.__setitem__("backbone", o))
    valid = torch.from_numpy(batch["valid"])
    with torch.no_grad():
        out = model(port_point(batch), {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    key = "train_feat" if train else "feat"
    assert_close(feats["backbone"][valid], ref[key][batch["valid"]], f"backbone features ({key})", tol)
    if not train:
        assert_close(out["keypoint_pred"], ref["pred"], "keypoint_pred", tol)


def check_training_step(cfg: Dict, ref: Dict, batch: Dict, tol: float) -> None:
    """One training step with JAX's Dropout mask: the prediction, loss and ``mean_dist``, every gradient by
    ``convert.py`` name and the running statistics after it (1e-6).  The head's first Dense feeds a
    training-mode BatchNorm, so its bias's gradient is 0 up to rounding on both sides: each side's within
    ``tol`` x the largest gradient of that norm's bias."""
    from pointcept_keypointdetection_tpu_torch.convert import convert_variables

    kept_in = np.maximum(ref["normed"], 0)  # the Dropout's input: ReLU of the norm
    mask = torch.from_numpy(np.where(kept_in > 0, ref["dropped"] != 0, True))
    model = port_model(cfg, ref["variables"]).train()
    model.head[3].forward = lambda x, generator: torch.where(mask, x / (1.0 - 0.3), torch.zeros((), dtype=x.dtype))
    out = model(port_point(batch), {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    assert_close(out["keypoint_pred"], ref["step"]["keypoint_pred"], "keypoint_pred", tol)
    for name in ("loss", "mean_dist"):
        np.testing.assert_allclose(out[name].item(), float(ref["step"][name]), rtol=tol, err_msg=name)
    out["loss"].backward()
    grads = convert_variables({"params": ref["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, g in grads.items():
        if name == "head.0.bias":
            scale = grads["head.1.bias"].abs().max().item()
            for side in (params[name].grad, g):
                assert side.abs().max().item() <= tol * scale, name
            continue
        assert_close(params[name].grad, g, f"gradient {name}", tol)
    stats = convert_variables({"batch_stats": ref["stats"]})
    buffers = {name: t for name, t in model.state_dict().items() if name not in params}
    assert set(stats) == set(buffers)
    for name, s in stats.items():
        torch.testing.assert_close(buffers[name], s, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def recorded_searches(monkeypatch, *modules) -> List:
    """Record every ``knn`` and ``knn_bucketed`` call made through ``modules``' names (and inside
    ``three_nn_interpolate``): [(function, args, kwargs)]."""
    from pointcept_keypointdetection_tpu_torch.ops import knn as knn_ops

    calls = []
    plain = {name: getattr(knn_ops, name) for name in ("knn", "knn_bucketed")}
    for module in (knn_ops,) + modules:
        for name, fn in plain.items():
            if hasattr(module, name):
                monkeypatch.setattr(module, name, lambda *a, _f=fn, **kw: calls.append((_f, a, kw)) or _f(*a, **kw))
    return calls


def assert_clear_kth_neighbours(calls: List, rel: float = 1e-5) -> None:
    """Every query's k-th and (k+1)-th nearest candidates lie more than ``rel`` x d_k apart (f32 rounding
    moves a squared distance by ~1e-7 of it, and JAX's ``jit`` rounds otherwise than the port, which follows
    JAX outside ``jit``), so both packages keep the same k neighbours; a (k+1)-th that is missing counts as
    apart."""
    assert calls
    for fn, args, kwargs in calls:
        args = list(args)
        k = args[2]
        args[2] = k + 1
        _, sqd = fn(*args, **kwargs)
        kth, next_ = sqd[:, k - 1], sqd[:, k]
        live = kth < 1e9
        gap = (next_ - kth)[live]
        assert bool((gap > rel * kth[live]).all()), (fn.__name__, k, float((gap / kth[live].clamp_min(1e-30)).min()))

"""The port's SLAM back end (``slam/imu``, ``pose_graph``, ``frontend``, ``semantic_slam``), its
``run_slam`` CLI and the labeller in the loop against the JAX package on the CPU.

Inputs are made with numpy from seeds.  The JAX references run in threads
started by the file's first test (``tools/run_slam.py`` in a subprocess of
its own), while the port runs on the main thread.  Tolerances: the IMU and
the pose graph, one f32 step or solve, 1e-5 (x max(1, max|ref|)); the
frontend is numpy on both sides and equal; a loop registration that locks on
within 2 inliers, 2e-3 m and 5e-4 rad (``tests/test_torch_slam.py``'s
bound); the back end's integer outputs (keyframes, edges and their ends,
loop closures) exactly, and its poses over a sequence within 1e-2 m and
2e-3 rad.  The sequences here step 0.6 m through a world of a ground plane
and two walls: every other scan registers from 6 cm off with a few dozen
of its points on near-collinear neighbourhoods (lambda_mid ~ 1e-5
lambda_max), whose planarity gate is rounding noise in both packages, and
the two converge millimetres apart on those scans (each test prints its
worst gap) and within 1e-4 m on the others.  The labeller's labels are equal and its embedding within 1e-4.
"""

import os
import re
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one torch thread)

from pointcept_keypointdetection_tpu_torch import run_slam as port_run_slam
from pointcept_keypointdetection_tpu_torch.inference.semantic_scan import SemanticScanPredictor
from pointcept_keypointdetection_tpu_torch.slam import frontend as port_frontend
from pointcept_keypointdetection_tpu_torch.slam.imu import ImuState, propagate
from pointcept_keypointdetection_tpu_torch.slam.pipeline import OdometryConfig
from pointcept_keypointdetection_tpu_torch.slam.pose_graph import PoseGraph, optimize
from pointcept_keypointdetection_tpu_torch.slam.semantic_slam import SemanticSLAM, SlamConfig
from pointcept_keypointdetection_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
POS_TOL = 2e-3  # a registration
ROT_TOL = 5e-4
SEQ_POS_TOL = 1e-2  # a pose of a sequence
SEQ_ROT_TOL = 2e-3
ODO = dict(scan_capacity=2048, map_capacity=8192, scan_voxel=0.4, map_voxel=0.4, icp_iters=6, max_corr_dist=1.5,
           min_range=0.0, max_range=60.0, map_origin=(-60.0, -60.0, -20.0), map_radius=120.0)
KEYFRAME_ODO = dict(ODO, scan_capacity=1024)
KEYFRAME_RUN = dict(keyframe_dist=0.5, loop_closure=True, loop_descriptor=False, loop_min_gap=3, loop_max_dist=2.0,
                    loop_min_inliers=200, optimize_every=4, keyframe_scan_size=1024)
DRIFT_LOOP = dict(loop_min_gap=10, loop_max_dist=4.0, loop_min_inliers=200, keyframe_scan_size=2048,
                  loop_desc_min_sim=0.6, loop_drift_rate=0.5)
SEMSEG = dict(type="DefaultSegmentor", backbone=dict(type="SpUNet-v1m1", in_channels=4, num_classes=6, base_channels=8,
                                                     channels=(8,) * 8, layers=(1,) * 8, stem_kernel=3,
                                                     bn_momentum=0.1))
SEM_SLOT = 4096


def _structured_world(rng, n=6000):
    """``tests/test_semantic_slam.py``'s world."""
    n1, n2, n3 = n // 2, n // 4, n - n // 2 - n // 4
    ground = np.stack([rng.uniform(-25, 25, n1), rng.uniform(-25, 25, n1), rng.normal(0, 0.01, n1)], 1)
    wall1 = np.stack([rng.uniform(-25, 25, n2), np.full(n2, 8.0) + rng.normal(0, 0.01, n2), rng.uniform(0, 4, n2)], 1)
    wall2 = np.stack([np.full(n3, -6.0) + rng.normal(0, 0.01, n3), rng.uniform(-25, 25, n3), rng.uniform(0, 4, n3)], 1)
    return np.concatenate([ground, wall1, wall2]).astype(np.float32)


def _place(rng, seed_offset):
    """``tests/test_slam_frontend.py``'s distinctive place."""
    r = np.random.default_rng(seed_offset)
    n = 4000
    ground = np.stack([rng.uniform(-25, 25, n // 2), rng.uniform(-25, 25, n // 2), rng.normal(0, 0.02, n // 2)], 1)
    d1, d2, h1 = 5.0 + 3 * r.random(), 8.0 + 6 * r.random(), 2.0 + 3 * r.random()
    w1 = np.stack([rng.uniform(-20, 20, n // 4), np.full(n // 4, d1) + rng.normal(0, 0.02, n // 4),
                   rng.uniform(0, h1, n // 4)], 1)
    w2 = np.stack([np.full(n // 4, -d2) + rng.normal(0, 0.02, n // 4), rng.uniform(-20, 20, n // 4),
                   rng.uniform(0, 5, n // 4)], 1)
    return np.concatenate([ground, w1, w2]).astype(np.float32)


def _imu_cases():
    rng = np.random.default_rng(1)
    f = np.float32
    cases = [(np.zeros((20, 3), f), np.tile(f([1.0, 0.0, 9.81]), (20, 1)), np.full(20, 0.01, f), np.zeros(6, f)),
             (np.tile(f([0.0, 0.0, 1.0]), (100, 1)), np.tile(f([0.0, 0.0, 9.81]), (100, 1)), np.full(100, 0.01, f),
              np.zeros(6, f))]
    dt = np.full(30, 0.005, f)
    dt[24:] = 0.0  # padding
    cases.append((rng.normal(size=(30, 3)).astype(f), (rng.normal(size=(30, 3)) + [0, 0, 9.81]).astype(f), dt,
                  (rng.normal(size=6) * 0.05).astype(f)))
    return cases


def _graph():
    """``test_noisy_loop_edge_cannot_degrade_consistent_chain``'s 24-node chain and noisy loop edge, its nodes
    perturbed (rotations and positions) so every edge has a residual."""
    rng = np.random.default_rng(2)
    K = 24
    t = np.stack([np.linspace(0, 11.5, K), np.zeros(K), np.zeros(K)], 1).astype(np.float32)
    Z_t = np.concatenate([t[1:] - t[:-1], (t[-1] - t[0] + [0.3, 0.2, 0.0])[None]]).astype(np.float32)
    ei = np.append(np.arange(K - 1), 0)
    ej = np.append(np.arange(1, K), K - 1)
    w = np.append(np.ones(K - 1), 0.04).astype(np.float32)
    yaw = rng.normal(size=K) * 0.02
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]] for a in yaw]).astype(np.float32)
    t = (t + rng.normal(size=t.shape) * 0.03).astype(np.float32)
    Z_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    prior = (0.2 / (1.0 + np.linspace(0, 3, K))).astype(np.float32)
    return dict(R=R, t=t, ei=ei, ej=ej, Z_R=Z_R, Z_t=Z_t, w=w, prior=prior)


def _drift_loop(slam_cls, cfg, descriptor):
    """``test_loop_closure_under_drift_beyond_pose_gate``'s keyframe chain: a square loop whose odometry drifts
    0.2 m a keyframe (5.6 m at the end, past the pose gate); each keyframe anchors its own frame."""
    rng = np.random.default_rng(0)
    world = _place(rng, 1) * 1.5
    slam = slam_cls(cfg)
    steps = ([(0.5 * i, 0.0) for i in range(8)] + [(3.5, 0.5 * i) for i in range(1, 8)]
             + [(3.5 - 0.5 * i, 3.5) for i in range(1, 8)] + [(0.0, 3.5 - 0.5 * i) for i in range(1, 8)])
    gt = np.array([[x, y, 0.0] for x, y in steps], np.float32)
    drift = np.cumsum(np.tile([0.15, 0.13, 0.0], (len(gt), 1)), axis=0).astype(np.float32)
    drift[0] = 0
    est = gt + drift
    for k in range(len(gt)):
        scan = (world - gt[k]).astype(np.float32)
        scan = scan[np.linalg.norm(scan, axis=1) < 30][: cfg.keyframe_scan_size]
        stored = np.zeros((cfg.keyframe_scan_size, 3), np.float32)
        sv = np.zeros(cfg.keyframe_scan_size, bool)
        stored[: len(scan)] = scan
        sv[: len(scan)] = True
        slam.descriptor_index.add(*descriptor(scan, cfg=slam.descriptor_cfg))
        slam.kf_R.append(np.eye(3, dtype=np.float32))
        slam.kf_t.append(est[k].copy())
        slam.kf_scan.append(stored)
        slam.kf_scan_valid.append(sv)
        slam.kf_frame.append(k)
        slam._anchors.append((k, np.eye(4)))
        if k > 0:
            slam.edges.append((k - 1, k, np.eye(3, dtype=np.float32), est[k] - est[k - 1], 1.0))
    return slam


def _keyframe_run_scans():
    """6 scans of the world along x, 0.6 m apart (a keyframe each), then 3 back to the start."""
    world = _structured_world(np.random.default_rng(0))
    scans = []
    for x in [0.6 * i for i in range(6)] + [2.4, 1.2, 0.0]:
        scan = (world - np.array([x, 0.0, 0.0])).astype(np.float32)
        scans.append(scan[np.linalg.norm(scan, axis=1) < 45])
    return scans


def _back_end_summary(slam):
    """What a back-end run is compared by."""
    return dict(keyframes=slam.keyframe_count, edges=[(e[0], e[1]) for e in slam.edges],
                weights=np.array([e[4] for e in slam.edges]), loops=slam.loop_count,
                Z_t=np.stack([e[3] for e in slam.edges]) if slam.edges else np.zeros((0, 3)),
                final=slam.final_trajectory(), live=np.stack(slam.odo.poses) if slam.odo.poses else None)


def _jax_small():
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.slam.imu import ImuState as JaxImu
    from pointcept_keypointdetection_tpu.slam.imu import propagate as jax_propagate
    from pointcept_keypointdetection_tpu.slam.pose_graph import PoseGraph as JaxGraph
    from pointcept_keypointdetection_tpu.slam.pose_graph import optimize as jax_optimize

    out = {"imu": []}
    for gyro, accel, dt, bias in _imu_cases():
        state = JaxImu.identity()._replace(bg=jnp.asarray(bias[:3]), ba=jnp.asarray(bias[3:]))
        s = jax_propagate(state, jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dt))
        out["imu"].append([np.asarray(x) for x in s])
    g = _graph()
    graph = JaxGraph(R=jnp.asarray(g["R"]), t=jnp.asarray(g["t"]), node_valid=jnp.ones(24, bool),
                     edge_i=jnp.asarray(g["ei"], jnp.int32), edge_j=jnp.asarray(g["ej"], jnp.int32),
                     Z_R=jnp.asarray(g["Z_R"]), Z_t=jnp.asarray(g["Z_t"]), edge_weight=jnp.asarray(g["w"]))
    for key, prior in (("vector", jnp.asarray(g["prior"])), ("scalar", 0.2), ("none", 0.0)):
        res = jax_optimize(graph, iters=6, prior_weight=prior)
        out[f"graph_{key}"] = (np.asarray(res.R), np.asarray(res.t))
    return out


def _jax_keyframe_run():
    from pointcept_keypointdetection_tpu.slam.pipeline import OdometryConfig as JaxOdoConfig
    from pointcept_keypointdetection_tpu.slam.semantic_slam import SemanticSLAM as JaxSLAM
    from pointcept_keypointdetection_tpu.slam.semantic_slam import SlamConfig as JaxSlamConfig

    slam = JaxSLAM(JaxSlamConfig(odometry=JaxOdoConfig(**KEYFRAME_ODO), **KEYFRAME_RUN))
    for scan in _keyframe_run_scans():
        slam.process(scan)
    return _back_end_summary(slam)


def _jax_drift_loop():
    """The drifted loop's candidates, each one's registration, the loop edge, and ``final_trajectory``."""
    from pointcept_keypointdetection_tpu.slam import semantic_slam as jax_module
    from pointcept_keypointdetection_tpu.slam.frontend import scan_descriptor as jax_descriptor

    slam = _drift_loop(jax_module.SemanticSLAM, jax_module.SlamConfig(**DRIFT_LOOP), jax_descriptor)
    out = _close_drift_loop(slam, jax_module)
    out["summary"] = _back_end_summary(slam)
    return out


def _close_drift_loop(slam, module):
    """``_try_loop_closure`` of the drifted loop's last keyframe, each candidate's registration (R, t, rmse,
    inliers) recorded on its way through ``module.point_to_plane_icp`` (this thread's calls only: another
    thread's back end may register through the module meanwhile)."""
    k = len(slam.kf_R) - 1
    candidates = [(j, corr) for j, _, _, corr in slam._loop_candidates(k)]
    icp, registrations, me = module.point_to_plane_icp, [], threading.get_ident()

    def recorded(*args, **kwargs):
        res = icp(*args, **kwargs)
        if threading.get_ident() == me:
            registrations.append((np.asarray(res.R), np.asarray(res.t), float(res.rmse), int(res.inliers)))
        return res

    module.point_to_plane_icp = recorded
    try:
        slam._try_loop_closure(k)
    finally:
        module.point_to_plane_icp = icp
    return dict(candidates=list(zip(candidates, registrations)), edge=slam.edges[-1], loops=slam.loop_count,
                edges=len(slam.edges))


def _jax_run_slam(root: str) -> str:
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "run_slam.py"), "--config-file",
                           os.path.join(root, "cfg.py"), "--options", f"save_path={root}/jax"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _jax_labeller(root: str):
    """``tools/run_slam.py::_build_semseg`` over the written checkpoint: (labels, embedding) of the scan."""
    import run_slam as jax_run_slam

    from pointcept_keypointdetection_tpu.utils.config import Config as JaxConfig

    infer = jax_run_slam._build_semseg(JaxConfig.fromfile(os.path.join(root, "sem_jax.py")))
    return infer(np.load(os.path.join(root, "scan.npy")))


def _write_sequence(root: str) -> None:
    """``test_run_slam_cli_full_backend``'s sequence and config (6 scans 0.6 m apart, poses, the back end)."""
    world = _structured_world(np.random.default_rng(0))
    seq_dir = os.path.join(root, "dataset", "sequences", "00", "velodyne")
    os.makedirs(seq_dir)
    rows = []
    for i in range(6):
        t = np.array([0.6 * i, 0.0, 0.0], np.float32)
        scan = (world - t).astype(np.float32)
        scan = scan[np.linalg.norm(scan, axis=1) < 40]
        np.concatenate([scan, np.ones((len(scan), 1), np.float32)], 1).tofile(os.path.join(seq_dir, f"{i:06d}.bin"))
        P = np.eye(4)[:3]
        P[:, 3] = t
        rows.append(P.reshape(-1))
    os.makedirs(os.path.join(root, "dataset", "poses"))
    np.savetxt(os.path.join(root, "dataset", "poses", "00.txt"), np.stack(rows), fmt="%.6f")
    with open(os.path.join(root, "cfg.py"), "w") as f:
        f.write(f"data_root = {root!r}\nsequence = '00'\nmax_frames = None\nsemantic = dict(enabled=False)\n"
                f"odometry = dict({', '.join(f'{k}={v!r}' for k, v in ODO.items())})\n"
                "slam = dict(keyframe_dist=0.5, loop_closure=False, optimize_every=3, keyframe_scan_size=1024)\n"
                f"save_path = {os.path.join(root, 'exp')!r}\n")


def _write_labeller(root: str) -> None:
    """The tiny SpUNet config of ``test_model_label_path_wires_learned_embedding``, seeded weights as a JAX
    checkpoint (both packages read it), a SLAM config over each, and one scan of the world."""
    import jax

    from pointcept_keypointdetection_tpu.engines.common import build_point_batch
    from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
    from pointcept_keypointdetection_tpu.utils.checkpoint import save_checkpoint
    from torch_parity import jax_variables_like

    from pointcept_keypointdetection_tpu.datasets.collate import collate, pad_sample
    from pointcept_keypointdetection_tpu.engines.test import sample_to_device

    world = _structured_world(np.random.default_rng(3), n=3000)
    scan = np.concatenate([world, np.ones((len(world), 1), np.float32)], 1)
    np.save(os.path.join(root, "scan.npy"), scan)
    with open(os.path.join(root, "sem.py"), "w") as f:
        f.write(f"model = {SEMSEG!r}\n")
    model = jax_build_model(dict(SEMSEG))
    data = dict(coord=world[:10], grid_coord=np.zeros((10, 3), np.int32), feat=scan[:10])
    dev = sample_to_device(collate([pad_sample(data, SEM_SLOT)], SEM_SLOT))
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, build_point_batch(dev, 1), dev,
                                               train=False))
    save_checkpoint(os.path.join(root, "sem.ckpt"), jax_variables_like(shapes, np.random.default_rng(5)))
    for name in ("jax", "port"):
        with open(os.path.join(root, f"sem_{name}.py"), "w") as f:
            f.write(f"semantic = dict(enabled=True, labels_from='model', config={os.path.join(root, 'sem.py')!r}, "
                    f"weight={os.path.join(root, 'sem.ckpt')!r}, slot={SEM_SLOT}, dynamic_classes=())\n")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    import pointcept_keypointdetection_tpu.slam  # noqa: F401  (imported once here, not by the threads at once)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import run_slam  # noqa: F401

    root = str(tmp_path_factory.mktemp("slam"))
    _write_sequence(root)
    _write_labeller(root)
    with ThreadPoolExecutor(5) as pool:
        futures = dict(keyframe_run=pool.submit(_jax_keyframe_run), drift_loop=pool.submit(_jax_drift_loop),
                       cli=pool.submit(_jax_run_slam, root), labeller=pool.submit(_jax_labeller, root),
                       small=pool.submit(_jax_small))
        yield dict(root=root, futures=futures)
        for future in futures.values():
            future.result()


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(ref).max())), f"{what}: max abs err {err:.3e}"


def _angle(Ra, Rb) -> float:
    D = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.arcsin(min(1.0, np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]) / 2)))


def _check_poses(got, ref, what, pos_tol=SEQ_POS_TOL, rot_tol=SEQ_ROT_TOL):
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    pos = float(np.abs(got[:, :3, 3] - ref[:, :3, 3]).max()) if len(ref) else 0.0
    rot = max((_angle(a[:3, :3], b[:3, :3]) for a, b in zip(got, ref)), default=0.0)
    print(f"{what}: worst pose gap {pos:.2e} m, {rot:.2e} rad")
    assert pos <= pos_tol and rot <= rot_tol, (what, pos, rot)


def _check_back_end(got, ref, what):
    assert (got["keyframes"], got["edges"], got["loops"]) == (ref["keyframes"], ref["edges"], ref["loops"]), what
    _close(got["weights"], ref["weights"], f"{what} edge weights", 0.05)
    _close(got["Z_t"], ref["Z_t"], f"{what} edge translations", SEQ_POS_TOL)
    _check_poses(got["final"], ref["final"], f"{what} final_trajectory")
    if ref["live"] is not None:
        _check_poses(got["live"], ref["live"], f"{what} live poses")


def test_run_slam_cli_matches_tools_run_slam(refs, capsys):
    """The port's CLI (``--device cpu``) against ``tools/run_slam.py`` on ``test_run_slam_cli_full_backend``'s
    sequence: the same printed lines, their numbers within 5e-3, and the trajectory files within the
    sequence bound (frames 3 and 5 converge millimetres apart, the file's docstring)."""
    root = refs["root"]
    port_run_slam.main(["--config-file", os.path.join(root, "cfg.py"), "--device", "cpu", "--options",
                        f"save_path={root}/port"])
    ours = capsys.readouterr().out
    theirs = refs["futures"]["cli"].result()
    number = re.compile(r"[-+]?\d+\.\d+|\d+")
    skip = ("Processed",)  # the throughput line's numbers are the host's clock
    lines = [[ln for ln in out.strip().splitlines() if not ln.startswith(skip)] for out in (ours, theirs)]
    assert [number.sub("#", ln) for ln in lines[0]] == [number.sub("#", ln) for ln in lines[1]], (ours, theirs)
    for a, b in zip(*lines):
        np.testing.assert_allclose([float(x) for x in number.findall(a)], [float(x) for x in number.findall(b)],
                                   atol=5e-3, err_msg=a)
    assert any(ln.startswith("ATE RMSE:") for ln in lines[0]) and any("live" in ln for ln in lines[0])
    assert any(ln.startswith("Processed 6 scans") for ln in ours.splitlines())
    traj = [np.loadtxt(os.path.join(root, d, "traj_00.txt")).reshape(-1, 3, 4) for d in ("port", "jax")]
    _check_poses(traj[0], traj[1], "run_slam trajectory")


def test_back_end_keyframes_graph_and_final_trajectory_match_jax(refs):
    """``SemanticSLAM.process`` over 9 scans (1,024 scan points; keyframes every 0.5 m, graph solves every 4
    keyframes, loop candidates by position, 3 keyframes apart and within 2 m: the way back): the keyframes,
    edges, loop closures, live poses and the retro-corrected ``final_trajectory``."""
    slam = SemanticSLAM(SlamConfig(odometry=OdometryConfig(**KEYFRAME_ODO), **KEYFRAME_RUN), device="cpu")
    for scan in _keyframe_run_scans():
        slam.process(scan)
    got = _back_end_summary(slam)
    _check_back_end(got, refs["futures"]["keyframe_run"].result(), "keyframe run")
    assert got["keyframes"] >= 4 and got["loops"] >= 1


def test_drifted_loop_closure_and_solve_match_jax(refs):
    """The drifted square loop: the candidates (pose gate, and the descriptor matches past it with their
    yaw-aligned guesses at 2 m), each one's ICP registration, the one loop edge the drift budget lets
    through, and ``final_trajectory``'s solve with the faded priors.

    Keyframes 0 and 1 both lie at the loop's end: their registrations reach 1,923 and 1,924 inliers in JAX
    and 1,923 and 1,923 in the port (a near-collinear neighbourhood's planarity, see
    ``tests/test_torch_slam.py``), and the closure keeps the first of the most inliers.  So the edge's end is
    held to the candidates within 2 inliers of the most, and the solve runs on JAX's edge."""
    from pointcept_keypointdetection_tpu_torch.slam import semantic_slam as port_module

    ref = refs["futures"]["drift_loop"].result()
    slam = _drift_loop(lambda cfg: SemanticSLAM(cfg, device="cpu"), SlamConfig(**DRIFT_LOOP),
                       port_frontend.scan_descriptor)
    got = _close_drift_loop(slam, port_module)
    assert [c[0] for c in got["candidates"]] == [c[0] for c in ref["candidates"]]
    for ((j, _), (R, t, rmse, inliers)), (_, (R_ref, t_ref, rmse_ref, inliers_ref)) in zip(got["candidates"],
                                                                                          ref["candidates"]):
        gap = (float(np.abs(t - t_ref).max()), _angle(R, R_ref))
        print(f"candidate {j}: inliers {inliers} (JAX {inliers_ref}), pose gap {gap[0]:.2e} m {gap[1]:.2e} rad")
        if inliers_ref >= DRIFT_LOOP["loop_min_inliers"]:  # a registration that locks on
            assert abs(inliers - inliers_ref) <= 2 and abs(rmse - rmse_ref) <= 1e-3
            assert gap[0] <= POS_TOL and gap[1] <= ROT_TOL, (j, gap)
        else:  # one that wanders off within its gates: rejected on both sides
            assert inliers < DRIFT_LOOP["loop_min_inliers"]
    assert (got["loops"], got["edges"]) == (ref["loops"], ref["edges"]) == (1, len(slam.kf_R))
    most = max(c[1][3] for c in ref["candidates"])
    near = {c[0][0] for c in ref["candidates"] if c[1][3] >= most - 2}
    assert got["edge"][0] in near and ref["edge"][0] in near, (got["edge"][:2], ref["edge"][:2], near)
    slam.edges[-1] = ref["edge"]
    summary = _back_end_summary(slam)
    _check_back_end(summary, ref["summary"], "drifted loop")
    assert np.abs(summary["final"][:, :3, 3] - slam.kf_t[0]).max() > 1.0  # the solve moved the chain


def test_imu_propagate_matches_jax(refs):
    """Constant acceleration, a constant yaw rate, and random rates with biases and padded samples."""
    refs_imu = refs["futures"]["small"].result()["imu"]
    for (gyro, accel, dt, bias), ref in zip(_imu_cases(), refs_imu):
        state = ImuState.identity("cpu")._replace(bg=torch.from_numpy(bias[:3]), ba=torch.from_numpy(bias[3:]))
        out = propagate(state, torch.from_numpy(gyro), torch.from_numpy(accel), torch.from_numpy(dt))
        for name, got, want in zip(ImuState._fields, out, ref):
            _close(got.numpy(), want, f"imu {name}")


@pytest.mark.parametrize("prior", ["vector", "scalar", "none"])
def test_pose_graph_optimize_matches_jax(refs, prior):
    """Six Gauss-Newton steps on the perturbed chain with its noisy loop edge: a per-node prior, a scalar one,
    none (the gauge fixed by eliminating node 0)."""
    g = _graph()
    graph = PoseGraph(R=torch.from_numpy(g["R"]), t=torch.from_numpy(g["t"]), node_valid=torch.ones(24, dtype=torch.bool),
                      edge_i=torch.from_numpy(g["ei"]), edge_j=torch.from_numpy(g["ej"]), Z_R=torch.from_numpy(g["Z_R"]),
                      Z_t=torch.from_numpy(g["Z_t"]), edge_weight=torch.from_numpy(g["w"]))
    weight = {"vector": torch.from_numpy(g["prior"]), "scalar": 0.2, "none": 0.0}[prior]
    out = optimize(graph, iters=6, prior_weight=weight)
    R, t = refs["futures"]["small"].result()[f"graph_{prior}"]
    _close(out.R.numpy(), R, "R", 1e-4)
    _close(out.t.numpy(), t, "t", 1e-4)
    assert np.abs(t - g["t"]).max() > 1e-3  # the solve moved the nodes
    np.testing.assert_array_equal(out.t[0].numpy(), g["t"][0])  # node 0 is fixed


def test_frontend_matches_jax_numpy():
    """Descriptors (geometry, labels, an embedding), the recovered yaw and the index's top-k: equal."""
    from pointcept_keypointdetection_tpu.slam import frontend as jax_frontend

    rng = np.random.default_rng(0)
    scans = [_place(rng, i) for i in range(6)]
    labels = rng.integers(0, 40, len(scans[0]))
    for args in ((scans[0],), (scans[0], labels), (scans[0], labels, rng.normal(size=16)), (scans[1], None,
                                                                                            rng.normal(size=4))):
        for a, b in zip(port_frontend.scan_descriptor(*args), jax_frontend.scan_descriptor(*args)):
            np.testing.assert_array_equal(a, b)
    cfg = port_frontend.DescriptorConfig(range_bins=8, azimuth_bins=36, w_semantic=0.3)
    jcfg = jax_frontend.DescriptorConfig(range_bins=8, azimuth_bins=36, w_semantic=0.3)
    np.testing.assert_array_equal(port_frontend.scan_descriptor(scans[2], labels[:4000], cfg=cfg)[0],
                                  jax_frontend.scan_descriptor(scans[2], labels[:4000], cfg=jcfg)[0])
    rotz = lambda a: np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)  # noqa
    _, p0 = port_frontend.scan_descriptor(scans[0])
    _, p1 = port_frontend.scan_descriptor(scans[0] @ rotz(0.6).T)
    assert port_frontend.relative_yaw(p0, p1) == jax_frontend.relative_yaw(p0, p1)
    ours, theirs = port_frontend.DescriptorIndex(), jax_frontend.DescriptorIndex()
    for scan in scans:
        for index in (ours, theirs):
            index.add(*port_frontend.scan_descriptor(scan))
    query = port_frontend.scan_descriptor(scans[3] + 0.02)[0]
    for max_index, topk, min_sim in ((6, 3, 0.0), (4, 2, 0.5), (0, 3, 0.0), (6, 6, 0.99)):
        assert ours.query(query, max_index, topk, min_sim) == theirs.query(query, max_index, topk, min_sim)


def test_model_label_path_matches_jax(refs):
    """The labeller of ``semantic.labels_from="model"`` (the tiny SpUNet of
    ``test_model_label_path_wires_learned_embedding``, one JAX checkpoint read by both): labels equal, the
    embedding within 1e-4; and ``SemanticSLAM.process`` threads it into the keyframe descriptor."""
    root = refs["root"]
    label_fn = port_run_slam.build_label_fn(Config.fromfile(os.path.join(root, "sem_port.py")), "cpu")
    scan = np.load(os.path.join(root, "scan.npy"))
    labels, emb = label_fn("unused.bin", scan)
    ref_labels, ref_emb = refs["futures"]["labeller"].result()
    np.testing.assert_array_equal(labels, ref_labels)
    _close(emb, ref_emb, "embedding", 1e-4)
    assert emb.shape == (6,) and np.abs(emb).sum() > 0
    slam = SemanticSLAM(SlamConfig(odometry=OdometryConfig(**dict(ODO, icp_iters=2)), keyframe_scan_size=512),
                        device="cpu")
    slam.process(scan, labels, embedding=emb)
    dcfg = slam.descriptor_cfg
    assert len(slam.descriptor_index.descriptor(0)) == dcfg.range_bins * dcfg.height_bins + dcfg.num_classes + 6


class _NoBackboneFeat(torch.nn.Module):
    """A segmentor whose ``forward`` takes no ``backbone_feat``: the labeller pools its logits."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, point):
        return {"seg_logits": self.inner(point)["seg_logits"]}


def test_labeller_pools_logits_without_backbone_feat(refs):
    root = refs["root"]
    predictor = SemanticScanPredictor(os.path.join(root, "sem.py"), os.path.join(root, "sem.ckpt"), slot=SEM_SLOT,
                                      device="cpu")
    feat_labels, feat_emb = predictor(np.load(os.path.join(root, "scan.npy")))
    predictor.model = _NoBackboneFeat(predictor.model)
    res = predictor.infer(np.load(os.path.join(root, "scan.npy")), logits=True)
    n = res["seg_logits"].shape[0]
    np.testing.assert_allclose(res["embedding"], res["seg_logits"].mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(res["labels"], feat_labels)
    np.testing.assert_allclose(feat_emb, res["embedding"], rtol=1e-5, atol=1e-6)  # DefaultSegmentor's are its logits
    assert n > 100


def test_semantic_slam_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        SemanticSLAM(SlamConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        port_run_slam.main(["--config-file", "configs/slam/synth_loop.py"])

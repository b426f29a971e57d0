"""The port's SLAM odometry (``slam/se3``, ``registration``, ``voxel_map``, ``pipeline``, ``ordered`` and
the SLAM options of ``ops/knn.py``) against the JAX package on the CPU.

Inputs are made with numpy from seeds; the JAX references are computed in
three threads started by the file's first test (each odometry in one, the
rest, jitted, in the third), while the port runs on the main thread, its
odometry first.

Tolerances.  f32 functions of one step (se3, the plane fits on well
conditioned neighbourhoods): 2e-6.  The closed-form eigen-solve amplifies a
last-bit difference near a double root (a plane through three points, where
lambda_min and lambda_mid both sit near 0): the arccos of a determinant
within an ulp of 1.  JAX rounds such rows otherwise under ``jit`` than
eagerly, and the port cannot follow either bit for bit.  The rows whose planarity gate or normal moves
are those; a registration whose correspondences include them moves by
~1e-4 m after one Gauss-Newton step, and the following steps re-gate on the
moved pose.  So the registrations and the odometry are held to 2e-3 m and
5e-4 rad a pose (the JAX package's own trajectory on the CPU and the
committed one from the TPU are 1.8 mm apart over the loop circuit's first 20
frames), and each test prints the gate counts where a pose is off.  Integer
outputs (kNN indices where the k-th and (k+1)-th candidates are clearly
apart, map validity, the ring offsets) match exactly.
"""

import importlib
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import assert_clear_kth_neighbours

from pointcept_keypointdetection_tpu_torch.ops import knn as port_knn
from pointcept_keypointdetection_tpu_torch.slam import ordered, se3
from pointcept_keypointdetection_tpu_torch.slam import registration as port_reg
from pointcept_keypointdetection_tpu_torch.slam import voxel_map as port_vm
from pointcept_keypointdetection_tpu_torch.slam.evaluate import absolute_trajectory_error
from pointcept_keypointdetection_tpu_torch.slam.pipeline import (LidarOdometry, OdometryConfig, insert_depth,
                                                                  search_cell_cap, search_depth)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

F32_TOL = 2e-6
POS_TOL = 2e-3  # m a pose
ROT_TOL = 5e-4  # rad a pose
MAP_ORIGIN = (-50.0, -50.0, -20.0)
WORLD_CFG = dict(scan_capacity=2048, map_capacity=8192, scan_voxel=0.4, map_voxel=0.4, icp_iters=6,
                 max_corr_dist=1.5, min_range=0.0, max_range=50.0, map_origin=MAP_ORIGIN, map_radius=100.0)
STREET_CFG = dict(scan_capacity=4096, map_capacity=32768, scan_voxel=0.5, map_voxel=0.4, icp_iters=6, knn_k=5,
                  max_corr_dist=1.0, min_planarity=0.5, map_radius=80.0, min_range=2.0, max_range=40.0)
KNN_CASES = {  # name: (cell, cap, depth, ring_radius, ring_corr_cells, verify_codes, lattice_origin, k)
    "unit_cell": (0.4, 1, 8, 3, 2.5, False, MAP_ORIGIN, 5),
    "ring2": (0.5, 8, 8, 2, None, True, None, 4),
    "shallow_overflow": (1.0, 3, 4, 1, None, True, MAP_ORIGIN, 3),
}
ICP_SEARCHES = {
    "bucketed": dict(max_corr_dist=1.5),
    "unit_cell": dict(max_corr_dist=1.0, cell_size=0.4, lattice_origin=MAP_ORIGIN),
    "brute": dict(max_corr_dist=1.5, bucketed=False),
    "search_every": dict(max_corr_dist=1.5, search_every=2, index_depth=8),
}


def _rotz(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _structured_world(rng, n=4000):
    """Ground plane + two walls (``tests/test_slam.py``'s world)."""
    n1, n2, n3 = n // 2, n // 4, n - n // 2 - n // 4
    ground = np.stack([rng.uniform(-20, 20, n1), rng.uniform(-20, 20, n1), rng.normal(0, 0.01, n1)], 1)
    wall1 = np.stack([rng.uniform(-20, 20, n2), np.full(n2, 8.0) + rng.normal(0, 0.01, n2), rng.uniform(0, 4, n2)], 1)
    wall2 = np.stack([np.full(n3, -6.0) + rng.normal(0, 0.01, n3), rng.uniform(-20, 20, n3), rng.uniform(0, 4, n3)], 1)
    return np.concatenate([ground, wall1, wall2]).astype(np.float32)


def _dedup(points: np.ndarray, voxel: float, origin) -> np.ndarray:
    """The first point of each voxel of ``voxel`` from ``origin``: a map's lattice, one point per cell."""
    cells = np.floor((points - np.asarray(origin, np.float32)) / np.float32(voxel)).astype(np.int64)
    _, first = np.unique(cells, axis=0, return_index=True)
    return points[np.sort(first)]


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 3)) * 0.8).astype(np.float32)
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-7, 1e-5, 1e-3, np.pi - 1e-3, np.pi - 1e-5, np.pi, 2.0])[:, None]
    w = np.concatenate([w, (axis * angles).astype(np.float32)])
    xi = np.concatenate([w, (rng.normal(size=w.shape) * 2).astype(np.float32)], 1)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)  # tests/test_slam.py::test_eig3x3_matches_eigh's 600
    cov = a @ a.transpose(0, 2, 1)
    b = rng.normal(size=(100, 3, 2)).astype(np.float32)
    planar = b @ b.transpose(0, 2, 1) + 1e-6 * np.eye(3, dtype=np.float32)
    cov = np.concatenate([cov, planar, np.zeros((1, 3, 3), np.float32), np.eye(3, dtype=np.float32)[None]])
    # plane fits: noisy planar patches of 5 neighbours, some neighbours invalid
    centre = rng.uniform(-10, 10, (400, 1, 3))
    normal = rng.normal(size=(400, 1, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    spread = rng.normal(size=(400, 5, 3)) * 0.3
    spread -= (spread * normal).sum(-1, keepdims=True) * normal
    nb = (centre + spread + rng.normal(size=(400, 5, 1)) * 0.01 * normal).astype(np.float32)
    nv = rng.uniform(size=(400, 5)) < 0.9
    world = _structured_world(np.random.default_rng(0))
    return dict(w=w, xi=xi, cov=cov, nb=nb, nv=nv, world=world, knn=_knn_inputs(world))


def _knn_inputs(world):
    rng = np.random.default_rng(4)
    base = _dedup(world, 0.4, MAP_ORIGIN)
    valid = rng.uniform(size=len(base)) < 0.95
    query = (base[rng.choice(len(base), 600, replace=False)] + rng.normal(size=(600, 3)) * 0.5).astype(np.float32)
    crowd = np.concatenate([world, (world[:40] * 0.01 + 3.0).astype(np.float32)])  # 40 rows in one cell
    far = np.array([[200.0, 0.0, 0.0], [-15.0, 30.0, 2.0]], np.float32)  # beyond 2^4 cells of the origin
    return {"unit_cell": (base, valid, query), "ring2": (world, np.ones(len(world), bool), query),
            "shallow_overflow": (np.concatenate([crowd, far]), np.ones(len(crowd) + 2, bool),
                                 np.concatenate([query, far, np.full((2, 3), 3.0, np.float32)]))}


def _odometry_world():
    """``test_odometry_on_synthetic_trajectory``'s 6 scans."""
    world = _structured_world(np.random.default_rng(0), n=6000)
    scans, gt = [], []
    for i in range(6):
        R, t = _rotz(0.01 * i), np.array([0.4 * i, 0.05 * i, 0.0])
        gt.append(t)
        scan = (world @ R + (-R.T @ t)).astype(np.float32)
        scans.append(scan[np.linalg.norm(scan, axis=1) < 40])
    return scans, np.array(gt)


def _street():
    """``test_closed_loop_odometry_tracks_synthetic_street``'s 10 scans and their poses."""
    from make_synthetic_kitti import build_world, trajectory

    rng = np.random.default_rng(0)
    world, _ = build_world(rng, length=30.0)
    poses = trajectory(10, step=0.6)
    scans = []
    for T in poses:
        local = (world - T[:3, 3]) @ T[:3, :3]
        r = np.linalg.norm(local, axis=1)
        pts = local[(r > 2.1) & (r < 40.0)]
        if len(pts) > 20000:
            pts = pts[rng.choice(len(pts), 20000, replace=False)]
        pts = (pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
        scans.append(np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1))
    return scans, poses


def _icp_scan(world):
    R = _rotz(0.03) @ np.array([[1, 0, 0], [0, np.cos(0.01), -np.sin(0.01)], [0, np.sin(0.01), np.cos(0.01)]],
                                np.float32)
    t = np.array([0.2, -0.1, 0.05], np.float32)
    return ((world - t) @ R).astype(np.float32)


def _icp_target(world, search):
    """The map: the world on the map's lattice for the unit-cell search, every other point of it for brute
    force (the port's brute search rounds in f64-emulated f32), else the world."""
    return {"unit_cell": lambda: _dedup(world, 0.4, MAP_ORIGIN), "brute": lambda: world[::2]}.get(
        search, lambda: world)()


def _jax_odometry(scans, cfg):
    """JAX's poses over ``scans``."""
    from pointcept_keypointdetection_tpu.slam.pipeline import LidarOdometry as JaxOdometry
    from pointcept_keypointdetection_tpu.slam.pipeline import OdometryConfig as JaxConfig

    odo = JaxOdometry(JaxConfig(**cfg))
    return np.stack([odo.process(s) for s in scans])


def _jax_primitives(inp):
    """JAX's se3, eigen-solve, plane fits, ring offsets, kNN searches, voxel maps and registrations."""
    import jax
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.slam import registration as jreg
    from pointcept_keypointdetection_tpu.slam import se3 as jse3
    from pointcept_keypointdetection_tpu.slam import voxel_map as jvm

    jknn = importlib.import_module("pointcept_keypointdetection_tpu.ops.knn")
    out = {}

    def se3_all(w, xi):
        R = jse3.so3_exp(w)
        Rx, tx = jse3.se3_exp(xi)
        Rc, tc = jse3.se3_compose(Rx[:-1], tx[:-1], Rx[1:], tx[1:])
        Ri, ti = jse3.se3_inverse(Rx, tx)
        return dict(hat=jse3.hat(w), so3_exp=R, so3_log=jse3.so3_log(R), se3_R=Rx, se3_t=tx, compose_R=Rc,
                    compose_t=tc, inverse_R=Ri, inverse_t=ti, transform=jse3.transform(Rx[0], tx[0], xi[:, 3:]))

    out["se3"] = jax.tree.map(np.asarray, jax.jit(se3_all)(inp["w"], inp["xi"]))
    out["eig"] = [np.asarray(a) for a in jax.jit(jreg._eig3x3_smallest)(inp["cov"])]
    out["fit"] = [np.asarray(a) for a in jax.jit(jreg._fit_planes)(inp["nb"], inp["nv"])]
    out["offsets"] = {(r, c): np.asarray(jknn._ring_offsets(r, c)) for r, c in ((1, None), (2, None), (3, None),
                                                                               (3, 2.5), (2, 1.2))}
    for name, (cell, cap, depth, ring, corr, verify, origin, k) in KNN_CASES.items():
        base, valid, query = inp["knn"][name]

        def search(base, valid, query):
            index = jknn.build_knn_index(base, cell, base_valid=valid, cell_cap=cap, depth=depth,
                                         single_lane=3 * depth <= 31, lattice_origin=origin)
            return jknn.knn_query_index(index, query, k, cell, cell_cap=cap, depth=depth, ring_radius=ring,
                                        verify_codes=verify, lattice_origin=origin, ring_corr_cells=corr)

        out[f"knn_{name}"] = [np.asarray(a) for a in jax.jit(search)(base, valid, query)]
    rng = np.random.default_rng(9)
    for depth in (None, 8):
        vmap = jvm.VoxelMap.create(700, 0.5, origin=(0.0, 0.0, 0.0))
        insert = jax.jit(lambda m, p, v, d=depth: jvm.insert(m, p, v, code_depth=d))
        maps = []
        for step in range(3):
            pts = rng.uniform(-1, 20, (500, 3)).astype(np.float32)
            valid = rng.uniform(size=500) < 0.9
            vmap = insert(vmap, pts, valid)
            maps.append((pts, valid, np.asarray(vmap.points), np.asarray(vmap.valid)))
        pruned = jvm.prune(vmap, jnp.asarray([5.0, 5.0, 5.0]), 8.0)
        out[f"voxel_{depth}"] = (maps, np.asarray(pruned.valid))
    scan = _icp_scan(inp["world"])
    for name, kw in ICP_SEARCHES.items():
        target = _icp_target(inp["world"], name)
        res = jreg.point_to_plane_icp(jnp.asarray(scan), jnp.ones(len(scan), bool), jnp.asarray(target),
                                      jnp.ones(len(target), bool), jnp.eye(3), jnp.zeros(3), iters=10, **kw)
        out[f"icp_{name}"] = (np.asarray(res.R), np.asarray(res.t), float(res.rmse), int(res.inliers))
    return out


@pytest.fixture(scope="module")
def refs():
    import pointcept_keypointdetection_tpu.slam  # noqa: F401  (imported once here, not by the threads at once)

    inp = _inputs()
    world_scans, world_gt = _odometry_world()
    street_scans, street_poses = _street()
    with ThreadPoolExecutor(3) as pool:  # the port's odometry runs first in the file, beside JAX's
        futures = dict(world=pool.submit(_jax_odometry, world_scans, WORLD_CFG),
                       street=pool.submit(_jax_odometry, street_scans, STREET_CFG),
                       primitives=pool.submit(_jax_primitives, inp))
        yield dict(inp=inp, world=(world_scans, world_gt), street=(street_scans, street_poses), futures=futures)
        for future in futures.values():
            future.result()


def _ref(refs, key):
    if key in ("world", "street"):
        return refs["futures"][key].result()
    return refs["futures"]["primitives"].result()[key]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, what, tol=F32_TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), f"{what}: max abs err {err:.3e}"


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations from the skew part of Ra^T Rb (its sine: exact near 0, where the
    trace's arccos reads f32 rounding as ~4e-4 rad)."""
    D = Ra.T.astype(np.float64) @ Rb
    return float(np.arcsin(min(1.0, np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]) / 2)))


def _check_trajectory(poses, ref, odo, what):
    gaps = [(float(np.abs(p[:3, 3] - r[:3, 3]).max()), _angle(p[:3, :3], r[:3, :3])) for p, r in zip(poses, ref)]
    worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    print(f"{what}: worst pose gap {worst[0]:.2e} m, {worst[1]:.2e} rad; last scan {odo.last_inliers} inliers")
    assert worst[0] <= POS_TOL and worst[1] <= ROT_TOL, (what, gaps)


def test_odometry_street_matches_jax_and_ground_truth(refs):
    scans, poses_gt = refs["street"]
    odo = LidarOdometry(OdometryConfig(**STREET_CFG), device="cpu")
    poses = [odo.process(s) for s in scans]
    _check_trajectory(poses, _ref(refs, "street"), odo, "street")
    T0_inv = np.linalg.inv(poses_gt[0])
    errs = [np.linalg.norm(p[:3, 3] - (T0_inv @ T)[:3, 3]) for p, T in zip(poses, poses_gt)]
    assert max(errs) < 0.05, errs


def test_odometry_world_matches_jax(refs):
    scans, gt = refs["world"]
    odo = LidarOdometry(OdometryConfig(**WORLD_CFG), device="cpu")
    poses = [odo.process(s) for s in scans]
    _check_trajectory(poses, _ref(refs, "world"), odo, "world")
    ate, _ = absolute_trajectory_error(odo.positions, gt, align=False)
    assert ate < 0.1, ate


def test_se3_matches_jax(refs):
    """hat, so3_exp, so3_log (angles from 0 to pi), se3_exp, compose, inverse and transform."""
    inp = refs["inp"]
    w, xi = _t(inp["w"]), _t(inp["xi"])
    R = se3.so3_exp(w)
    Rx, tx = se3.se3_exp(xi)
    Rc, tc = se3.se3_compose(Rx[:-1], tx[:-1], Rx[1:], tx[1:])
    Ri, ti = se3.se3_inverse(Rx, tx)
    got = dict(hat=se3.hat(w), so3_exp=R, so3_log=se3.so3_log(R), se3_R=Rx, se3_t=tx, compose_R=Rc, compose_t=tc,
               inverse_R=Ri, inverse_t=ti, transform=se3.transform(Rx[0], tx[0], xi[:, 3:]))
    ref = _ref(refs, "se3")
    got["so3_log"] = se3.so3_log(_t(ref["so3_exp"]))  # on JAX's matrices: near pi a last bit of R moves it far
    for key, value in got.items():
        _close(value, ref[key], key)


def test_eig3x3_matches_jax(refs):
    """The 600 covariances of ``test_eig3x3_matches_eigh``, a zero and an identity matrix (the +z fallback)."""
    inp = refs["inp"]
    lam_min, lam_mid, v = port_reg._eig3x3_smallest(_t(inp["cov"]))
    ref_min, ref_mid, ref_v = _ref(refs, "eig")
    scale = np.abs(np.linalg.eigvalsh(inp["cov"].astype(np.float64))).max(1)
    for got, ref, what in ((lam_min, ref_min, "lambda_min"), (lam_mid, ref_mid, "lambda_mid")):
        err = np.abs(got.numpy() - ref) / np.maximum(scale, 1.0)
        assert err.max() <= 2e-4, (what, err.max())
        assert np.median(err) <= 1e-6, (what, np.median(err))
    dot = np.abs((v.numpy() * ref_v).sum(-1))
    assert (dot > 0.999).mean() > 0.98, dot.min()
    np.testing.assert_array_equal(v[-2:].numpy(), [[0, 0, 1], [0, 0, 1]])
    np.testing.assert_array_equal(ref_v[-2:], [[0, 0, 1], [0, 0, 1]])


def test_fit_planes_matches_jax(refs):
    """Noisy planar patches of 5 neighbours, each valid with probability 0.9: centroids everywhere; normals,
    planarity and the planarity gate where the two larger eigenvalues of the neighbours' covariance are
    apart from the smallest (lambda_mid > 1e-2 lambda_max in f64: three points, or four nearly on a line,
    make a double root of the eigen-solve near 0, see the file's docstring)."""
    inp = refs["inp"]
    centroid, normal, planarity = port_reg._fit_planes(_t(inp["nb"]), _t(inp["nv"]))
    ref_c, ref_n, ref_p = _ref(refs, "fit")
    _close(centroid, ref_c, "centroid")
    w = inp["nv"][..., None].astype(np.float64)
    count = np.maximum(w.sum(1), 1.0)
    centred = (inp["nb"] - ((inp["nb"] * w).sum(1) / count)[:, None]) * w
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", centred, centred) / count[..., None])
    rows = lam[:, 1] > 1e-2 * lam[:, 2]
    assert rows.mean() > 0.8
    sign = np.sign((normal.numpy() * ref_n).sum(-1, keepdims=True))
    _close((normal * torch.from_numpy(sign)).numpy()[rows], ref_n[rows], "normal", 1e-4)
    _close(planarity.numpy()[rows], ref_p[rows], "planarity", 1e-4)
    gate = (planarity.numpy() > 0.6) != (ref_p > 0.6)
    assert not gate[rows].any(), f"{gate[rows].sum()} planarity gates differ"


def test_ring_offsets_match_jax(refs):
    for (radius, corr), ref in _ref(refs, "offsets").items():
        np.testing.assert_array_equal(port_knn._ring_offsets(radius, corr), ref, err_msg=f"{radius} {corr}")


@pytest.mark.parametrize("name", list(KNN_CASES))
def test_knn_query_index_options_match_jax(refs, name, monkeypatch):
    """``lattice_origin`` with the unit-cell ring (radius 3, the distance-gate prune, no code check, cap 1) on a
    map's lattice; the sphere-pruned ring of radius 2; a 2^4-cell domain that drops base rows and misses ring
    cells, with a cell of 40 rows at cap 3 (its first 3 in base order)."""
    cell, cap, depth, ring, corr, verify, origin, k = KNN_CASES[name]
    base, valid, query = refs["inp"]["knn"][name]
    index = port_knn.build_knn_index(_t(base), cell, base_valid=_t(valid), cell_cap=cap, depth=depth,
                                     lattice_origin=origin)
    kw = dict(cell_cap=cap, depth=depth, ring_radius=ring, verify_codes=verify, lattice_origin=origin,
              ring_corr_cells=corr)
    idx, sqd = port_knn.knn_query_index(index, _t(query), k, cell, **kw)
    assert_clear_kth_neighbours([(port_knn.knn_query_index, (index, _t(query), k, cell), kw)])
    ref_idx, ref_sqd = _ref(refs, f"knn_{name}")
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    hit = ref_sqd < 1e9
    np.testing.assert_array_equal(sqd.numpy() < 1e9, hit)
    np.testing.assert_allclose(sqd.numpy()[hit], ref_sqd[hit], rtol=1e-6, atol=1e-6)
    assert hit.any() and (~hit).any()  # both found and missing slots are exercised


@pytest.mark.parametrize("depth", [None, 8])
def test_voxel_map_insert_and_prune_match_jax(refs, depth):
    """Three inserts past the capacity (700 of ~1,300 voxels: the highest codes go) with 10% invalid rows and
    points outside the grid, then a prune: validity integer-exact, points equal."""
    maps, pruned = _ref(refs, f"voxel_{depth}")
    vmap = port_vm.VoxelMap.create(700, 0.5, origin=(0.0, 0.0, 0.0), device="cpu")
    for pts, valid, ref_points, ref_valid in maps:
        vmap = port_vm.insert(vmap, _t(pts), _t(valid), code_depth=depth)
        np.testing.assert_array_equal(vmap.valid.numpy(), ref_valid)
        np.testing.assert_array_equal(vmap.points.numpy(), ref_points)
    assert vmap.valid.all()
    out = port_vm.prune(vmap, torch.tensor([5.0, 5.0, 5.0]), 8.0)
    np.testing.assert_array_equal(out.valid.numpy(), pruned)
    assert 0 < pruned.sum() < 700


@pytest.mark.parametrize("search", list(ICP_SEARCHES))
def test_icp_matches_jax(refs, search):
    """One registration of ``test_icp_recovers_known_transform``'s world (10 iterations) through each search:
    the bucketed one, the unit-cell one on the map's lattice, brute force, and the bucketed one searching every
    second iteration."""
    world = refs["inp"]["world"]
    scan = _icp_scan(world)
    kw = ICP_SEARCHES[search]
    target = _icp_target(world, search)
    res = port_reg.point_to_plane_icp(_t(scan), torch.ones(len(scan), dtype=torch.bool), _t(target),
                                      torch.ones(len(target), dtype=torch.bool), torch.eye(3), torch.zeros(3),
                                      iters=10, **kw)
    R, t, rmse, inliers = _ref(refs, f"icp_{search}")
    gap = (float(np.abs(res.t.numpy() - t).max()), _angle(res.R.numpy(), R))
    assert gap[0] <= POS_TOL and gap[1] <= ROT_TOL, (gap, int(res.inliers), inliers)
    assert abs(int(res.inliers) - inliers) <= 0.01 * inliers and abs(float(res.rmse) - rmse) <= 1e-3
    np.testing.assert_allclose(res.t.numpy(), [0.2, -0.1, 0.05], atol=1e-2)  # registered, as in the JAX test


def test_odometry_depths_match_jax_pipeline():
    """The index and insert depths and the cell cap the pipeline derives (`pipeline.py:155-206`)."""
    for kw in (dict(), STREET_CFG, dict(map_radius=25.0, max_range=60.0, map_voxel=0.35, max_corr_dist=1.0),
               dict(map_radius=1000.0, max_corr_dist=0.5)):
        cfg = OdometryConfig(**kw)
        span = (2.0 * cfg.map_radius + 2.0 * cfg.max_motion) / cfg.max_corr_dist + 8
        d = max(int(np.ceil(np.log2(span))), 4)
        assert search_depth(cfg) == (None if 3 * d > 31 else d)
        span = (2.0 * max(cfg.map_radius, cfg.max_range) + 2.0 * cfg.max_motion) / cfg.map_voxel + 8
        d = max(int(np.ceil(np.log2(span))), 4)
        assert insert_depth(cfg) == (d if 3 * d <= 31 else None)
        assert search_cell_cap(cfg) == min(int(np.ceil(cfg.max_corr_dist / cfg.map_voxel) + 1) ** 3, 128)
    assert search_depth(OdometryConfig(map_radius=25.0)) == 6 and insert_depth(OdometryConfig()) == 10


def test_ordered_arithmetic():
    """Fixed-order sums against torch's, the Cholesky solve against ``torch.linalg.solve``, the f64-rounded
    functions against f64 references (correctly rounded: equal to numpy's f64 result rounded to f32)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1000, 6)).astype(np.float32)
    np.testing.assert_allclose(ordered.tree_sum(_t(x)).numpy(), x.astype(np.float64).sum(0), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ordered.osum(_t(x)).numpy(), x.astype(np.float64).sum(1), rtol=0, atol=1e-5)
    J = rng.normal(size=(50, 6))
    H = (J.T @ J + np.eye(6)).astype(np.float32)
    g = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(ordered.solve_spd(_t(H), _t(g)).numpy(), np.linalg.solve(H.astype(np.float64), g),
                               rtol=1e-4, atol=1e-5)
    v = np.abs(x.reshape(-1))
    for fn, ref in ((ordered.sqrt, np.sqrt), (ordered.sin, np.sin), (ordered.cos, np.cos)):
        np.testing.assert_array_equal(fn(_t(v)).numpy(), ref(v.astype(np.float64)).astype(np.float32))
    a, b = _t(x[:, :3]), _t(x[:, 3:])
    np.testing.assert_allclose(ordered.cross(a, b).numpy(), np.cross(x[:, :3], x[:, 3:]), atol=1e-5)


def test_odometry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        LidarOdometry(OdometryConfig())

"""The port's pose-graph backend against the JAX package's, on the CPU.

Both solve in float32. On the graphs where CG converges steadily the port's
poses stay within 1e-4 m and 1e-5 rad of the JAX package's. On the graphs
whose float32 solve is chaotic (the yaw-only closure, Huber and plain
Gauss-Newton with the outlier: 200-300 CG steps past convergence amplify an
ulp into centimetres or metres, and the JAX package's own float32 answer
differs from its float64 one by 0.3-56 m there), the port is held to the
reference's outcome, to within the reference's own float32 noise, to its
first chi2, and, but for plain Gauss-Newton, tightly for one Gauss-Newton
iteration of 50 CG steps.
"""

import numpy as np
import pytest
import torch

import jax
from overlapnet_tpu import backend as jb
from overlapnet_tpu.backend import pose_graph as jpg
from overlapnet_tpu.lcd.online import LoopClosure as JaxLoopClosure
from overlapnet_torch import backend as tb
from overlapnet_torch.backend import ate as tate
from overlapnet_torch.backend import pose_graph as tpg
from overlapnet_torch.lcd.online import LoopClosure
from overlapnet_torch.parallel.mesh import make_mesh

from test_backend import drifted_odometry, square_trajectory

XY_TOL, TH_TOL = 1e-4, 1e-5
CHI2_RTOL = 1e-4


def _angle_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _pose_diffs(a, b):
    return np.abs(a[:, :2] - b[:, :2]).max(), _angle_diff(a[:, 2], b[:, 2]).max()


def _both(graph, est, **kw):
    """(JAX poses, chi2), (port poses, chi2) of one solve on the CPU."""
    return jpg.optimize_pose_graph(graph, est, **kw), tpg.optimize_pose_graph(
        graph, est, device="cpu", **kw)


class _Closure:  # the JAX test's minimal LoopClosure stand-in
    def __init__(self, frame, match, yaw_deg):
        self.frame, self.match, self.yaw_deg = frame, match, yaw_deg
        self.overlap = 1.0


def _loop():
    gt = square_trajectory(side=25)
    return gt, drifted_odometry(gt, yaw_drift=0.004)


def _relative_closures(gt, pairs, outlier=False):
    z = np.stack([np.asarray(jpg.relative_pose(gt[a], gt[b])) for a, b in pairs])
    if outlier:
        z[3] = np.array([40.0, -40.0, 2.0])  # frames 25/75 are far apart
    return jb.relative_pose_edges(pairs, z, len(gt))


def _graph(case):
    """(ground truth, initial poses, graph, solver kwargs) of the JAX
    package's tests/test_backend.py cases."""
    if case == "odometry_only":  # :71
        gt = square_trajectory(side=10)
        return gt, gt, jb.odometry_edges(gt), dict(iterations=3)
    gt, est = _loop()
    n = len(gt)
    if case == "loop_closure_fixes_drift":  # :85
        pairs = np.array([[0, n - 1], [0, n - 2], [1, n - 1], [2, n - 1]])
        graph = jb.odometry_edges(est).merged(_relative_closures(gt, pairs))
        return gt, est, graph, dict(iterations=30, cg_iters=300)
    if case == "yaw_only_closure":  # :108
        graph = jb.odometry_edges(est).merged(jb.closures_to_edges(
            [_Closure(n - 1, 0, 0.0)], n, xy_information=10.0))
        return gt, est, graph, dict(iterations=20, cg_iters=200)
    pairs = np.array([[0, n - 1], [0, n - 2], [1, n - 1], [25, 75]])  # :141
    graph = jb.odometry_edges(est).merged(_relative_closures(gt, pairs, outlier=True))
    kw = {"outlier_plain": {},
          "outlier_huber": dict(robust_delta=2.0),
          "outlier_tukey": dict(robust_delta=3.0, robust_kernel="tukey",
                                robust_anneal_start=300.0)}[case]
    return gt, est, graph, dict(iterations=30, cg_iters=300, **kw)


def test_relative_pose_wrap_and_se3_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-30, 30, (64, 3))
    b = rng.uniform(-30, 30, (64, 3))
    a[:, 2], b[:, 2] = rng.uniform(-7, 7, 64), rng.uniform(-7, 7, 64)
    want = np.stack([np.asarray(jpg.relative_pose(x, y)) for x, y in zip(a, b)])
    got = tpg.relative_pose(a, b).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpg.wrap_angle(a[:, 2]).numpy(),
                               np.asarray(jpg.wrap_angle(a[:, 2])), rtol=0, atol=1e-6)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[1, :2, 3] = 5.0, -2.0
    c, s = np.cos(0.7), np.sin(0.7)
    poses[2, :2, :2] = [[c, -s], [s, c]]
    np.testing.assert_array_equal(tpg.poses_se3_to_se2(poses), jpg.poses_se3_to_se2(poses))


def test_edges_and_ate_match_jax():
    gt, est = _loop()
    n = len(gt)
    jodo, todo = jb.odometry_edges(est), tb.odometry_edges(est)
    np.testing.assert_array_equal(todo.edges_i, jodo.edges_i)
    np.testing.assert_array_equal(todo.edges_j, jodo.edges_j)
    np.testing.assert_array_equal(todo.informations, jodo.informations)
    # float32 measurements: an ulp or two of 25 m
    np.testing.assert_allclose(todo.measurements, jodo.measurements, rtol=0, atol=4e-6)

    kw = dict(frame=40, match=3, overlap=0.35, yaw_deg=-91.0, confidence=0.4)
    jcl = jb.closures_to_edges([JaxLoopClosure(**kw), _Closure(n - 1, 0, 10.0)], n)
    tcl = tb.closures_to_edges([LoopClosure(**kw), _Closure(n - 1, 0, 10.0)], n)
    pairs = np.array([[0, n - 1], [5, 50]])
    z = np.array([[1.0, 2.0, 0.3], [-4.0, 0.5, -2.0]])
    for t, j in ((tcl, jcl), (todo.merged(tcl), jodo.merged(jcl)),
                 (tb.relative_pose_edges(pairs, z, n), jb.relative_pose_edges(pairs, z, n))):
        assert t.n_poses == j.n_poses and t.n_edges == j.n_edges
        for field in ("edges_i", "edges_j", "informations"):
            np.testing.assert_array_equal(getattr(t, field), getattr(j, field), err_msg=field)
        np.testing.assert_allclose(t.measurements, j.measurements, rtol=0, atol=4e-6)
    with pytest.raises(ValueError):
        todo.merged(tb.odometry_edges(est[:10]))

    assert tb.absolute_trajectory_error(est, gt) == jb.absolute_trajectory_error(est, gt)
    moved = gt[:, :2] @ np.array([[0.6, -0.8], [0.8, 0.6]]).T + [10.0, -3.0]
    np.testing.assert_array_equal(tate.align_rigid_2d(moved, gt[:, :2]),
                                  jb.ate.align_rigid_2d(moved, gt[:, :2]))


@pytest.mark.parametrize("case, chi2_rtol", [
    ("odometry_only", CHI2_RTOL), ("loop_closure_fixes_drift", CHI2_RTOL),
    # the rejected outlier's term dominates chi2 and follows the mid-solve
    # poses, which wander more than the answer: 7.6e-4 measured
    ("outlier_tukey", 1e-3)])
def test_optimize_matches_jax(case, chi2_rtol):
    gt, est, graph, kw = _graph(case)
    (jp, jchi), (tp, tchi) = _both(graph, est, **kw)
    assert tp.dtype == np.float32 and tp.shape == jp.shape and tchi.shape == jchi.shape
    d_xy, d_th = _pose_diffs(tp, jp)
    assert d_xy <= XY_TOL and d_th <= TH_TOL, (d_xy, d_th)
    # late chi2 values are near zero: relative to the first
    np.testing.assert_allclose(tchi, jchi, rtol=chi2_rtol, atol=chi2_rtol * jchi[0])
    ate_t = tb.absolute_trajectory_error(tp, gt)["ate_rmse"]
    ate_j = jb.absolute_trajectory_error(jp, gt)["ate_rmse"]
    assert abs(ate_t - ate_j) <= XY_TOL, (ate_t, ate_j)


@pytest.mark.parametrize("case", ["yaw_only_closure", "outlier_huber", "outlier_plain"])
def test_chaotic_solves_stay_within_the_references_own_float32_noise(case):
    gt, est, graph, kw = _graph(case)
    (jp, jchi), (tp, tchi) = _both(graph, est, **kw)
    with jax.enable_x64(True):
        jp64, _ = jpg.optimize_pose_graph(graph, est, **kw)
    noise_xy, noise_th = _pose_diffs(jp, jp64)
    d_xy, d_th = _pose_diffs(tp, jp)
    assert d_xy <= noise_xy and d_th <= max(noise_th, TH_TOL), (d_xy, d_th, noise_xy, noise_th)
    # the linearization at the initial poses is not chaotic
    np.testing.assert_allclose(tchi[0], jchi[0], rtol=1e-6)
    # the reference test's own outcome holds for the port too
    if case == "yaw_only_closure":
        gap = lambda p: np.linalg.norm(p[-1, :2] - p[0, :2])  # noqa: E731
        assert gap(tp) < gap(est) / 3, (gap(est), gap(tp))
        assert tchi[-1] < tchi[0]
    elif case == "outlier_huber":
        plain, _ = tpg.optimize_pose_graph(graph, est, iterations=30, cg_iters=300, device="cpu")
        ate = lambda p: tb.absolute_trajectory_error(p, gt)["ate_rmse"]  # noqa: E731
        assert ate(tp) < ate(plain) / 2, (ate(plain), ate(tp))

    if case == "outlier_plain":
        return  # chaotic from CG's fifth step on: 1.8 cm apart after five
    # before CG runs past convergence: one iteration of 50 steps, tightly
    short = dict(kw, iterations=1, cg_iters=50)
    (jp, jchi), (tp, tchi) = _both(graph, est, **short)
    d_xy, d_th = _pose_diffs(tp, jp)
    assert d_xy <= XY_TOL and d_th <= TH_TOL, (d_xy, d_th)
    np.testing.assert_allclose(tchi, jchi, rtol=CHI2_RTOL)


def test_cg_freezes_after_exact_convergence():
    """A 2-pose graph whose CG residual reaches exactly 0 after one step:
    the next step's alpha is 0/0, which the reference never computes (its
    while_loop stops) and the port computes but must not take."""
    graph = tpg.PoseGraph(2, [0], [1], [[0.5, 0.25, 0.0]], [np.eye(3) * 64.0])
    init = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    jp, jchi = jpg.optimize_pose_graph(graph, init, iterations=3, cg_iters=10)
    tp, tchi = tpg.optimize_pose_graph(graph, init, iterations=3, cg_iters=10, device="cpu")
    assert np.isfinite(tp).all() and np.isfinite(tchi).all()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tchi, jchi)
    np.testing.assert_array_equal(tp[1], [0.5, 0.25, 0.0])
    assert tchi[0] == 20.0 and tchi[1] == 0.0


def test_edge_sums_keep_the_references_scatter_order():
    """Each pose's sum is its i ends then its j ends, in edge order, added
    one after another: the bits of two sequential scatter-adds."""
    rng = np.random.default_rng(3)
    n, e = 12, 40
    ei, ej = rng.integers(0, n, e), rng.integers(0, n, e)
    at_i = torch.from_numpy(rng.normal(size=(e, 3)).astype(np.float32) * 1e3)
    at_j = torch.from_numpy(rng.normal(size=(e, 3)).astype(np.float32))
    want = torch.zeros((n, 3))
    for k in range(e):
        want[ei[k]] += at_i[k]
    for k in range(e):
        want[ej[k]] += at_j[k]
    got = tpg._EdgeSums(ei, ej, n, "cpu")(at_i, at_j)
    assert torch.equal(got, want)


def test_float64_solve_and_argument_checks():
    gt, est, graph, kw = _graph("loop_closure_fixes_drift")
    p64, chi64 = tpg.optimize_pose_graph(graph, est, device="cpu", dtype=torch.float64, **kw)
    p32, _ = tpg.optimize_pose_graph(graph, est, device="cpu", **kw)
    assert p64.dtype == np.float64 and chi64.dtype == np.float64
    assert _pose_diffs(p64, p32)[0] < 1e-3
    # a mesh of one rank is the one-device solve; a wider one than the world raises
    p_mesh, _ = tpg.optimize_pose_graph(graph, est, mesh=make_mesh(1, device="cpu"), **kw)
    np.testing.assert_array_equal(p_mesh, p32)
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="robust_kernel"):
        tpg.optimize_pose_graph(graph, est, robust_delta=1.0, robust_kernel="cauchy",
                                device="cpu")


def test_optimize_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    gt, est, graph, _ = _graph("odometry_only")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.optimize_pose_graph(graph, est)

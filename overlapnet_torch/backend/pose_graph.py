"""SE(2) pose-graph optimization with Gauss-Newton, vectorized in PyTorch.

Port of the JAX package's ``backend/pose_graph.py`` (no reference
counterpart: the reference stops at detection). Poses are (N, 3)
[x, y, theta]; edges are relative-pose measurements with 3x3 information
matrices. Each Gauss-Newton iteration computes the residuals and Jacobians
of all edges at once, sums the per-edge blocks onto the poses, and solves
the normal equations with conjugate gradient through a matrix-free Hv
product: no dense (3N)^2 matrix, O(edges) memory. Pose 0 is anchored (gauge
fix).

Three choices keep the card's answer that of the reference, steady, and
the CPU's:

- The block sums onto the poses go through an ``_EdgeSums`` table built once
  per graph on the host: each pose's incident edge ends in the order of the
  reference's two sequential scatter-adds (every ``i`` end, then every ``j``
  end, each in edge order), added one after another. No atomics, so two
  calls on the card give equal bits.
- Every float32 value is formed the same way on every device: elementwise
  IEEE operations, sums of three or of a pose's edge ends in a fixed
  sequential order, sin / cos / atan2 / sqrt taken in float64 and rounded
  once (the CPU's float32 ones are not correctly rounded and CUDA's differ
  from them), dot products accumulated in float64 and rounded once. In
  float32, 200 CG steps on a loop graph amplify an ulp of difference to
  centimetres (float32 against float64 of the same solve: 3 cm at 4,541
  poses), so the card reproduces the CPU's rounding instead of its own.
- CG runs exactly ``cg_iters`` steps and freezes x, r, p and gamma with
  ``torch.where`` from the first step whose residual passed the tolerance
  (the reference's ``while_loop`` stops there): the same answer with no
  host sync in the solve.

The reference solves in float32 (its ``jax_enable_x64`` is never turned on);
``dtype`` stands in for that switch and defaults to float32.

Loop edges come from the LCD engine: OverlapNet yields a relative yaw but no
translation, so closure edges constrain heading strongly and translation
weakly (information matrix reflects that), which is enough to pull drifted
trajectories back onto the loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from overlapnet_torch.core.device import resolve_device

DAMPING = 1e-6
CG_TOL = 1e-10


def _tensor(x, dtype=torch.float32) -> torch.Tensor:
    """A tensor as given, or an array-like as a ``dtype`` CPU tensor (the
    JAX helpers compute numpy input in float32)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), dtype=dtype)


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` in float64, rounded once to ``x``'s dtype: the same bits on
    every device."""
    return fn(x.double()).to(x.dtype)


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3 in a fixed order."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum(x * y), accumulated in float64 and rounded once."""
    return torch.sum(x * y, dtype=torch.float64).to(x.dtype)


def wrap_angle(theta):
    """Wrap to (-pi, pi]."""
    return _rounded(lambda t: torch.atan2(torch.sin(t), torch.cos(t)), _tensor(theta))


def relative_pose(xi, xj) -> torch.Tensor:
    """t2v(inv(T_i) @ T_j) for SE(2) poses [x, y, theta] on the last axis:
    (3,) or (E, 3) each."""
    xi, xj = _tensor(xi), _tensor(xj)
    ci, si = _rounded(torch.cos, xi[..., 2]), _rounded(torch.sin, xi[..., 2])
    dx, dy = xj[..., 0] - xi[..., 0], xj[..., 1] - xi[..., 1]
    return torch.stack(
        [ci * dx + si * dy, -si * dx + ci * dy, wrap_angle(xj[..., 2] - xi[..., 2])], dim=-1
    )


@dataclass
class PoseGraph:
    """Edges (i, j) with measurements z_ij = t2v(inv(T_i) T_j) and 3x3
    information matrices."""

    n_poses: int
    edges_i: np.ndarray  # (E,)
    edges_j: np.ndarray  # (E,)
    measurements: np.ndarray  # (E, 3)
    informations: np.ndarray  # (E, 3, 3)

    def __post_init__(self):
        self.edges_i = np.asarray(self.edges_i, np.int32)
        self.edges_j = np.asarray(self.edges_j, np.int32)
        self.measurements = np.asarray(self.measurements, np.float64)
        self.informations = np.asarray(self.informations, np.float64)

    @property
    def n_edges(self) -> int:
        return len(self.edges_i)

    def merged(self, other: "PoseGraph") -> "PoseGraph":
        if self.n_poses != other.n_poses:
            raise ValueError(f"graphs over {self.n_poses} and {other.n_poses} poses")
        return PoseGraph(
            self.n_poses,
            np.concatenate([self.edges_i, other.edges_i]),
            np.concatenate([self.edges_j, other.edges_j]),
            np.concatenate([self.measurements, other.measurements]),
            np.concatenate([self.informations, other.informations]),
        )


def poses_se3_to_se2(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) SE(3) -> (N, 3) [x, y, yaw] (planar projection)."""
    yaw = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
    return np.column_stack([poses[:, 0, 3], poses[:, 1, 3], yaw])


def odometry_edges(
    poses_se2: np.ndarray, information: np.ndarray | None = None
) -> PoseGraph:
    """Consecutive-frame edges from an (odometry) trajectory; the
    measurements are computed in float32, as the reference computes them."""
    n = len(poses_se2)
    i = np.arange(n - 1)
    j = i + 1
    poses = _tensor(poses_se2)
    z = relative_pose(poses[:-1], poses[1:]).numpy()
    if information is None:
        information = np.diag([100.0, 100.0, 1000.0])
    infos = np.tile(information, (n - 1, 1, 1))
    return PoseGraph(n, i, j, z, infos)


def closures_to_edges(
    closures: Sequence,
    n_poses: int,
    yaw_information: float = 500.0,
    xy_information: float = 1e-2,
    yaw_overlap_ramp: tuple[float, float] = (0.3, 0.7),
) -> PoseGraph:
    """Loop-closure edges from LCD results (lcd.online.LoopClosure).

    OverlapNet gives relative yaw only (no translation), so measurements are
    [0, 0, yaw] with high heading / near-zero translation information — a
    'same place, known heading change' constraint.

    Yaw information per edge = yaw_information x confidence x overlap ramp:
    the confidence is the detector's antipodal-aware yaw confidence (softmax
    peak mass x flip margin, ops.correlation.yaw_confidence), so sharp but
    180-degree-ambiguous peaks carry almost no heading weight; the overlap
    ramp rises linearly over ``yaw_overlap_ramp`` (floor 0.2 at the low end)
    because yaw accuracy degrades with overlap even when supervised there.
    """
    i = np.array([c.match for c in closures], np.int32)
    j = np.array([c.frame for c in closures], np.int32)
    z = np.zeros((len(i), 3))
    z[:, 2] = [np.radians(c.yaw_deg) for c in closures]
    confs = np.array([getattr(c, "confidence", 1.0) for c in closures])
    lo, hi = yaw_overlap_ramp
    ovs = np.array([getattr(c, "overlap", hi) for c in closures])
    ramp = np.clip((ovs - lo) / max(hi - lo, 1e-9), 0.2, 1.0)
    infos = np.tile(
        np.diag([xy_information, xy_information, 0.0]), (len(i), 1, 1)
    )
    infos[:, 2, 2] = yaw_information * confs * ramp
    return PoseGraph(n_poses, i, j, z, infos)


def relative_pose_edges(
    pairs: np.ndarray,
    measurements: np.ndarray,
    n_poses: int,
    information: np.ndarray | None = None,
) -> PoseGraph:
    """Closure edges with full relative-pose measurements (E, 3) — the
    refined-registration case (e.g. detector closure + ICP alignment)."""
    pairs = np.asarray(pairs, np.int32)
    if information is None:
        information = np.diag([50.0, 50.0, 500.0])
    infos = np.tile(information, (len(pairs), 1, 1))
    return PoseGraph(n_poses, pairs[:, 0], pairs[:, 1], measurements, infos)


class _EdgeSums:
    """Fixed-order sums of per-edge (E, 3) blocks onto the (N, 3) poses.

    ``table[p]`` lists the slots of pose p's incident edge ends, padded with
    the index of a zero row: slot e < E is edge e's ``i`` end, slot E + e its
    ``j`` end. A stable sort keeps each pose's slots in the order of the
    reference's ``.at[ei].add(..).at[ej].add(..)``, and the slots are added
    in that order. Memory is N x (largest degree) indices; a sum is one add
    per slot column."""

    def __init__(self, ei: np.ndarray, ej: np.ndarray, n_poses: int, device):
        ends = np.concatenate([ei, ej]).astype(np.int64)
        order = np.argsort(ends, kind="stable")
        counts = np.bincount(ends, minlength=n_poses)
        starts = np.cumsum(counts) - counts
        rank = np.arange(len(ends)) - np.repeat(starts, counts)
        table = np.full((n_poses, max(1, int(counts.max(initial=0)))), len(ends), np.int64)
        table[ends[order], rank] = order
        self.table = torch.from_numpy(table).to(device)

    def __call__(self, at_i: torch.Tensor, at_j: torch.Tensor) -> torch.Tensor:
        ends = torch.cat([at_i, at_j, at_i.new_zeros((1, 3))])[self.table]
        out = ends[:, 0]
        for k in range(1, ends.shape[1]):
            out = out + ends[:, k]
        return out


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('eab,eb->ea'): each edge's 3x3 block times its 3-vector."""
    return _sum3(m * v[:, None, :])


def _apply_t(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('eba,eb->ea'): each edge's transposed block times its vector."""
    return _sum3((m * v[:, :, None]).transpose(1, 2))


def _edge_residual_jac(xi: torch.Tensor, xj: torch.Tensor, z: torch.Tensor):
    """Residual r = t2v(inv(T_ij_meas) * (inv(T_i) T_j)) ~ rel - z (angle
    wrapped), with analytic Jacobians wrt xi and xj, for all (E,) edges at
    once. Returns (r (E, 3), Ji (E, 3, 3), Jj (E, 3, 3))."""
    ci, si = _rounded(torch.cos, xi[:, 2]), _rounded(torch.sin, xi[:, 2])
    dx, dy = xj[:, 0] - xi[:, 0], xj[:, 1] - xi[:, 1]
    r = torch.stack(
        [ci * dx + si * dy - z[:, 0], -si * dx + ci * dy - z[:, 1],
         wrap_angle(xj[:, 2] - xi[:, 2] - z[:, 2])], dim=-1)
    zero, one = torch.zeros_like(ci), torch.ones_like(ci)
    # d(rel)/d(xi), d(rel)/d(xj)
    ji = torch.stack([
        torch.stack([-ci, -si, -si * dx + ci * dy], dim=-1),
        torch.stack([si, -ci, -ci * dx - si * dy], dim=-1),
        torch.stack([zero, zero, -one], dim=-1),
    ], dim=1)
    jj = torch.stack([
        torch.stack([ci, si, zero], dim=-1),
        torch.stack([-si, ci, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=1)
    return r, ji, jj


def _anneal(iterations: int, robust_delta: float, robust_anneal_start: float) -> list[float]:
    """Each iteration's robust band, computed in float32 as the reference
    computes it: start + (delta - start) * (k / span)."""
    start = max(robust_anneal_start, robust_delta)
    span = max(iterations - 1, 1)
    frac = np.arange(iterations, dtype=np.float32) / np.float32(span)
    return [float(d) for d in np.float32(start) + np.float32(robust_delta - start) * frac]


def _gauss_newton(
    poses0: torch.Tensor,  # (N, 3)
    ei: torch.Tensor,
    ej: torch.Tensor,
    z: torch.Tensor,
    omega: torch.Tensor,
    edge_sums: _EdgeSums,
    *,
    iterations: int = 10,
    cg_iters: int = 50,
    damping: float = DAMPING,
    robust_delta: float = 0.0,
    robust_kernel: str = "huber",
    robust_anneal_start: float = 0.0,
):
    """All-edges Gauss-Newton with matrix-free CG on the normal equations,
    on the device of its tensors; reads nothing back to the host.

    ``robust_delta`` > 0 enables a robust kernel via IRLS on the Mahalanobis
    residual ||r||_Omega: 'huber' scales each edge's information by
    min(1, delta/||r||) (bounded influence), 'tukey' by (1 - (||r||/delta)^2)^2
    inside the band and 0 outside (full outlier rejection) — so wrong
    loop-closure edges are down-weighted instead of dragging the trajectory.
    ``robust_anneal_start`` > delta anneals the band linearly from that start
    value down to delta over the iterations (graduated non-convexity): early
    iterations tolerate the large residuals honest edges have under drift,
    late iterations reject true outliers. Returns (poses (N, 3), chi2 (iterations,))."""
    dtype, device = poses0.dtype, poses0.device
    # pose 0's rows and columns of the system are replaced by the identity
    gauge = torch.zeros((poses0.shape[0], 1), dtype=torch.bool, device=device)
    gauge[0] = True
    tol2 = float(np.float32(CG_TOL) * np.float32(CG_TOL))

    def linearize(poses, delta):
        r, ji, jj = _edge_residual_jac(poses[ei], poses[ej], z)
        s = _sum3(r * _apply(omega, r))
        if robust_delta > 0.0:
            rho = _rounded(torch.sqrt, s + 1e-12)
            if robust_kernel == "tukey":
                u = rho / delta
                w = torch.where(u < 1.0, torch.square(1.0 - torch.square(u)), 0.0)
            else:  # huber
                w = torch.clamp(delta / rho, max=1.0)
            omega_w = omega * w[:, None, None]
        else:
            omega_w = omega
        omr = _apply(omega_w, r)
        b = edge_sums(_apply_t(ji, omr), _apply_t(jj, omr))
        return ji, jj, b, torch.sum(s, dtype=torch.float64).to(dtype), omega_w

    def hv(ji, jj, omega_w, v):
        """H @ v with H = sum_e J_e^T O J_e (+ damping), gauge-fixed."""
        v = v.masked_fill(gauge, 0.0)
        ojv = _apply(omega_w, _apply(ji, v[ei]) + _apply(jj, v[ej]))
        out = edge_sums(_apply_t(ji, ojv), _apply_t(jj, ojv)) + damping * v
        return out.masked_fill(gauge, 0.0)

    def cg(matvec, rhs):
        """jax.scipy.sparse.linalg.cg from x0 = 0, no preconditioner: steps
        while gamma > max(tol^2 (b.b), 0), at most ``cg_iters`` of them."""
        atol2 = _dot(rhs, rhs) * tol2
        x, r, p = torch.zeros_like(rhs), rhs, rhs
        gamma = _dot(r, r)
        for _ in range(cg_iters):
            live = gamma > atol2
            ap = matvec(p)
            alpha = gamma / _dot(p, ap)
            x_new = x + alpha * p
            r_new = r - alpha * ap
            gamma_new = _dot(r_new, r_new)
            p_new = r_new + (gamma_new / gamma) * p
            # a frozen step's 0/0 stays in the branch not taken
            x = torch.where(live, x_new, x)
            r = torch.where(live, r_new, r)
            p = torch.where(live, p_new, p)
            gamma = torch.where(live, gamma_new, gamma)
        return x

    poses, chi2s = poses0, []
    for delta in _anneal(iterations, robust_delta, robust_anneal_start):
        delta_t = torch.full((), delta, dtype=dtype, device=device)
        ji, jj, b, chi2, omega_w = linearize(poses, delta_t)
        rhs = (-b).masked_fill(gauge, 0.0)
        dx = cg(lambda v: hv(ji, jj, omega_w, v), rhs)
        new = poses + dx
        poses = torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=1)
        chi2s.append(chi2)
    return poses, torch.stack(chi2s) if chi2s else poses.new_zeros(0)


def optimize_pose_graph(
    graph: PoseGraph,
    initial_poses: np.ndarray,
    iterations: int = 10,
    cg_iters: int = 50,
    robust_delta: float = 0.0,
    robust_kernel: str = "huber",
    robust_anneal_start: float = 0.0,
    mesh=None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Optimize; returns (poses (N, 3), chi2 history (iterations,)) as numpy.

    ``robust_delta`` > 0 turns on a robust kernel (IRLS): 'huber' (bounded
    influence) or 'tukey' (rejects outliers outside the delta band). A good
    delta for loop-closure graphs is ~1-3 (units of Mahalanobis residual);
    pair tukey with ``robust_anneal_start`` (e.g. 100x delta) so honest
    closures survive the early high-drift iterations.

    Runs on ``device`` ("cuda" by default; raises if no card is visible) in
    ``dtype``. Measurements and information matrices are rounded to float32
    first, as the reference rounds them whatever its precision.
    """
    if mesh is not None:
        raise NotImplementedError(
            "optimize_pose_graph(mesh=...): an edge set sharded over several "
            "devices comes with the port's multi-GPU slice (ROADMAP Queue 1 item 7)"
        )
    if robust_kernel not in ("huber", "tukey"):
        raise ValueError(f"robust_kernel {robust_kernel!r} (huber|tukey)")
    device = resolve_device(device)

    def up(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    ei, ej = graph.edges_i.astype(np.int64), graph.edges_j.astype(np.int64)
    poses, chi2s = _gauss_newton(
        up(np.asarray(initial_poses, np.float64), dtype),
        up(ei, torch.int64), up(ej, torch.int64),
        up(graph.measurements.astype(np.float32), dtype),
        up(graph.informations.astype(np.float32), dtype),
        _EdgeSums(ei, ej, graph.n_poses, device),
        iterations=iterations,
        cg_iters=cg_iters,
        robust_delta=robust_delta,
        robust_kernel=robust_kernel,
        robust_anneal_start=robust_anneal_start,
    )
    return poses.cpu().numpy(), chi2s.cpu().numpy()

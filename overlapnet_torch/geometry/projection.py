"""Spherical (range-image) projection in PyTorch, batched over scans.

The JAX package's ``geometry/projection.py`` (after the reference's numpy
geometry core, src/utils/utils.py:59-175), with the same semantics and the
same expression sequence:

- ``range_projection``: the nearest point wins each pixel and depth ties go
  to the lowest point index, as the reference's descending-sort overwrite
  order has it. The z-buffer is two ``scatter_reduce_(..., "amin")`` passes
  over one flat (K, H*W + 1) buffer: pass 1 finds the nearest depth in each
  pixel, pass 2 the lowest point index among the points at exactly that
  depth. Both are order-independent, so the result does not depend on the
  order in which the device applies the scatter. The extra last column of
  each scan takes the invalid points (the ``mode="drop"`` of the JAX
  scatter, which torch lacks).
- ``normal_map``: shifted-image cross products over the whole image.

Every function takes (P, 4) or (K, P, 4) float32 tensors (x, y, z,
intensity) on the device they come on and batches over K natively. Rows of
zeros are padding (depth 0: dropped, the reference's filter at
utils.py:76). Nothing here is a hand kernel: the reference is plain XLA.

The card and the CPU give the same bits. Where float32 results differ
between devices (CUDA's fused multiply-adds and reductions, PyTorch's CPU
``sqrt``, the two math libraries' ``atan2`` and ``asin``), the value is
computed in float64 and rounded once, in the order the JAX package's XLA
rounds it on the CPU where that order is known (the depth, the norms and the
cross product of the normals: the same bits as the JAX package). The
remaining steps are single float32 operations, which round alike
everywhere; a division by a constant goes through a tensor on the points'
device, because CUDA's PyTorch divides by a Python scalar as a product with
its reciprocal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PROJ_H = 64
PROJ_W = 900
FOV_UP_DEG = 3.0
FOV_DOWN_DEG = -25.0
MAX_RANGE = 50.0

# KITTI HDL-64 scans have ~120-130k points; a fixed capacity keeps a batch of
# scans one tensor. Points beyond capacity are dropped (never on KITTI).
DEFAULT_MAX_POINTS = 140_000


def pad_points(points: np.ndarray, max_points: int = DEFAULT_MAX_POINTS) -> np.ndarray:
    """Pad/truncate an (N, C) point array to (max_points, C) with zero rows.

    Zero rows have depth 0 and are dropped by ``range_projection`` exactly like
    the reference drops [0, 0, 0] points (utils.py:76).
    """
    n, c = points.shape
    out = np.zeros((max_points, c), dtype=points.dtype)
    out[: min(n, max_points)] = points[:max_points]
    return out


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    # filled on the device: torch.tensor(x, device=...) would be a copy from
    # the host, which waits for the device
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _depth(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """|(x, y, z)| in float32 with the bits of the JAX package's
    ``jnp.linalg.norm`` on the CPU: XLA sums the squares as the fused
    multiply-adds fma(z, z, fma(y, y, x*x)), each rounded to float32, and
    takes a correctly rounded square root. Emulated in float64 (the products
    of float32 values are exact there), which gives the same bits on the CPU
    and on the card; PyTorch's float32 ``sqrt`` on the CPU is not correctly
    rounded, so the root is taken in float64 too."""
    x, y, z = x.double(), y.double(), z.double()
    s = (x * x).float().double()
    s = (y * y + s).float().double()
    s = (z * z + s).float().double()
    return torch.sqrt(s).float()


def pixels_of(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    *,
    proj_h: int = PROJ_H,
    proj_w: int = PROJ_W,
    fov_up: float = FOV_UP_DEG,
    fov_down: float = FOV_DOWN_DEG,
    max_range: float = MAX_RANGE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``project_pixels`` on the coordinates given apart (any equal shapes,
    float32): (pix int64, depth, valid). The JAX package's expression
    sequence, with atan2 and asin rounded from float64."""
    fov_up_rad = fov_up / 180.0 * math.pi
    fov_down_rad = fov_down / 180.0 * math.pi
    fov = abs(fov_down_rad) + abs(fov_up_rad)

    depth = _depth(x, y, z)
    valid = (depth > 0) & (depth < max_range)

    safe_depth = torch.where(depth > 0, depth, _const(1.0, depth))
    # atan2 and asin in float64, rounded to float32: float32 versions differ
    # between the CPU's vector library and CUDA by an ulp or two, which moves
    # points at pixel boundaries (several a 130k-point scan); rounded from
    # float64, every device gives the same bits
    yaw = -torch.atan2(y.double(), x.double()).float()
    pitch = torch.asin(torch.clamp(z / safe_depth, -1.0, 1.0).double()).float()

    proj_x = torch.floor(0.5 * (yaw / _const(math.pi, yaw) + 1.0) * proj_w)
    proj_x = torch.clamp(proj_x, 0, proj_w - 1).to(torch.int64)
    proj_y = torch.floor((1.0 - (pitch + abs(fov_down_rad)) / _const(fov, pitch)) * proj_h)
    proj_y = torch.clamp(proj_y, 0, proj_h - 1).to(torch.int64)

    pix = torch.where(valid, proj_y * proj_w + proj_x, proj_h * proj_w)
    return pix, depth, valid


def project_pixels(points: torch.Tensor, **kw) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spherical pixel mapping only: (..., P, 4) points -> (pix, depth,
    valid), each (..., P).

    The coordinate core of ``range_projection`` (the JAX package's
    ``project_pixels``): pix is the flat
    ``v * W + u`` pixel id (int64), with invalid points routed to the
    overflow bucket ``H * W``. Keywords: proj_h, proj_w, fov_up, fov_down,
    max_range.
    """
    xyz = points[..., :3].float()
    return pixels_of(xyz[..., 0], xyz[..., 1], xyz[..., 2], **kw)


def min_depth_image(pix: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
                    n_pix: int) -> torch.Tensor:
    """Pass 1 of the z-buffer: the nearest valid depth of each pixel, inf
    where none; (K, P) -> (K, n_pix + 1), the last column the overflow
    bucket of the invalid points."""
    buf = torch.full((pix.shape[0], n_pix + 1), math.inf, dtype=torch.float32,
                     device=depth.device)
    return buf.scatter_reduce_(1, pix, torch.where(valid, depth, _const(math.inf, depth)),
                               "amin", include_self=True)


def range_projection(
    points: torch.Tensor,
    *,
    proj_h: int = PROJ_H,
    proj_w: int = PROJ_W,
    fov_up: float = FOV_UP_DEG,
    fov_down: float = FOV_DOWN_DEG,
    max_range: float = MAX_RANGE,
):
    """Project point clouds into spherical range images.

    Args:
      points: (P, 4) or (K, P, 4) float32: x, y, z, intensity (or
        homogeneous 1s). Zero rows are treated as padding.

    Returns (each with the leading K when the input had it):
      proj_range: (H, W) float32 depth, -1 where empty.
      proj_vertex: (H, W, 4) float32 (x, y, z, 1), -1 where empty.
      proj_intensity: (H, W) float32 4th column of the winning point, -1 empty.
      proj_idx: (H, W) int32 index of the winning point, -1 where empty.

    Pixel mapping as reference utils.range_projection (utils.py:59-134):
    u = floor(0.5*(-atan2(y,x)/pi + 1) * W), v = floor((1 - (pitch +
    |fov_down|)/fov) * H), clamped; valid iff 0 < depth < max_range.
    """
    single = points.dim() == 2
    pts = points[None] if single else points
    k, p = pts.shape[0], pts.shape[1]
    xyz = pts[..., :3].float()
    intensity = pts[..., 3].float()
    pix, depth, valid = pixels_of(
        xyz[..., 0], xyz[..., 1], xyz[..., 2], proj_h=proj_h, proj_w=proj_w,
        fov_up=fov_up, fov_down=fov_down, max_range=max_range,
    )
    n_pix = proj_h * proj_w

    # pass 1: nearest depth per pixel; pass 2: lowest original index among
    # the points at exactly that depth (the reference's tie-break)
    win_depth = min_depth_image(pix, depth, valid, n_pix)
    is_winner = valid & (depth == win_depth.gather(1, pix))
    idx = torch.arange(p, dtype=torch.int64, device=pts.device).expand(k, p)
    win_idx = torch.full((k, n_pix + 1), p, dtype=torch.int64, device=pts.device)
    win_idx.scatter_reduce_(1, pix, torch.where(is_winner, idx, p), "amin", include_self=True)
    win_idx, win_depth = win_idx[:, :n_pix], win_depth[:, :n_pix]

    hit = win_idx < p
    safe_idx = torch.where(hit, win_idx, 0)
    neg = _const(-1.0, depth)
    proj_range = torch.where(hit, win_depth, neg).reshape(k, proj_h, proj_w)
    vertex_rows = torch.cat(
        [xyz.gather(1, safe_idx[..., None].expand(k, n_pix, 3)),
         torch.ones((k, n_pix, 1), dtype=torch.float32, device=pts.device)], dim=2)
    proj_vertex = torch.where(hit[..., None], vertex_rows, neg).reshape(k, proj_h, proj_w, 4)
    proj_intensity = torch.where(hit, intensity.gather(1, safe_idx), neg).reshape(
        k, proj_h, proj_w)
    proj_idx = torch.where(hit, win_idx, -1).to(torch.int32).reshape(k, proj_h, proj_w)
    out = (proj_range, proj_vertex, proj_intensity, proj_idx)
    return tuple(t[0] for t in out) if single else out


def _fused_cross_term(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """a*b - c*d in float32 as XLA's CPU backend fuses it into
    fma(a, b, -(c*d)): c*d rounded, then one rounding of the rest; emulated
    in float64 (a*b is exact there), so the card gives the CPU's bits."""
    return (a.double() * b.double() - (c * d).double()).float()


def normal_map(proj_range: torch.Tensor, proj_vertex: torch.Tensor) -> torch.Tensor:
    """Per-pixel surface normals from a range projection: (..., H, W) and
    (..., H, W, 4) -> (..., H, W, 3).

    The JAX package's ``normal_map`` (reference utils.gen_normal_map,
    utils.py:137-175): normal = normalize(cross(v_unit, u_unit)) where u is
    the width-wrapped right neighbour and v the downward neighbour; -1 where
    the pixel, either neighbour, or the cross product's norm is invalid; the
    last row is always -1 (the reference loops y over range(H-1)).

    The norms and the cross product round as the JAX package's do on the
    CPU (``_depth``, ``_fused_cross_term``), and the rest is elementwise
    float32 arithmetic, which rounds alike on every device: the card gives
    the CPU's bits. A normal of nearly parallel neighbour steps amplifies
    any other rounding by 1 / sin of their angle.
    """
    p = proj_vertex[..., :3]
    depth = proj_range
    one = _const(1.0, depth)

    u = torch.roll(p, -1, dims=-2)  # right neighbour, wrapped in width
    u_depth = torch.roll(depth, -1, dims=-1)
    v = torch.roll(p, -1, dims=-3)  # down neighbour (row y+1)
    v_depth = torch.roll(depth, -1, dims=-2)

    def unit(d):
        n = _depth(d[..., 0], d[..., 1], d[..., 2])[..., None]
        return d / torch.where(n > 0, n, one), n

    u_unit, _ = unit(u - p)
    v_unit, _ = unit(v - p)
    a0, a1, a2 = v_unit.unbind(-1)
    b0, b1, b2 = u_unit.unbind(-1)
    w = torch.stack([_fused_cross_term(a1, b2, a2, b1), _fused_cross_term(a2, b0, a0, b2),
                     _fused_cross_term(a0, b1, a1, b0)], dim=-1)
    normal, w_norm = unit(w)

    h = proj_range.shape[-2]
    row_ok = (torch.arange(h, device=depth.device) < h - 1)[:, None]
    valid = (depth > 0) & (u_depth > 0) & (v_depth > 0) & (w_norm[..., 0] > 0) & row_ok
    return torch.where(valid[..., None], normal, _const(-1.0, normal)).float()


def semantic_projection(
    probs: torch.Tensor,
    proj_idx: torch.Tensor,
    num_classes: int = 20,
) -> torch.Tensor:
    """Per-point class probabilities projected into the image: (N,
    num_classes) and (H, W) -> (H, W, num_classes) float32.

    Reference gen_semantic_data (gen_semantic_data.py:42-46): pixels take the
    probability row of their winning point, -1 where empty. ``proj_idx`` is
    ``range_projection``'s (computed with max_range=inf in the reference's
    semantic path).
    """
    gathered = probs[torch.clamp(proj_idx.long(), 0, probs.shape[0] - 1)]
    return torch.where((proj_idx >= 0)[..., None], gathered,
                       torch.full_like(gathered, -1.0)).float()


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to (..., P, 4)-homogeneous points (T
    (4, 4), or one (..., 4, 4) per leading index).

    Zero rows (the padding convention of ``pad_points``) stay zero so they
    remain invalid after the transform; the 4th output column is
    homogeneous-1 for real points. Computed in the points' float type as
    explicit multiply-adds, x*T[r,0] + y*T[r,1] + z*T[r,2] + T[r,3], so that
    no global TF32 setting reaches it (a TF32 product moves a point at 50 m
    by centimetres).
    """
    xyz = points[..., :3]
    valid = (xyz != 0).any(dim=-1)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    T = T.to(xyz.dtype)
    zero = torch.zeros((), dtype=xyz.dtype, device=xyz.device)
    rows = []
    for r in range(4):
        t = T[..., r, :]
        if t.dim() > 1:  # (..., 4): one transform per leading index
            t = t[..., None, :]
        rows.append(torch.where(valid, x * t[..., 0] + y * t[..., 1] + z * t[..., 2] + t[..., 3],
                                zero))
    return torch.stack(rows, dim=-1)

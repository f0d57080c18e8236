"""Seeded inputs: weights, range images, routes, pair labels, point clouds.

Everything here is made from ``--seed`` alone, on the device and in a few
large calls where it is large. The program receives only what this module
makes; the reference is handed the same tensors, or makes them again from
the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import param_shapes

SEED_MOD = 2**63 - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A torch generator on ``device`` for ``seed`` and a numbered stream
    (seeds may exceed 32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)
    return g


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


# Scale of the overlap dense layer's initial weights against glorot's. At
# glorot's scale the untrained overlap logit is 0.14 +- 0.02 over pairs of
# these images, so every overlap reads 0.53 and a rounding error in the
# heads moves it by less than float32 resolves; ten times that spreads the
# candidates' overlaps over some hundredths (logit 1.4 +- 0.2).
DENSE_GAIN = 10.0


def init_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded float32 weights under the program's state_dict names: leg
    convs normal with variance 1 / fan_in (lecun), head convs normal with
    variance 2 / (fan_in + fan_out) (glorot), the overlap dense the same
    times DENSE_GAIN, biases a small normal (0.01). One normal draw on the
    device for all of them."""
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, 1), device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = flat[at : at + n].view(shape)
        at += n
        if name.endswith("bias"):
            out[name] = x * 0.01
            continue
        fan_in = math.prod(shape[1:])
        fan_out = shape[0] * math.prod(shape[2:])
        if name.startswith("legs."):
            std = math.sqrt(1.0 / fan_in)
        else:
            std = math.sqrt(2.0 / (fan_in + fan_out))
            if name.endswith("overlap_output.weight"):
                std *= DENSE_GAIN
        out[name] = x * std
    return {k: v.contiguous() for k, v in out.items()}


def _smooth(n: int, c: int, h: int, w: int, g: torch.Generator, device,
            coarse=(8, 60)) -> torch.Tensor:
    """(n, c, h, w) smooth noise in [-1, 1]: coarse normal noise upsampled
    bilinearly, plus a little fine noise."""
    base = torch.randn((n, c) + tuple(coarse), generator=g, device=device)
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    fine = torch.randn((n, c, h, w), generator=g, device=device)
    return torch.tanh(0.8 * up + 0.1 * fine)


def range_images(n: int, cfg_channels: dict, height: int, width: int, g: torch.Generator,
                 device) -> dict[str, torch.Tensor]:
    """Range-image channels of ``n`` scans, in the layout the program's
    loader reads (per kind, (n, H, W) or (n, H, W, k)): depth in metres
    (2-80 m, -1 for about 8% of pixels with no return), unit normals (-1
    where no return), 20 class probabilities (a softmax) and intensity in
    [0, 1] when the configuration asks for them."""
    rows = torch.linspace(0.0, 1.0, height, device=device)[None, :, None]
    field = _smooth(n, 6, height, width, g, device)
    # upper rows see facades 5-40 m away, lower rows the ground closing in
    depth = (5.0 + 35.0 * (0.5 + 0.5 * field[:, 0])) * (1.0 - 0.8 * rows) + 2.0
    depth = depth + 0.5 * torch.rand((n, height, width), generator=g, device=device)
    hole = torch.rand((n, height, width), generator=g, device=device) < 0.08
    depth = torch.where(hole, torch.full_like(depth, -1.0), depth)
    normal = torch.nn.functional.normalize(field[:, 1:4] + 0.05, dim=1).permute(0, 2, 3, 1)
    normal = torch.where(hole[..., None], torch.full_like(normal, -1.0), normal)
    out = {"depth": depth, "normal": normal.contiguous()}
    if cfg_channels.get("use_class_probabilities", False):
        logits = 3.0 * _smooth(n, 20, height, width, g, device, coarse=(4, 30))
        out["probability"] = torch.softmax(logits, dim=1).permute(0, 2, 3, 1).contiguous()
    if cfg_channels.get("use_intensity", False):
        out["intensity"] = (0.5 + 0.5 * field[:, 4]).contiguous()
    return out


CHANNEL_ORDER = (("depth", 1), ("normal", 3), ("probability", 20), ("intensity", 1))


def stack_channels(kinds: dict[str, torch.Tensor]) -> torch.Tensor:
    """(n, H, W, C) input images in the reference's channel order."""
    parts = []
    for kind, _ in CHANNEL_ORDER:
        if kind in kinds:
            x = kinds[kind]
            parts.append(x[..., None] if x.dim() == 3 else x)
    return torch.cat(parts, dim=-1)


def loop_route(n_frames: int, lap_frames: int, spacing: float, lateral: float = 0.5,
               aspect: float = 2.0, sway_rad: float = 0.0) -> np.ndarray:
    """(n, 4, 4) poses along a rectangular loop of ``lap_frames`` frames at
    ``spacing`` metres, driven lap after lap; each lap is offset sideways by
    ``lateral`` metres from the one before, as a car keeps to another part
    of the lane. The heading follows the path, swaying by up to
    ``sway_rad`` about it (so relative yaws do not sit on exact right
    angles)."""
    perimeter = lap_frames * spacing
    # rectangle sides a, b with 2 (a + b) = perimeter, a = aspect * b
    b = perimeter / (2.0 * (1.0 + aspect))
    a = aspect * b
    s = (np.arange(n_frames) % lap_frames) * spacing
    lap = np.arange(n_frames) // lap_frames
    x = np.where(s < a, s, np.where(s < a + b, a, np.where(s < 2 * a + b, 2 * a + b - s, 0.0)))
    y = np.where(s < a, 0.0, np.where(s < a + b, s - a, np.where(s < 2 * a + b, b,
                                                                   perimeter - s)))
    heading = np.where(s < a, 0.0, np.where(s < a + b, np.pi / 2,
                                            np.where(s < 2 * a + b, np.pi, -np.pi / 2)))
    off = lateral * lap
    heading = heading + sway_rad * np.sin(np.arange(n_frames) * 0.37)
    x = x + off * -np.sin(heading)
    y = y + off * np.cos(heading)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    c, si = np.cos(heading), np.sin(heading)
    poses[:, 0, 0], poses[:, 0, 1], poses[:, 1, 0], poses[:, 1, 1] = c, -si, si, c
    poses[:, 0, 3], poses[:, 1, 3] = x, y
    return poses


SENSOR_HEIGHT_M = 1.73


def street_world(poses: np.ndarray, g: torch.Generator, device) -> torch.Tensor:
    """(M, 4) world points (x, y, z, intensity) of a street along the
    route: undulating ground over the route's box and 70 m around it,
    facades on both sides of the road (7-14 m out, 4-12 m high, in 20 m
    lots of which some are empty) and poles."""
    xy = torch.as_tensor(poses[:, :2, 3], dtype=torch.float32, device=device)
    lo, hi = xy.min(0).values - 70.0, xy.max(0).values + 70.0
    gx = torch.arange(float(lo[0]), float(hi[0]), 0.35, device=device)
    gy = torch.arange(float(lo[1]), float(hi[1]), 0.35, device=device)
    X, Y = torch.meshgrid(gx, gy, indexing="ij")
    X, Y = X.reshape(-1), Y.reshape(-1)
    Z = 0.15 * torch.sin(0.05 * X) * torch.cos(0.07 * Y)
    parts = [torch.stack([X, Y, Z, torch.full_like(X, 0.1)], 1)]
    # the road's centre line, 5 samples a frame, with its left normal
    heading = torch.as_tensor(np.arctan2(poses[:, 1, 0], poses[:, 0, 0]), dtype=torch.float32,
                              device=device)
    t = torch.linspace(0, len(poses) - 1, 5 * len(poses), device=device)
    i0 = t.floor().long().clamp(max=len(poses) - 2)
    frac = (t - i0)[:, None]
    centre = xy[i0] * (1 - frac) + xy[i0 + 1] * frac
    h = heading[i0]
    normal = torch.stack([-torch.sin(h), torch.cos(h)], 1)
    lot = (torch.arange(len(t), device=device) * (len(poses) / len(t)) // 30).long()
    n_lots = int(lot.max()) + 1
    for side in (1.0, -1.0):
        dist = 7.0 + 7.0 * torch.rand(n_lots, generator=g, device=device)
        height = 4.0 + 8.0 * torch.rand(n_lots, generator=g, device=device)
        present = torch.rand(n_lots, generator=g, device=device) < 0.8
        albedo = 0.2 + 0.7 * torch.rand(n_lots, generator=g, device=device)
        keep = present[lot]
        base = centre + side * dist[lot][:, None] * normal
        zs = torch.arange(0.0, 12.0, 0.25, device=device)
        pts = base[:, None, :].expand(-1, len(zs), -1)
        z = zs[None, :].expand(len(base), -1)
        ok = keep[:, None] & (z < height[lot][:, None])
        inten = albedo[lot][:, None].expand(-1, len(zs))
        parts.append(torch.stack([pts[..., 0][ok], pts[..., 1][ok], z[ok], inten[ok]], 1))
    n_poles = 400
    at = torch.randint(0, len(t), (n_poles,), generator=g, device=device)
    side = torch.where(torch.rand(n_poles, generator=g, device=device) < 0.5, 1.0, -1.0)
    foot = centre[at] + (side * (4.0 + 2.0 * torch.rand(n_poles, generator=g, device=device))
                         )[:, None] * normal[at]
    ang = torch.linspace(0, 2 * math.pi, 12, device=device)
    zs = torch.arange(0.0, 6.0, 0.2, device=device)
    px = foot[:, 0, None, None] + 0.15 * torch.cos(ang)[None, :, None]
    py = foot[:, 1, None, None] + 0.15 * torch.sin(ang)[None, :, None]
    shape = (n_poles, len(ang), len(zs))
    parts.append(torch.stack([px.expand(shape).reshape(-1), py.expand(shape).reshape(-1),
                              zs[None, None, :].expand(shape).reshape(-1),
                              torch.full((math.prod(shape),), 0.8, device=device)], 1))
    return torch.cat(parts)


def street_scans(poses: np.ndarray, valid_points: int, max_points: int, g: torch.Generator,
                 device, reach_m: float = 70.0) -> torch.Tensor:
    """(N, max_points, 4) float32 scans in the sensor frame (mounted
    SENSOR_HEIGHT_M above the ground): ``valid_points`` world points drawn
    from within ``reach_m`` of each pose, then zero rows (padding)."""
    world = street_world(poses, g, device)
    out = torch.zeros((len(poses), max_points, 4), device=device)
    T = torch.as_tensor(poses, dtype=torch.float32, device=device)
    for i in range(len(poses)):
        d = world[:, :2] - T[i, :2, 3]
        idx = torch.nonzero((d * d).sum(1) < reach_m ** 2)[:, 0]
        pick = idx[torch.randperm(len(idx), generator=g, device=device)[:valid_points]]
        p = world[pick]
        local = (p[:, :3] - T[i, :3, 3]) @ T[i, :3, :3]
        local[:, 2] -= SENSOR_HEIGHT_M
        out[i, : len(pick), :3] = local
        out[i, : len(pick), 3] = p[:, 3]
    return out

#!/usr/bin/env python3
"""Where float32 rounding moves the port's range images (CPU only; imports
both packages, like the tests).

Prints one JSON line per measurement:

1. PyTorch's CPU float32 ``atan2``, ``asin`` and ``sqrt`` against the same
   functions taken in float64 and rounded to float32, on seeded Gaussian
   points: the share of equal values (1.0 where the float32 version is
   correctly rounded).
2. On full-size scans of the sim world (``sim/world.py`` defaults, 130,000
   points), the port's ``range_projection`` against the JAX package's: the
   pixels whose winning point differs, and the largest normal difference
   where the winners agree; and the JAX package's float32 normals against a
   float64 computation of the same formula (numpy), which shows how far an
   ulp can move a normal.

Run from the repository root: ``JAX_PLATFORMS=cpu python3 scripts/rounding_probe.py
[--scans 6] [--points 2000000]``. Numbers from this script are CPU
diagnostics, not measurements of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from overlapnet_tpu.geometry import projection as jproj  # noqa: E402
from overlapnet_torch.geometry import projection as tproj  # noqa: E402
from overlapnet_torch.sim import world  # noqa: E402


def normals_f64(r: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The normal map's formula in float64 (``normal_map``'s validity rule)."""
    p = v[..., :3].astype(np.float64)
    du, dv = np.roll(p, -1, axis=1) - p, np.roll(p, -1, axis=0) - p

    def unit(d):
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        return d / np.where(n > 0, n, 1.0), n

    (u, _), (w_v, _) = unit(du), unit(dv)
    n, w_norm = unit(np.cross(w_v, u))
    ok = ((r > 0) & (np.roll(r, -1, axis=1) > 0) & (np.roll(r, -1, axis=0) > 0)
          & (w_norm[..., 0] > 0))
    ok[-1] = False
    return np.where(ok[..., None], n, -1.0)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--points", type=int, default=2_000_000)
    args = ap.parse_args(argv)

    xyz = torch.from_numpy((np.random.default_rng(0).normal(size=(args.points, 3)) * 20)
                           .astype(np.float32))
    x, y, z = xyz.unbind(1)
    s = torch.clamp(z / xyz.norm(dim=1), -1, 1)
    sq = xyz.square().sum(1)
    equal = {
        "atan2": torch.atan2(y, x) == torch.atan2(y.double(), x.double()).float(),
        "asin": torch.asin(s) == torch.asin(s.double()).float(),
        "sqrt": torch.sqrt(sq) == torch.sqrt(sq.double()).float(),
    }
    print(json.dumps({"probe": "cpu_float32_vs_rounded_float64", "points": args.points,
                      "torch": torch.__version__,
                      **{k: float(v.float().mean()) for k, v in equal.items()}}), flush=True)

    rng = np.random.default_rng(6)
    w = world.make_world(rng)
    poses = world.loop_trajectory(300)
    for i in np.linspace(0, 299, args.scans).astype(int):
        pts = tproj.pad_points(world.scan_at_pose(w, poses[i], rng))
        jr, jv, _, jidx = (np.asarray(a) for a in jproj.range_projection(jnp.asarray(pts)))
        tr, tv, _, tidx = tproj.range_projection(torch.from_numpy(pts))
        same = tidx.numpy() == jidx
        jn = np.asarray(jproj.normal_map(jnp.asarray(jr), jnp.asarray(jv)))
        tn = tproj.normal_map(tr, tv).numpy()
        stable = same & np.roll(same, -1, axis=1) & np.roll(same, -1, axis=0)
        valid = stable & ~(jn == -1).all(-1) & ~(tn == -1).all(-1)
        ref = normals_f64(jr, jv)
        both = ~(jn == -1).all(-1) & ~(ref == -1).all(-1)
        print(json.dumps({
            "probe": "full_scan_vs_jax", "frame": int(i), "points": int(pts[:, :3].any(1).sum()),
            "pixels_with_another_winner": int((~same).sum()),
            "normal_max_absdiff_vs_jax": float(np.abs(tn - jn)[valid].max()),
            "jax_normal_max_absdiff_vs_float64": float(np.abs(jn - ref)[both].max()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

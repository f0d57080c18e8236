"""Yaw conventions: correlation-peak bins <-> physical degrees.

The legs are VALID convs with total column stride 2 on a 900-column
panorama, so the correlation peak moves ``input_width / (360 * width_stride)``
= 1.25 bins per degree of yaw, not the 1 bin the reference's ``180 - argmax``
readout assumes (reference infer.py:158). ``ModelConfig.yaw_space`` selects
the convention:

- 'calibrated' (default): targets sit at the bin where the physical peak
  lands, and decoding divides by the bins-per-degree factor.
- 'reference': bit-parity with the reference (targets = GT bins, decode =
  center - peak in bins-as-degrees).

All functions accept numpy arrays or tensors and return tensors.
"""

from __future__ import annotations

import torch

from overlapnet_torch.core.leg_specs import bins_per_degree, leg_output_width


def ref_bins_to_degrees(bins, mcfg) -> torch.Tensor:
    """GT-npz yaw bins (reference format, com_overlap_yaw.py:54) ->
    physical degrees in (-180, 180]."""
    w = leg_output_width(mcfg)
    return (w // 2 - torch.as_tensor(bins, dtype=torch.float32)) * (360.0 / w)


def target_bins(ref_bins, mcfg) -> torch.Tensor:
    """Training-target bin index for GT bins in the reference npz format.

    'reference': unchanged. 'calibrated': the bin where the correlation
    peak physically lands for that relative yaw."""
    ref_bins = torch.as_tensor(ref_bins)
    if mcfg.yaw_space == "reference":
        return ref_bins
    w = leg_output_width(mcfg)
    yaw_deg = ref_bins_to_degrees(ref_bins, mcfg)
    peak = torch.round(bins_per_degree(mcfg) * yaw_deg)
    return torch.remainder(w // 2 - peak.to(torch.int32), w)


def peak_to_degrees(peak, mcfg) -> torch.Tensor:
    """Correlation peak position (float sub-bin ok) -> yaw degrees.

    'reference': center - peak, read as degrees (reference infer.py:158).
    'calibrated': (center - peak) / bins_per_degree, wrapped to
    (-180, 180]."""
    w = leg_output_width(mcfg)
    off = w // 2 - torch.as_tensor(peak, dtype=torch.float32)
    if mcfg.yaw_space == "reference":
        deg = off * (360.0 / w)
    else:
        deg = off / bins_per_degree(mcfg)
    return torch.remainder(deg + 180.0, 360.0) - 180.0

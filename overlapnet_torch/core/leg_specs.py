"""Pure-arithmetic leg conv-stack geometry (no framework imports).

The leg output width is a function of the conv stack (reference
generateNet.py:161-217; shape table in SURVEY.md §2). Config validation needs
this derivation without pulling in torch — keep this module dependency-free.
``models.legs`` builds the actual conv modules from the same specs.
"""

from __future__ import annotations


def conv_specs(cfg) -> list[tuple[str, int, tuple[int, int], tuple[int, int]]]:
    """(name, features, kernel hxw, strides) for the leg stack.

    ``cfg`` is a ModelConfig (duck-typed to avoid a circular import with
    core.config).
    """
    if cfg.small_net:
        return [("s_conv1", 2, (5, 15), (5, 5))]
    specs = [
        ("s_conv1", 16, (5, 15), tuple(cfg.strides_layer1)),
        ("s_conv2", 32, (3, 15), (2, 1)),
        ("s_conv3", 64, (3, 15), (2, 1)),
    ]
    if cfg.additional_unsymmetric_layer3a:
        specs.append(("s_conv3a", 64, (3, 12), (2, 1)))
    specs += [
        ("s_conv4", 128, (2, 9), (2, 1)),
        ("s_conv5", 128, (1, 9), (1, 1)),
        ("s_conv6", 128, (1, 9), (1, 1)),
        ("s_conv7", 128, (1, 9), (1, 1)),
        ("s_conv8", 128, (1, 7), (1, 1)),
        ("s_conv9", 128, (1, 5), (1, 1)),
        ("s_conv10", 128, (1, 3), (1, 1)),
    ]
    return specs


def leg_output_width(cfg) -> int:
    """Static leg output width for an input of width cfg.input_width.

    'circular' leg padding keeps the width periodic: W' = W / width_stride
    (450 for the 900-col panorama) — the feature space covers the full
    360 degrees with no border loss."""
    if getattr(cfg, "leg_padding", "valid") == "circular":
        w, s = cfg.input_width, width_stride(cfg)
        if w % s:
            raise ValueError(
                f"circular legs need input_width divisible by the total "
                f"width stride ({s}); got {w}"
            )
        return w // s
    w = cfg.input_width
    h = cfg.input_height
    for _, _, (kh, kw), (sh, sw) in conv_specs(cfg):
        w = (w - kw) // sw + 1
        h = (h - kh) // sh + 1
        if w <= 0 or h <= 0:
            raise ValueError(
                f"Leg conv stack collapses input {cfg.input_height}x"
                f"{cfg.input_width} to nonpositive size at some layer"
            )
    return w


def leg_output_height(cfg) -> int:
    h = cfg.input_height
    for _, _, (kh, _), (sh, _) in conv_specs(cfg):
        h = (h - kh) // sh + 1
    return h

def width_stride(cfg) -> int:
    """Total column stride of the leg stack (product of width strides).

    The legs are translation-covariant at this granularity: rolling the
    input panorama by ``s`` columns rolls the feature volume by
    ``s / width_stride`` bins (measured on real scans,
    tests/test_models.py::test_rolled_input_shifts_correlation_peak).
    """
    s = 1
    for _, _, _, (_, sw) in conv_specs(cfg):
        s *= sw
    return s


def bins_per_degree(cfg) -> float:
    """Correlation-peak bins per degree of physical yaw.

    The input range image is a full 360-degree panorama
    (``input_width`` columns over 2*pi, geometry/projection.py), so one
    degree = input_width/360 columns = input_width/(360*width_stride)
    feature bins. For the reference geometry (900 cols, stride 2) this is
    **1.25 — not 1**: the reference's ``yaw = 180 - argmax`` readout
    (reference infer.py:158) carries a systematic 1.25x scale error that
    the 'calibrated' yaw space (ModelConfig.yaw_space) corrects.
    """
    return cfg.input_width / (360.0 * width_stride(cfg))

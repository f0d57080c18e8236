"""Operations, bytes and peaks: the benchmark's own arithmetic.

Counts are the algorithm's, from shapes: every multiply-add is two
operations, an elementwise subtract-and-abs two, and each input and output
byte is counted once, whatever a kernel reads again or how many passes its
arithmetic takes (K1 and K2 run 3xTF32, three tensor-core products per
product of the algorithm; they are counted once). So a later kernel reads
against the same work.

The head and leg counts follow the OverlapNet architecture (reference
generateNet.py: 360OutputkLegs, DeltaLayerConv1NetworkHead, CorrelationHead)
and are written from its shapes here; nothing is imported from the program.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM5 at its 700 W limit (NVIDIA's data
# sheet, dense rates without sparsity).
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

F32 = 4
HEAD_FEATURES = 64  # c_conv1 filters


def leg_convs(height: int, width: int, channels: int, layer3a: bool = True,
              strides_layer1=(2, 2)):
    """(name, out_h, out_w, features, kh, kw, cin) of each leg conv, VALID
    padding (generateNet.py:161-217)."""
    specs = [("s_conv1", 16, (5, 15), tuple(strides_layer1)),
             ("s_conv2", 32, (3, 15), (2, 1)),
             ("s_conv3", 64, (3, 15), (2, 1))]
    if layer3a:
        specs.append(("s_conv3a", 64, (3, 12), (2, 1)))
    specs += [("s_conv4", 128, (2, 9), (2, 1)), ("s_conv5", 128, (1, 9), (1, 1)),
              ("s_conv6", 128, (1, 9), (1, 1)), ("s_conv7", 128, (1, 9), (1, 1)),
              ("s_conv8", 128, (1, 7), (1, 1)), ("s_conv9", 128, (1, 5), (1, 1)),
              ("s_conv10", 128, (1, 3), (1, 1))]
    out, h, w, cin = [], height, width, channels
    for name, f, (kh, kw), (sh, sw) in specs:
        h, w = (h - kh) // sh + 1, (w - kw) // sw + 1
        out.append((name, h, w, f, kh, kw, cin))
        cin = f
    return out


def leg_flops_per_scan(height: int, width: int, channels: int) -> float:
    """Forward operations of one scan through the legs."""
    return float(sum(2 * h * w * f * kh * kw * cin
                     for _, h, w, f, kh, kw, cin in leg_convs(height, width, channels)))


def leg_train_flops_per_scan(height: int, width: int, channels: int) -> float:
    """Forward and backward operations of one scan through the legs: the
    input gradient and the weight gradient each cost a forward, except the
    first conv's input gradient, which nothing needs."""
    convs = leg_convs(height, width, channels)
    fwd = [2.0 * h * w * f * kh * kw * cin for _, h, w, f, kh, kw, cin in convs]
    return 3 * sum(fwd) - fwd[0]


def k1_flops_per_pair(w: int, c: int, s: int) -> float:
    """K1 (the delta layer fused with c_conv1): |a_i - b_(S j + k)| for all
    i, j, k, c (subtract and abs), and the product with the (S*C, 64)
    weight."""
    j = w // s
    return 2.0 * w * j * s * c + 2.0 * w * j * (s * c) * HEAD_FEATURES


def k1_bytes(pairs: int, queries: int, w: int, c: int, s: int) -> float:
    """K1's inputs and outputs once: the left volumes, the distinct right
    volumes (``queries``; a query expanded over its candidates is one), the
    weight and bias, and the (pairs, W', J, 64) float32 output."""
    j = w // s
    return F32 * (pairs * w * c + queries * w * c + s * c * HEAD_FEATURES + HEAD_FEATURES
                  + pairs * w * j * HEAD_FEATURES)


def k2_flops_per_pair(w: int, c: int, s: int) -> float:
    """K2 (the backward of K1): the weight gradient and the gradient of the
    differences (two products of K1's size), the differences formed again
    with their signs, and the sums of the signed gradient into both
    volumes."""
    j = w // s
    return 4.0 * w * j * (s * c) * HEAD_FEATURES + 6.0 * w * j * s * c


def k2_bytes(pairs: int, w: int, c: int, s: int) -> float:
    """K2's inputs (both volumes, the weight, the output gradient) and
    outputs (both volume gradients, the weight and bias gradients) once."""
    j = w // s
    return F32 * (4 * pairs * w * c + 2 * (s * c * HEAD_FEATURES + HEAD_FEATURES)
                  + pairs * w * j * HEAD_FEATURES)


def head_flops_per_pair(w: int, c: int, s: int) -> float:
    """Both heads for one pair, forward: K1, c_conv2 (S x 1, stride S),
    c_conv3 (3 x 3), the overlap dense, and the circular correlation of the
    two volumes over all W' shifts (bench.py:100-115 of the JAX package)."""
    j = w // s
    return (k1_flops_per_pair(w, c, s)
            + 2.0 * j * j * 128 * (s * HEAD_FEATURES)
            + 2.0 * (j - 2) * (j - 2) * 256 * (3 * 3 * 128)
            + 2.0 * (j - 2) * (j - 2) * 256
            + 2.0 * w * w * c)


def least_time_s(flops_by_precision: dict[str, float], bytes_moved: float = 0.0) -> float:
    """The least time the chip could take: the larger of the operations at
    their precision's peak (summed over precisions) and the bytes at the
    memory peak."""
    compute = sum(f / PEAK_FLOPS[p] for p, f in flops_by_precision.items())
    return max(compute, bytes_moved / PEAK_BYTES_PER_S)


def share_percent(least_s: float, measured_s: float) -> float | None:
    """least / measured in percent; None when nothing was measured (a
    reader returns nothing rather than a share of zero)."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / measured_s


def head_train_flops_per_pair(w: int, c: int, s: int) -> float:
    """Both heads for one pair, forward and backward: K1 and K2, and the
    input and weight gradients of c_conv2, c_conv3, the dense (each a
    forward's worth) and both volumes' gradients of the correlation."""
    j = w // s
    rest = (2.0 * j * j * 128 * (s * HEAD_FEATURES)
            + 2.0 * (j - 2) * (j - 2) * 256 * (3 * 3 * 128)
            + 2.0 * (j - 2) * (j - 2) * 256)
    corr = 2.0 * w * w * c
    return k1_flops_per_pair(w, c, s) + k2_flops_per_pair(w, c, s) + 3 * rest + 3 * corr

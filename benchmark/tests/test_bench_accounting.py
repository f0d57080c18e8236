"""The benchmark's operation and byte counts against hand counts."""

import pytest

from benchmark import accounting as acc

W, C, S = 360, 128, 15  # the leg output of the 64 x 900 input, the head's stride


def test_both_heads_of_one_pair():
    # abs-diff 2*360*360*128 + c_conv1 2*360*24*1920*64 + c_conv2
    # 2*24*24*128*960 + c_conv3 2*22*22*256*1152 + dense 2*22*22*256 +
    # correlation 2*360*360*128
    hand = 33_177_600 + 2_123_366_400 + 141_557_760 + 285_474_816 + 247_808 + 33_177_600
    assert hand == 2_617_001_984
    assert acc.head_flops_per_pair(W, C, S) == hand


def test_k1_and_k2():
    assert acc.k1_flops_per_pair(W, C, S) == 33_177_600 + 2_123_366_400
    assert acc.k2_flops_per_pair(W, C, S) == 2 * 2_123_366_400 + 3 * 33_177_600
    # 256 pairs against one expanded query: left volumes, one right volume,
    # the weight and bias, the (256, 360, 24, 64) output, 4 bytes each
    assert acc.k1_bytes(256, 1, W, C, S) == 4 * (256 * 46_080 + 46_080 + 122_880 + 64
                                                 + 256 * 552_960)


@pytest.mark.parametrize("channels,gflop", [(4, 1.733222144), (25, 2.403038144)])
def test_legs(channels, gflop):
    assert acc.leg_flops_per_scan(64, 900, channels) == pytest.approx(gflop * 1e9, rel=1e-12)
    s_conv1 = 2 * 30 * 443 * 16 * 5 * 15 * channels
    assert acc.leg_train_flops_per_scan(64, 900, channels) == pytest.approx(
        3 * gflop * 1e9 - s_conv1, rel=1e-12)


def test_roofline_and_shares():
    flops = 256 * acc.k1_flops_per_pair(W, C, S)
    least = acc.least_time_s({"tf32": flops}, acc.k1_bytes(256, 1, W, C, S))
    assert least == pytest.approx(flops / 495e12)  # compute-bound
    assert acc.share_percent(least, 6.12e-3) == pytest.approx(100 * least / 6.12e-3)
    assert acc.share_percent(least, 0.0) is None
    assert acc.least_time_s({}, 3.35e12) == pytest.approx(1.0)

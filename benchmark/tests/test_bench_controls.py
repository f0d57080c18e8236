"""The controls on the card: the reference put in the program's place one
precision step below what the configuration states (fp8 legs, TF32 heads;
a TF32 move of the points for GT) is judged not correct by each cell's own
comparison and limits. At the published widths, on fewer frames, scans
and pairs than a cell's so that a test run holds them; the cells' own
sizes are run by ``python -m benchmark.controls``."""

import tempfile

import pytest

from benchmark import controls, harness

SMALL = {
    "geo.lcd-dense": dict(frames=700, map_frames=500, lap_frames=500, control_frames=60,
                          pool=16),
    "semantic.train": dict(scans=48, probability_pool=16, pairs=1024),
    "geo.gt-prep": dict(frames=200, control_blocks=1, check_pairs=256),
}


@pytest.mark.card
@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_is_not_correct(cell, card, bench_root):
    spec = harness.find_cell(cell, root=bench_root, overrides=SMALL[cell])
    limits = spec.mix["limits"]
    for seed in (101, 2**31 + 7, 9_999_999_967):
        with tempfile.TemporaryDirectory() as tmp:
            got = controls.KINDS[spec.mix["kind"]](harness.Run(spec, seed, card, tmp))
        readings = got["control"] if "control" in got else got
        assert any(readings[k] > lim for k, lim in limits.items()), (seed, readings)
        if "half_batch" in got:
            assert any(got["half_batch"][k] > lim for k, lim in limits.items()), (seed, got)

"""The check's control comes out as not correct: the reference computed at
TF32, in the program's place, fails a limit of each cell. At a size the CPU
holds here; at the cell's own size on the card (``card``). The planted
faults of ``calibrate`` fail too."""

import pytest

from h100bench import calibrate, cell as cells, check

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _readings(name, device, overrides, seeds):
    c = cells.find_cell(name)
    c.traffic.update(overrides)
    kind = {"train": calibrate.training, "recommend": calibrate.recommendation}
    for seed in seeds:
        for cand, numbers in kind[c.traffic["kind"]](c, seed, device):
            yield cand, check.judge(numbers, c.limits)[0], numbers


@pytest.mark.parametrize("name", ["tiger_prefix.train_b1024", "tiger.recommend_b4096"])
def test_control_and_faults_fail_at_a_small_size(name, tiny):
    for cand, ok, numbers in _readings(name, "cpu", tiny[name], SEEDS[:1]):
        assert not ok, (cand, numbers)


@pytest.mark.card
@pytest.mark.parametrize("name", ["tiger_prefix.train_b1024", "tiger.recommend_b4096"])
def test_control_and_faults_fail_at_the_cells_size(name, card):
    for cand, ok, numbers in _readings(name, card, {}, SEEDS):
        assert not ok, (cand, numbers)

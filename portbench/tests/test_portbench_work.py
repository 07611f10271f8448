"""The yardstick's counts against hand counts at small shapes."""

import pytest
import torch
from torch import nn

from portbench import work


def test_counter_matches_a_hand_count():
    conv = nn.Conv1d(8, 16, 5, padding=2, groups=2)
    x = torch.zeros(3, 8, 40)
    assert work.counted_flop(conv, x) == 2 * 3 * 40 * 16 * (8 // 2) * 5


def test_resblock_stage_by_hand():
    # one chain, k = 3, dilations (1, 3): 2 steps x 2 convs x 3 taps
    flop, nbytes = work.resblock_stage(2, 10, 4, (3,), ((1, 3),))
    assert flop == 2 * 2 * 10 * 4 * 4 * (2 * 2 * 3)
    weights = 4 * (3 * 4 * 4 + 4)                  # 4 convs of k C C + bias
    assert nbytes == 4 * (2 * 2 * 10 * 4 + weights)


def test_resblock_stage_matches_the_counter():
    from portbench.reference import nets

    blocks = [nets._ResBlock(8, k, (1, 3, 5)) for k in (3, 7, 11)]
    x = torch.zeros(2, 8, 50)
    counted = sum(work.counted_flop(b, x) for b in blocks)
    flop, _ = work.resblock_stage(2, 50, 8, (3, 7, 11), ((1, 3, 5),) * 3)
    assert counted == flop


def test_gru_flop_by_hand():
    assert work.gru_flop(1, 10, 4, 3) == 2 * 2 * 10 * 3 * 3 * (4 + 3)


@pytest.mark.parametrize("flop,nbytes,want", [(989e12, 1.0, 1.0), (1.0, 3.35e12, 1.0),
                                              (989e9, 6.7e9, 2e-3)])
def test_bound_takes_the_larger(flop, nbytes, want):
    assert work.bound_s(flop, nbytes) == pytest.approx(want)

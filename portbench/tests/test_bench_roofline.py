"""The roofline counts against counts made by hand."""

import pytest

from portbench import roofline


def test_level_products_hand_count():
    # a root with 2 children, one of them with 3 children: 5 edges, 2 nodes;
    # 4 patterns, 3 states, 2 classes, fp32
    count = roofline.level_products([2, 3], patterns=4, states=3, classes=2, itemsize=4)
    assert count["flops"] == 2 * 2 * 5 * 4 * 3 * 3            # 720
    assert count["bytes"] == 4 * 2 * (5 * 4 * 3 + 2 * 4 * 3 + 5 * 3 * 3)   # 1224


def test_site_objective_hand_count():
    # 5 items, 4 branches, 1 group, 3 states, 6 taxa, fp32 output
    count = roofline.site_objective(items=5, branches=4, groups=1, states=3, taxa=6, itemsize=4)
    assert count["flops"] == 5 * (2 * 4 * 9 + 2 * 27)         # 630
    assert count["bytes"] == 5 * (2 * 6 + 4)                  # 80


def test_full_width_counts():
    # 1000 taxa (999 internal nodes of 2 children), 2048 codons, 61 states
    k1 = roofline.level_products([2] * 999, 2048, 61, 1, 4)
    assert roofline.least_seconds(k1["flops"], k1["bytes"]) == pytest.approx(
        (1.527e9 / 3.35e12, "bytes"), rel=1e-3)
    k4 = roofline.site_objective(2048, 1998, 1, 61, 1000, 4)
    assert k4["flops"] == pytest.approx(31.38e9, rel=1e-3)


def test_share_is_least_time_over_time():
    count = {"flops": 67e12, "bytes": 0.0}
    assert roofline.share(count, 2.0) == pytest.approx(50.0)

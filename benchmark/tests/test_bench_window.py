"""The window's arithmetic: the rate over all the window, the tail over
every assembly, a stall included."""

import statistics

import pytest

from harness import window


def test_rate_and_tail_keep_a_stall():
    durations = [0.3] * 95 + [0.31] * 4 + [5.0]
    starts, ends, t = [], [], 100.0
    for d in durations:
        starts.append(t)
        ends.append(t + d)
        t += d + 0.001  # the gap between two calls counts too
    mean = window.mean_wall(starts, ends)
    assert mean == pytest.approx((ends[-1] - starts[0]) / 100)
    assert mean > statistics.median(durations) + 0.04  # the stall shows
    assert window.percentile(durations, 90) == 0.3
    assert window.percentile(durations, 99) == 0.31
    assert window.percentile(durations, 100) == 5.0


def test_percentile_is_nearest_rank():
    values = list(range(1, 11))
    assert window.percentile(values, 90) == 9
    assert window.percentile(values, 50) == 5
    assert window.percentile([7.0], 90) == 7.0


def test_bad_windows_are_refused():
    with pytest.raises(ValueError):
        window.mean_wall([], [])
    with pytest.raises(ValueError):
        window.percentile([], 90)

"""The window's arithmetic on synthetic present times, a stall included."""

import numpy as np
import pytest

from benchmark import window


def test_mean_and_p95_with_a_stall():
    # 200 frames at 10 ms, one stall of 50 ms in the middle
    gaps = [0.010] * 200
    gaps[100] = 0.050
    presents = list(np.cumsum([0.0] + gaps) + 3.0)
    assert window.frame_ms(presents) == pytest.approx(1e3 * 2.04 / 200)
    assert window.frame_ms_p95(presents) == pytest.approx(10.0)
    # ten stalls (5%) reach the 95th percentile
    for k in range(10):
        gaps[10 + 15 * k] = 0.050
    presents = list(np.cumsum([0.0] + gaps))
    assert window.frame_ms_p95(presents) > 10.0
    assert window.frame_ms(presents) == pytest.approx(
        1e3 * sum(gaps) / len(gaps))
    # the stalls of a traced run's profiled stretch are left out
    frames = list(range(len(presents)))
    assert window.frame_ms_p95(presents, frames,
                               range(10, 160)) == pytest.approx(10.0)
    assert window.frame_ms_p95(presents, frames, range(0)) > 10.0


def test_a_window_needs_two_presents():
    with pytest.raises(ValueError):
        window.frame_ms([1.0])
    with pytest.raises(ValueError):
        window.frame_ms_p95([])


def test_spans_record_their_names():
    s = window.Spans()
    with s.span("frame.enqueue"):
        pass
    with s.span("frame.copy"):
        pass
    assert [n for n, _, _ in s.spans] == ["frame.enqueue", "frame.copy"]
    assert len(s.seconds("frame.copy")) == 1

"""The trace's reduction on events made up for the purpose."""

from __future__ import annotations

import pytest

from perfbench.harness.trace import SPAN_PREFIX, summarize


def test_busy_union_gaps_and_names():
    events = [
        (0.0, 1000.0, SPAN_PREFIX + "tohr", False),
        (1000.0, 2000.0, SPAN_PREFIX + "tohr", False),
        (100.0, 300.0, "k1", True),
        (200.0, 400.0, "k2", True),      # overlaps k1: busy 100..400
        (700.0, 800.0, "k1", True),
        (1100.0, 1900.0, "k3", True),
        (450.0, 650.0, "aten::copy_", False),
        (420.0, 690.0, "aten::to", False),
    ]
    out = summarize(events)
    assert out["window_us"] == 2000.0
    assert out["busy_s"] == pytest.approx((300 + 100 + 800) * 1e-6)
    assert out["device_s_by_name"]["k1"] == pytest.approx(300e-6)
    assert out["device_ops"][0][0] == "k3"
    gaps = out["idle_gaps"]
    assert [round(g[1] * 1e6) for g in gaps] == [300, 300, 100, 100]
    # the 400..700 gap: inside the first request, the innermost host operator at its middle
    assert gaps[0][0] == "tohr +0.001 s / aten::copy_"
    assert gaps[1][0] == "tohr +0.001 s / no host operator"


def test_no_device_event_is_an_error():
    with pytest.raises(RuntimeError):
        summarize([(0.0, 10.0, SPAN_PREFIX + "tohr", False)])

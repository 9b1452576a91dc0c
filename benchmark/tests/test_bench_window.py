"""The window arithmetic on synthetic timings."""

import pytest

from benchmark.lib.common import percentile
from benchmark.lib.trace import Trace
from benchmark.lib.window import busy_seconds, idle_gaps, idle_share, \
    merged, rate


def test_rate_is_all_work_over_the_whole_window():
    assert rate(300, 10.0, 40.0) == pytest.approx(10.0)
    with pytest.raises(ValueError):
        rate(1, 5.0, 5.0)


def test_p95_is_over_every_batch():
    values = list(range(1, 101))          # 1 .. 100
    assert percentile(values, 95) == 95
    assert percentile(values[::-1], 95) == 95
    assert percentile([7.0], 95) == 7.0
    # one slow batch in twenty shows, one in a hundred does not
    assert percentile([1.0] * 19 + [50.0], 95) == 1.0
    assert percentile([1.0] * 18 + [50.0] * 2, 95) == 50.0


def test_busy_time_is_the_union_of_overlapping_kernels():
    kernels = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.75), (5.0, 6.0)]
    assert merged(kernels) == [(0.0, 3.0), (5.0, 6.0)]
    assert busy_seconds(kernels) == pytest.approx(4.0)
    # a sum of durations would count 5.25 and make the idle share negative
    # over the window [0, 5]
    assert idle_share(kernels, 0.0, 6.0) == pytest.approx(2.0 / 6.0)
    assert busy_seconds(kernels, 0.5, 5.5) == pytest.approx(3.0)
    assert idle_gaps(kernels, 0.0, 6.0) == [(3.0, 5.0)]
    assert idle_gaps([(1.0, 2.0)], 0.0, 4.0) == [(0.0, 1.0), (2.0, 4.0)]


def test_trace_idle_share_and_breakdown():
    device = [('k1', 0.0, 1.0), ('copy', 0.5, 1.5), ('k1', 3.0, 4.0)]
    host = [('bench.submit', -0.1, 0.2), ('bench.wait', 1.2, 3.5)]
    t = Trace(device, host, units=2)
    assert t.window_s == pytest.approx(4.0)
    assert t.busy_s == pytest.approx(2.5)
    assert t.idle_share() == pytest.approx(1.5 / 4.0)
    b = t.breakdown()
    assert b['device_ops'][0] == ['k1', 2.0]
    assert b['idle_gaps'] == [['wait', 1.5]]

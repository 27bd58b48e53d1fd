"""The trace's reduction on synthetic intervals: busy and idle time, gaps
named by the host operation over them, counts and kernel times."""

import pytest

from bench_torch.harness.trace import Event, reduce_trace


def test_idle_share_from_synthetic_intervals():
    device = [Event("k1", 10, 30), Event("k2", 20, 40), Event("Memcpy HtoD", 60, 70),
              Event("k1", 90, 120)]
    host = [Event("bench.call", 0, 100), Event("aten::copy_", 40, 60),
            Event("cudaStreamSynchronize", 45, 58), Event("bench.call", 100, 100.5),
            Event("cudaStreamSynchronize", 150, 151)]
    s = reduce_trace(device, host, 0.0, 100.0)
    assert s.window_us == 100.0
    assert s.busy_us == pytest.approx(30 + 10 + 10)     # [10,40] [60,70] [90,100]
    assert 1 - s.busy_us / s.window_us == pytest.approx(0.5)
    assert s.kernels == 3 and s.syncs == 1
    assert s.kernel("k1") == (2, pytest.approx(20 + 30))
    gaps = dict(s.idle_gaps)
    # [0,10] and [70,90] under bench.call alone; [40,60] under the sync
    assert gaps["bench.call"] == pytest.approx(30e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    ops = dict(s.device_ops)
    assert ops["k1"] == pytest.approx(30e-6)   # the second launch clipped at 100
    assert s.device_ops[0][0] == "k1"


def test_no_device_activity_is_all_idle():
    s = reduce_trace([], [], 5.0, 25.0)
    assert s.busy_us == 0 and s.idle_gaps == [["host: no op", pytest.approx(20e-6)]]

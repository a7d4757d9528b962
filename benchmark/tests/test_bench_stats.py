"""The arithmetic of the end-to-end metrics: a rate over all the work and the
whole window, a tail over every call."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchlib import harness as H
from benchlib import stats


@pytest.mark.parametrize("n", [1, 2, 7, 20, 101, 1000])
def test_quantile_is_numpys_linear_percentile_over_all_values(n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    for q in (0.5, 0.95, 0.99):
        assert stats.quantile(xs, q) == pytest.approx(float(np.percentile(xs, 100 * q)))


def test_p95_reads_the_tail_of_every_call():
    lat = [0.010] * 95 + [0.100] * 5        # 5 slow calls of 100
    w = H.WindowCtx(None, None, lat, [0] * 100, 1.5, 0.0)
    p95 = H.E2E["quantile"](w, {"q": 0.95, "scale": 1000.0})
    assert p95 == pytest.approx(10 + 0.05 * 90)      # between the 95th and 96th value
    assert H.E2E["quantile"](w, {"q": 0.99, "scale": 1000.0}) == pytest.approx(100.0)


def test_rate_is_all_the_work_over_the_whole_window():
    driver = SimpleNamespace(work=lambda st, k: [100, 300][k])
    w = H.WindowCtx(driver, None, [0.1] * 4, [0, 1, 0, 1], 2.0, 0.0)
    assert H.E2E["rate"](w, {}) == pytest.approx(800 / 2.0)
    assert stats.rate(16384 * 10, 0.5) == pytest.approx(327680.0)


def test_the_window_counts_every_call_to_the_last_ones_end():
    kept = []

    class Driver:
        @staticmethod
        def call(st, k):
            time.sleep(0.02)
            return k

        @staticmethod
        def keep(st, i, k, out):
            kept.append((i, k, out))

    st = SimpleNamespace(n_batches=3)
    lat, batch, window_s, traced, prof = H.run_window(Driver, st, 0.1, "cpu")
    assert window_s >= 0.1 and prof is None and traced == []
    assert len(lat) == len(batch) == len(kept) >= 4
    assert batch[:4] == [0, 1, 2, 0]                       # the batches cycle
    assert sum(lat) <= window_s and window_s - sum(lat) < 0.05

"""The closed loop ends at its deadline, times each call from its start, and times the
garbage collections inside its window."""

import gc
import time

import numpy as np

from perfbench import loop


def _run(seconds, n_batches, collect_at=None):
    pool = np.zeros((n_batches * 4, 3), np.float32)
    keys = np.random.default_rng(0).random(n_batches)

    seen = []

    def call(qs):
        seen.append(1)
        if len(seen) == collect_at:
            gc.collect()
        time.sleep(0.02)
        return [[] for _ in range(len(qs))]

    return loop.closed_loop(call, pool, 4, 2, seconds, keys, 3)


def test_window_ends_at_the_deadline():
    win = _run(0.4, 10_000)
    assert not win.pool_out and not win.failed
    assert 0.4 <= win.seconds < 0.4 + 0.2
    assert max(s for _, s, _ in win.calls) - win.t0 < 0.4
    lat = win.latencies_ms()
    assert lat.size == len(win.calls) >= 10 and np.all(lat >= 19)
    assert len(win.kept) == 3 and len({j for j, *_ in win.calls}) == len(win.calls)


def test_pool_that_runs_out_ends_the_window_early():
    win = _run(5.0, 6)
    assert win.pool_out and len(win.calls) == 6 and win.seconds < 1.0


def test_collections_in_the_window_are_timed():
    win = _run(0.3, 10_000, collect_at=2)
    assert any(g == 2 and s > 0 for g, s in win.gc_pauses)
    assert win.gc_summary()["gen2"]["n"] >= 1
    assert any(name == "gc.gen2" for name, *_ in win.host_spans)

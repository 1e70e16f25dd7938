"""A run on the CPU at a tiny size comes out correct, and comes out not correct with the
timed path broken underneath it, or with the reference in a lower precision put in the
program's place (the control)."""

import pytest

from perfbench import control, system
from perfbench.tests.conftest import SEED, any_cell, run_tiny, tiny_cell

CELLS = ["cohere768.k10-b512", "sift1m-bf16.k10-b512", "cohere768.filter99-k10-b512"]


def _break(monkeypatch, fault):
    build = system.build

    def broken(*args, **kwargs):
        qp, ids = build(*args, **kwargs)
        raw, batch = qp._raw_search, qp.find_similar_batch
        if fault == "half_batch":
            # half of the batch left out: the call answers its first half only
            def short(queries, *a, **kw):
                return batch(queries[: len(queries) // 2], *a, **kw)
            qp.find_similar_batch = short
        elif fault == "altered_answer":
            # one answer altered where it is produced: query 0's last hit names another row
            def altered(*a, **kw):
                dist, slots, ns, tables = raw(*a, **kw)
                slots = slots.copy()
                slots[0, -1] = (int(slots[0, -1]) + 17) % len(tables[0])
                return dist, slots, ns, tables
            qp._raw_search = altered
        elif fault == "altered_score":
            def shifted(*a, **kw):
                dist, slots, ns, tables = raw(*a, **kw)
                dist = dist.copy()
                dist[0, 0] *= 1.0 + 1e-4
                return dist, slots, ns, tables
            qp._raw_search = shifted
        return qp, ids

    monkeypatch.setattr(system, "build", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, lines = run_tiny(cell, trace=(cell == CELLS[0]))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    if cell == CELLS[0]:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    else:
        assert set(out["metrics"]) >= {"qps", "setup_s", "space_amplification"}


@pytest.mark.parametrize("fault,check", [("half_batch", "missing"),
                                         ("altered_answer", "rank_gap"),
                                         ("altered_score", "dist_err")])
def test_broken_path_is_not_correct(monkeypatch, fault, check):
    _break(monkeypatch, fault)
    out, _ = run_tiny(CELLS[2] if fault == "half_batch" else CELLS[0])
    assert not out["correct"]
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_control_is_not_correct(cell, precision):
    out = control.run_control(tiny_cell(cell, 20000), SEED, precision, "cpu")
    assert not out["correct"]
    assert out["checks"]["dist_err"]["value"] > out["checks"]["dist_err"]["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_is_not_correct(cuda_device, cell):
    from perfbench import spec

    for seed in (SEED, SEED + 1, SEED + 2):
        out = control.run_control(any_cell(cell), seed, "tf32", cuda_device)
        assert not out["correct"], out

"""The cell ``sift1m-bf16.k10-b512``: its readers of the certified sweep's spans and of the
light program's share on a synthetic window (None where the program recorded nothing),
and a tiny run on the CPU that the sweep path served, correct."""

import json
from types import SimpleNamespace

import pytest

from perfbench import spec
from perfbench.tests.conftest import run_tiny

CELL = "sift1m-bf16.k10-b512"
PHASES = {"cert.sweep_phase1_ms": "sweep.phase1", "cert.sweep_rescan_ms": "sweep.rescan",
          "cert.sweep_proof_ms": "sweep.proof"}
WINDOW = {"knn_kernel": (120.0, 4), "sweep.phase1": (30.0, 4), "sweep.rescan": (80.0, 4),
          "sweep.proof": (6.0, 4), "sweep.phase1.cpu": (10.0, 4)}


def _ctx(spans=None, tiers=None):
    return SimpleNamespace(delta={"spans": spans or {}, "tiers": tiers or {}})


def test_the_cell_lists_its_readers():
    names = {m["name"] for m in spec.cell(CELL)["per_layer"]}
    assert set(PHASES) | {"cert.light_share", "sweep_min_roofline", "client.call_p50_ms"} <= names
    assert "window_min_roofline" not in names


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_phase_reader_is_the_mean_of_its_span(metric):
    ms, n = WINDOW[PHASES[metric]]
    assert spec.reader(metric).read(_ctx(WINDOW)) == pytest.approx(ms / n)


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_phase_reader_reads_none_without_its_span(metric):
    """A program without the sweep's spans (the parent, or the row-major path)."""
    window = {k: v for k, v in WINDOW.items() if not k.startswith(PHASES[metric])}
    assert spec.reader(metric).read(_ctx(window)) is None
    window[PHASES[metric]] = (0.0, 0)
    assert spec.reader(metric).read(_ctx(window)) is None


@pytest.mark.parametrize("tiers,want", [
    ({"light_fast": 3, "fast": 1}, 75.0),
    ({"light_fast": 2, "light_widened": 1, "light_exact_scan": 1}, 100.0),
    ({"fast": 4}, 0.0),
    # batches the shape gate sent to the scan ran no certificate
    ({"light_fast": 2, "light_disengaged": 5, "disengaged": 1}, 100.0),
    ({"light_disengaged": 5}, None),
    ({}, None),
])
def test_light_share_of_the_certified_batches(tiers, want):
    got = spec.reader("cert.light_share").read(_ctx(tiers=tiers))
    assert got == (None if want is None else pytest.approx(want))


def test_tiny_run_is_served_by_the_sweep():
    out, lines = run_tiny(CELL, trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    delta = next(json.loads(x)["counters"] for x in lines if x.startswith('{"counters"'))
    # every batch of the window on the light program's tier 0
    assert set(delta["tiers"]) == {"light_fast"} and delta["tiers"]["light_fast"] > 0
    calls = delta["spans"]["knn_kernel"][1]
    assert calls == delta["tiers"]["light_fast"]
    assert {span: delta["spans"][span][1] for span in PHASES.values()} == dict.fromkeys(
        PHASES.values(), calls)
    metrics = out["metrics"]
    assert metrics["cert.light_share"]["value"] == 100.0
    assert metrics["cert.tier0_share"]["value"] == 100.0
    for name in PHASES:
        assert metrics[name]["value"] > 0
    # the phases lie inside knn_kernel
    assert sum(metrics[name]["value"] for name in PHASES) <= metrics["engine.issue_ms"]["value"]

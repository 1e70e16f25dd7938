"""Cells, configurations, traffic mixes and metrics are found by name from their files,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c["config"]["name"] == entry["config"]
    assert c["chips"] == 1
    assert c["traffic"]["loop"] == "closed" and c["traffic"]["queries"] == "gaussian"
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    assert NAME.match(cell) and len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("cfg", sorted(p.stem for p in (spec.HERE / "configs").glob("*.json")))
def test_config_file(cfg):
    """Every configuration's file, whether BENCHMARK.json lists it yet or not."""
    body = spec.config(cfg)
    entry = next((c for c in BENCH["configs"] if c["name"] == cfg), None)
    if entry is not None:
        assert entry["file"] == f"perfbench/configs/{cfg}.json"
        assert body["source"] == entry["source"] and entry["reduced"] == []
    assert body["name"] == cfg and len(body["source"]) <= 200
    assert set(body["limits"]) == {"missing", "foreign", "hydrate_bad", "rank_gap", "dist_err"}
    assert body["limits"]["missing"] == body["limits"]["foreign"] == 0
    assert body["limits"]["hydrate_bad"] == 0
    assert body["rows"] == 1_000_000 and body["assumed"]


@pytest.mark.parametrize("metric", spec.metric_names(BENCH))
def test_metric_reader_found_by_name(metric):
    entries = BENCH["end_to_end"] + BENCH["per_layer"]
    entry = next(m for m in entries if m["name"] == metric)
    mod = spec.reader(metric)
    assert mod.UNIT == entry["unit"] and UNIT.match(entry["unit"])
    assert callable(mod.read) and NAME.match(metric)
    for cell in entry.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_metric_entries():
    names = spec.metric_names(BENCH)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert m["bound"] >= 0.01
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        spec.cell("no-such-cell")

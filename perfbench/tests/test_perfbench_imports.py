"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package, and the
reference side loads nothing of the port either; names compare by their whole top-level
part (the port's name begins with the JAX package's)."""

import json
import subprocess
import sys


JAX_SIDE = {"jax", "jaxlib", "flax", "mlvectordb_tpu"}

_PROBE = r"""
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    from perfbench.spec import ROOT

    res = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_reference_side_loads_nothing_of_either_package():
    mods = _top_level("from perfbench import data, reference, judge, roofline, capture, "
                      "control, spec, loop")
    assert not mods & (JAX_SIDE | {"mlvectordb_tpu_torch"})


def test_a_run_loads_no_jax():
    body = (
        "import perfbench.run\n"
        "from perfbench import harness, spec\n"
        "from perfbench.tests.conftest import tiny_cell, SEED\n"
        "for m in spec.metric_names(spec.benchmark()): spec.reader(m)\n"
        "out = harness.run_cell(tiny_cell('cohere768.filter99-k10-b512', 3000), SEED, 0.5,"
        " True, 'cpu', time.time(), log=lambda s: None)\n"
        "assert out['correct'], out['checks']\n"
    )
    mods = _top_level(body)
    assert "mlvectordb_tpu_torch" in mods
    assert not mods & JAX_SIDE


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    from perfbench import run

    monkeypatch.setitem(sys.modules, "mlvectordb_tpu_torch_fake", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jaxlib"]

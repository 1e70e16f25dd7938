"""The port's multi-device dry run, ``mlvectordb_tpu_torch.parallel.dryrun``: the
counterparts of tests/test_dryrun.py's three ways of calling ``dryrun_multichip``.

Torch fixes no device count at first use, so the port needs no re-exec: the call works
in a fresh interpreter, after the calling process already ran torch work, and as
``python -m``.  Each prints the JAX entry point's OK line; the fresh interpreter also
shows that the dry run imports no JAX.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OK = "dryrun_multichip OK: mesh replica=2 x shard=4"


def test_driver_style_import_and_call():
    """Import the module and call dryrun_multichip(8) in a fresh interpreter, on the CPU;
    neither jax nor the JAX package is imported."""
    code = ("import sys; from mlvectordb_tpu_torch.parallel.dryrun import dryrun_multichip; "
            "dryrun_multichip(8, device='cpu'); "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'mlvectordb_tpu.')) or m == 'mlvectordb_tpu'], 'jax imported'")
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert OK in proc.stdout


def test_call_after_torch_already_initialized(capsys):
    """The calling process already ran torch work (and the JAX mesh of the test harness
    exists): the dry run still runs in-process, twice, with any even device count."""
    from mlvectordb_tpu_torch.parallel.dryrun import dryrun_multichip

    assert float(torch.ones(3).sum()) == 3.0
    dryrun_multichip(8, device="cpu")
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert OK in out and "mesh replica=2 x shard=2" in out
    if not torch.cuda.is_available():   # the default device is the card's
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(8)


def test_main_entry(capsys):
    import runpy

    argv = sys.argv
    sys.argv = ["dryrun", "8", "--device", "cpu"]
    try:
        runpy.run_module("mlvectordb_tpu_torch.parallel.dryrun", run_name="__main__")
    finally:
        sys.argv = argv
    assert OK in capsys.readouterr().out

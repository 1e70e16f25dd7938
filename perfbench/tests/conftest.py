"""Shared helpers of the benchmark's own tests (``python -m pytest perfbench/tests``)."""

import time

import pytest

from perfbench import spec

SEED = 2**33 + 4242  # past 32 bits, as the driver's seeds are


# cells whose files are here but that BENCHMARK.json does not list yet (PERF.md, Open
# questions): (configuration, traffic)
UNLISTED = {"sift1m-bf16.k10-b512": ("sift1m-bf16", "closed-k10-b512"),
            "cohere768.filter99-k10-b512": ("cohere768", "closed-filter99-k10-b512")}


def any_cell(name: str) -> dict:
    bench = spec.benchmark()
    if name in {w["name"] for w in bench["workloads"]}:
        return spec.cell(name, bench)
    return spec.assemble(name, *UNLISTED[name], 1, bench)


def tiny_cell(name: str, rows: int = 6000, dim: int = None) -> dict:
    """The cell ``name`` at a size a test run holds: fewer rows, 64-query batches from 2
    clients, a pool for at most 400 queries a second; the widths, metric, filter rate
    and engine settings stay."""
    c = any_cell(name)
    c["config"]["rows"] = rows
    if dim is not None:
        c["config"]["dim"] = dim
    c["traffic"].update(batch=64, clients=2, pool_qps=400, warmup_calls=1, check_calls=3,
                        trace_lead_s=0.2, trace_seconds=0.5)
    return c


def run_tiny(name: str, seconds: float = 1.5, trace: bool = False, rows: int = 6000):
    from perfbench import harness

    lines = []
    out = harness.run_cell(tiny_cell(name, rows), SEED, seconds, trace, "cpu", time.time(),
                           log=lines.append)
    return out, lines


@pytest.fixture
def cuda_device():
    """Skips without a CUDA device (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"

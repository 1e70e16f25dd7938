"""The roofline counts at each cell's shapes against the hand arithmetic."""

import pytest

from perfbench import roofline, spec
from perfbench.tests.conftest import any_cell


def test_cohere768_unfiltered():
    ops, nbytes = roofline.phase1_work(1_000_000, 768, 512, 10, "float32")
    assert ops == 2 * 1_000_000 * 768 * 512
    assert nbytes == 1_000_000 * 768 * 4 + 512 * 768 * 4 + 512 * 10 * 8
    # 3.074 GB over 3.35 TB/s: the bytes bound 0.9177 ms beats 786 GFLOP at 989 TFLOP/s
    assert roofline.bound_seconds(ops, nbytes, "float32") == pytest.approx(0.9177e-3, rel=1e-3)
    assert roofline.share_pct(ops, nbytes, "float32", 0.9177e-2) == pytest.approx(10.0, rel=1e-3)


def test_cohere768_filter99_counts_matching_rows():
    ops, nbytes = roofline.phase1_work(10_000, 768, 512, 10, "float32")
    assert ops == 2 * 10_000 * 768 * 512
    assert nbytes == 10_000 * 768 * 4 + 512 * 768 * 4 + 512 * 10 * 8
    # 32.3 MB over 3.35 TB/s (9.65 us) beats 7.86 GFLOP at 989 TFLOP/s (7.95 us)
    assert roofline.bound_seconds(ops, nbytes, "float32") == pytest.approx(9.652e-6, rel=1e-3)


def test_sift1m_bf16_mirror():
    ops, nbytes = roofline.phase1_work(1_000_000, 128, 512, 10, "bfloat16")
    assert nbytes == 1_000_000 * 128 * 2 + 512 * 128 * 4 + 512 * 10 * 8
    # 131 GFLOP at 989 TFLOP/s: 0.1325 ms, above the bytes bound of 0.0767 ms
    assert roofline.bound_seconds(ops, nbytes, "bfloat16") == pytest.approx(0.13254e-3, rel=1e-3)


def test_int8_peak_and_peaks_table():
    assert roofline.TENSOR_PEAK == {"float32": 989e12, "bfloat16": 989e12, "int8": 1979e12}
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_kernel_share_reads_the_cell():
    from types import SimpleNamespace

    cell = any_cell("cohere768.filter99-k10-b512")
    trace = {"kernels": {"void window_mma_kernel<0>(WArgs)": [0.02, 2],
                         "void other_kernel()": [5.0, 9]}}
    ctx = SimpleNamespace(trace=trace, config=cell["config"], traffic=cell["traffic"],
                          rows_admitted=10_000)
    ops, nbytes = roofline.phase1_work(10_000, 768, 512, 10, "float32")
    want = 100 * roofline.bound_seconds(ops, nbytes, "float32") / 0.01
    assert spec.reader("window_min_roofline").read(ctx) == pytest.approx(want)
    assert spec.reader("sweep_min_roofline").read(ctx) is None
    ctx.trace = None
    assert spec.reader("window_min_roofline").read(ctx) is None

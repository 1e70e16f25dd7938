"""The readers of the program's search-call spans on a synthetic window: each returns its
span's mean wall, or the off-CPU share, and None where its span did not run."""

from types import SimpleNamespace

import pytest

from perfbench import spec

MEANS = {"engine.prepare_ms": "query.prepare", "engine.upload_ms": "knn_upload",
         "engine.issue_ms": "knn_kernel", "engine.fetch_ms": "knn_fetch",
         "cert.finish_ms": "knn_finish", "engine.cache_store_ms": "query.cache_store"}


def ctx(spans):
    return SimpleNamespace(delta={"spans": spans})


WINDOW = {"query.prepare": (40.0, 4), "knn_upload": (400.0, 4), "knn_kernel": (80.0, 4),
          "knn_fetch": (480.0, 4), "knn_finish": (8.0, 4), "hydrate": (100.0, 4),
          "query.cache_store": (20.0, 4), "filter_mask": (4.0, 1),
          "query.prepare.cpu": (20.0, 4), "knn_upload.cpu": (1.0, 4),
          "knn_kernel.cpu": (40.0, 4), "knn_fetch.cpu": (2.0, 4), "knn_finish.cpu": (2.0, 4),
          "hydrate.cpu": (60.0, 4), "query.cache_store.cpu": (10.0, 4)}


@pytest.mark.parametrize("metric", sorted(MEANS))
def test_mean_of_its_span(metric):
    ms, n = WINDOW[MEANS[metric]]
    assert spec.reader(metric).read(ctx(WINDOW)) == pytest.approx(ms / n)


@pytest.mark.parametrize("metric", sorted(MEANS))
def test_none_without_its_span(metric):
    window = {k: v for k, v in WINDOW.items() if not k.startswith(MEANS[metric])}
    assert spec.reader(metric).read(ctx(window)) is None
    # a span that ran no time in the window: its count did not move
    window[MEANS[metric]] = (0.0, 0)
    assert spec.reader(metric).read(ctx(window)) is None


def test_issue_needs_the_fetch_span():
    """Where ``knn_kernel`` still holds the copy back, it is not issuing alone."""
    window = {k: v for k, v in WINDOW.items() if not k.startswith("knn_fetch")}
    assert spec.reader("engine.issue_ms").read(ctx(window)) is None


def test_offcpu_share_of_the_host_work_spans():
    # wall 40 + 80 + 8 + 100 + 20 = 248 ms, CPU 20 + 40 + 2 + 60 + 10 = 132 ms; upload
    # and fetch left out
    got = spec.reader("runtime.offcpu_pct").read(ctx(WINDOW))
    assert got == pytest.approx(100.0 * (1 - 132.0 / 248.0))


def test_offcpu_counts_only_spans_with_cpu_time():
    window = {k: v for k, v in WINDOW.items() if k != "hydrate.cpu"}
    got = spec.reader("runtime.offcpu_pct").read(ctx(window))
    assert got == pytest.approx(100.0 * (1 - 72.0 / 148.0))


def test_offcpu_none_without_cpu_aggregates():
    """A program whose spans carry no CPU time reads nothing."""
    window = {k: v for k, v in WINDOW.items() if not k.endswith(".cpu")}
    assert spec.reader("runtime.offcpu_pct").read(ctx(window)) is None
    assert spec.reader("runtime.offcpu_pct").read(ctx({})) is None

"""A bf16 store with an int8 or f32 sweep mirror (``EngineConfig(dtype="bfloat16",
sweep_dtype="int8" | "float32")``) against the JAX package, on the CPU.

The store keeps what the JAX store keeps: write upkeep quantizes or copies the written
f32 values, a whole rebuild (the first mirror-eligible capacity, a compaction, a page-in)
the stored bf16 rows.  Until a compaction the mirror therefore ranks rows the rescan does
not score.  The JAX certificate carries no term for that gap, and on a near-tie built for
it proves a wrong set; the port measures its bound rows against the stored rows and ranks
with their own norms (ROADMAP C13), and both outputs are asserted below.

The port's kernel wrappers run their plain torch versions on CPU tensors; the JAX side
runs with ``use_pallas=False`` for the store and with its Pallas kernels in interpret mode,
told it runs on a TPU, for the engine.  Inputs are made with numpy from a seed.

Tolerances:
  * data, valid and an f32 mirror: bit-equal to JAX's; sq_norms bit-equal after a
    rebuild (compaction, page-in) and within sqrt(Dp) * 2^-23 relative of the written
    rows' norms before one (another summation order);
  * int8 codes: bit-equal to JAX's (through ``convert.rows_from_sweep_layout``), scales
    equal, error norms within sqrt(Dp) * 2^-23 relative, wherever JAX's arrays come from
    its eager quantizer (a rebuild); rows its jitted write upkeep quantized are held to
    the rule of tests/test_torch_int8.py (scales within 1 ulp, codes equal where they
    are, the second stream's scale within 2^-14 and its codes within one unit);
  * the port's arrays: bit-equal to its own quantizer (or copy) of the values each row
    came from, the written values or the stored rows;
  * searches: id sets equal to JAX's on gaussian data; scores within 1e-4 of a float64
    oracle over the stored bf16 rows with the f32 query; tiers equal to JAX's except
    where C13 diverges (pinned in each test).
"""

import types
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu.ops import pallas_knn_t as J
from mlvectordb_tpu.store.namespace import NamespaceStore as JaxNamespaceStore
from mlvectordb_tpu.store.vector import Vector as JaxVector
from mlvectordb_tpu_torch import EngineConfig, NamespaceStore, QueryProcessor, VectorDTO, convert
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.store.vector import Vector
from mlvectordb_tpu_torch.utils.capacity import plan_capacity

D = 128
TILE = J.SWEEP_TILE
ULP = np.sqrt(D) * 2.0 ** -23
MIRRORS = {"int8": dict(sweep_dtype="int8"),
           "int8_one_stream": dict(sweep_dtype="int8", sweep_resid=False),
           "float32": dict(sweep_dtype="float32")}
_NAMES = {"int8": ("mirror", "sweep_rscale", "sweep_resid", "sweep_rscale2", "sweep_err",
                   "sweep_err1"),
          "int8_one_stream": ("mirror", "sweep_rscale", "sweep_err"),
          "float32": ("mirror",)}


def _cfg(cls, kind, **kw):
    return cls(dtype="bfloat16", initial_capacity=4096, capacity_multiple=4096,
               **MIRRORS[kind], **kw)


def _bf16(x):
    """x rounded to bf16, as f32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _jax_on_tpu(mp):
    """The JAX engine picks its certified sweep only on a TPU: tell it it runs on one (its
    Pallas kernels still run in interpret mode)."""
    mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))


# ------------------------------------------------------------------ the store


def _mine(kind, src):
    """The port's arrays for mirror rows that came from ``src`` [cap, Dp] f32."""
    src = torch.from_numpy(src)
    if kind == "float32":
        return (src,)
    if kind == "int8":
        return T.quantize_int8_resid_rows(src)
    return T.quantize_int8_rows(src)


def _carried(jns):
    """JAX's sweep arrays in the port's row-major layout."""
    opt = lambda a: None if a is None else np.asarray(a)   # noqa: E731
    return convert.sweep_arrays_from_jax(
        np.asarray(jns._data_t), opt(jns._sweep_resid), opt(jns._sweep_err),
        opt(jns._sweep_rscale), opt(jns._sweep_err1), opt(jns._sweep_rscale2), device="cpu")


def _assert_store_matches_jax(kind, jns, tns, src, *, rebuilt, norms_rebuilt=None):
    """Rows and liveness bit-equal to JAX's, norms as the module docstring says
    (``norms_rebuilt``: a compaction computed every one; default ``rebuilt``); the port's
    sweep arrays its own quantizer's (or copy's) of ``src``, each row's source values;
    JAX's arrays equal to them (``rebuilt``: every mirror row came from JAX's eager
    quantizer) or within the jitted upkeep's rule."""
    st = tns.device_state()
    np.testing.assert_array_equal(st.data.float().numpy(), np.asarray(jns._data, np.float32))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(jns._valid))
    got, want = st.sq_norms.numpy(), np.asarray(jns._sq_norms)
    if rebuilt if norms_rebuilt is None else norms_rebuilt:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= ULP * want + 1e-30).all()
    names = _NAMES[kind]
    for name, want in zip(names, _mine(kind, src)):
        assert torch.equal(getattr(st, name), want), name
    assert st.mirror is not st.data and st.mirror.dtype == (
        torch.float32 if kind == "float32" else torch.int8)
    if kind == "float32":
        assert st.sweep_err is st.sweep_resid is st.sweep_rscale is None
    carried = _carried(jns)
    for name in set(carried) - set(names):
        assert carried[name] is None and getattr(st, name) is None, name
    if kind == "float32" or rebuilt:
        for name in names:
            got, want = getattr(st, name).numpy(), carried[name].numpy()
            if name in ("sweep_err", "sweep_err1"):
                assert (np.abs(got - want) <= ULP * np.abs(want) + 1e-30).all(), name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        return
    z1, jz1 = st.mirror.numpy(), carried["mirror"].numpy()
    s1, js1 = st.sweep_rscale.numpy(), carried["sweep_rscale"].numpy()
    assert (np.abs(s1.view(np.int32) - js1.view(np.int32)) <= 1).all()
    flipped = (z1 != jz1).any(1)
    assert not (flipped & (s1 == js1)).any() and (np.abs(z1 - jz1.astype(int)) <= 1).all()
    if kind == "int8":
        same = ~flipped
        s2, js2 = st.sweep_rscale2.numpy()[same], carried["sweep_rscale2"].numpy()[same]
        assert (np.abs(s2 - js2) <= 2.0 ** -14 * js2).all()
        dz2 = np.abs(st.sweep_resid.numpy()[same].astype(int)
                     - carried["sweep_resid"].numpy()[same])
        assert dz2.max() <= 1 and (dz2 != 0).mean() <= 1e-3


@pytest.mark.parametrize("kind", list(MIRRORS))
def test_store_upkeep_and_rebuilds_match_jax(kind):
    """Bulk load at capacity 4096, growth past the first tile, overwrites, deletes below
    and above the compaction ratio, a compaction, writes after it, then offload and
    page-in: at every step the JAX store's arrays.  Upkeep rows come from the written
    values (not the stored rows) and every rebuild from the stored bf16 rows."""
    rng = np.random.default_rng(301 + len(kind))
    jns = JaxNamespaceStore("w", _cfg(JaxConfig, kind, use_pallas=False))
    tns = NamespaceStore("w", _cfg(EngineConfig, kind), device="cpu")
    src = np.zeros((4096, D), np.float32)     # the values each mirror row came from

    def write(vals, vids, single=False):
        for ns, vec in ((jns, JaxVector), (tns, Vector)):
            if single:
                ns.upsert([vec(v, {}, id=i) for v, i in zip(vals, vids)])
            else:
                ns.bulk_upsert(vals, vids)
        nonlocal src
        if tns.capacity > src.shape[0]:
            src = np.concatenate([src, np.zeros((tns.capacity - src.shape[0], D), np.float32)])
        src[[tns._id_to_slot[i] for i in vids]] = vals

    def rebuilt():
        nonlocal src
        src = tns.device_state().data.float().numpy().copy()

    x = rng.standard_normal((3000, D), dtype=np.float32) * 2.0
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    write(x, ids)                                            # bulk load
    assert tns.capacity == jns.capacity == 4096
    _assert_store_matches_jax(kind, jns, tns, src, rebuilt=False)
    # the written values, not the stored rows: the mirror is not a rebuild of the rows
    st = tns.device_state()
    assert not torch.equal(st.mirror, _mine(kind, st.data.float().numpy())[0])
    more = rng.standard_normal((3000, D), dtype=np.float32)
    more_ids = [uuid.UUID(int=i + 10_000) for i in range(len(more))]
    write(more, more_ids)                                    # growth past the first tile
    over = rng.standard_normal((4, D), dtype=np.float32)
    write(over, [ids[i] for i in (5, 17, 2999, 0)], single=True)   # overwrites
    assert tns.capacity == jns.capacity == 8192
    _assert_store_matches_jax(kind, jns, tns, src, rebuilt=False)
    for ns in (jns, tns):
        ns.delete(ids[:500])                                 # below the ratio
    assert tns._tombstones == 500 and tns.capacity == 8192
    _assert_store_matches_jax(kind, jns, tns, src, rebuilt=False)
    for ns in (jns, tns):
        ns.delete(ids[500:2500])                             # above it: compaction
    assert tns._tombstones == 0 and tns.capacity == jns.capacity == 4096
    rebuilt()
    _assert_store_matches_jax(kind, jns, tns, src, rebuilt=True)
    st = tns.device_state()
    assert torch.equal(st.mirror, _mine(kind, st.data.float().numpy())[0])
    late = rng.standard_normal((40, D), dtype=np.float32)
    write(late, [uuid.UUID(int=i + 50_000) for i in range(len(late))])   # upkeep again
    _assert_store_matches_jax(kind, jns, tns, src, rebuilt=False)
    for ns in (jns, tns):
        assert ns.offload() and ns.ensure_resident()        # page-in rebuilds from rows
    rebuilt()
    _assert_store_matches_jax(kind, jns, tns, src, rebuilt=True, norms_rebuilt=False)
    st = tns.device_state()
    arrays = [st.data, st.valid, st.sq_norms] + [getattr(st, n) for n in _NAMES[kind]]
    assert tns.nbytes == sum(t.numel() * t.element_size() for t in arrays)
    vectors = {"int8": 4, "int8_one_stream": 2, "float32": 0}[kind]
    plan = plan_capacity(tns.live_count, D, tns.config)
    assert tns.nbytes == plan.data_bytes + tns.capacity * (5 + 4 * vectors)


# ------------------------------------------------------------------ the engine


def _clustered(seed, n, b, n_centres, spread, noise):
    """tests/test_torch_sweep.py's clustered corpus: tight clusters below the bf16 band."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_centres, D)).astype(np.float32) * spread
    db = centres[rng.integers(0, n_centres, n)] + rng.standard_normal((n, D)).astype(
        np.float32) * noise
    q = centres[rng.integers(0, n_centres, b)] + rng.standard_normal((b, D)).astype(
        np.float32) * noise
    return db.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module", params=list(MIRRORS))
def engines(request):
    """One namespace of 20,000 gaussian rows and one clustered one (12,288 rows, 16
    centres of scale 4, noise 0.02) in the JAX engine and in the port's, both on a bf16
    store with this mirror (tests/test_torch_int8.py's ``engines`` on a bf16 store)."""
    rng = np.random.default_rng(261)
    x = rng.standard_normal((20_000, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, len(x))]
    xc, qc = _clustered(262, 3 * TILE, 16, 16, 4.0, 0.02)
    cfg = dict(dtype="bfloat16", **MIRRORS[request.param])
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_tpu(mp)
        jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
        tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
        for qp in (jqp, tqp):
            qp.bulk_load(x, "ns", ids=ids)
            qp.bulk_load(xc, "c")
        yield request.param, rng, ids, jqp, tqp, qc


def _oracle(tqp, ns, queries, k, metric):
    """Float64 top-k over the stored bf16 rows with the f32 queries: (sorted distances in
    the engine's convention [B, k], index sets)."""
    st = tqp.storage.namespace(ns).device_state()
    b, q = st.data.double().numpy()[:, :D], queries.astype(np.float64)
    dots = q @ b.T
    if metric == "l2":
        d = (q * q).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * dots
    elif metric == "ip":
        d = 1 - dots
    else:
        d = 1 - dots / np.sqrt(np.maximum((q * q).sum(1)[:, None] * (b * b).sum(1)[None],
                                          1e-30))
    d[:, ~st.valid.numpy()] = np.inf
    order = np.argsort(d, 1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), order


def _served(qp, ns, before):
    """The tier counters ``qp`` moved since ``before``."""
    return {t: c - before.get(t, 0) for t, c in qp.cert_tier_counts(ns).items()
            if c != before.get(t, 0)}


def _search(jqp, tqp, queries, k, metric, ns):
    """(JAX's results, port's results, JAX's tiers, port's tiers, port's transfers)."""
    jt, tt, xfer = (dict(jqp.cert_tier_counts(ns)), dict(tqp.cert_tier_counts(ns)),
                    dict(tqp.transfer_counts))
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], k, ns, metric)
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], k, ns, metric)
    moved = (tqp.transfer_counts["h2d"] - xfer["h2d"], tqp.transfer_counts["d2h"] - xfer["d2h"])
    return jr, tr, _served(jqp, ns, jt), _served(tqp, ns, tt), moved


def _scores(res, metric):
    """Sorted distances of each result list in the engine's convention."""
    return np.array([sorted(1 - r["score"] if metric == "cosine" else r["score"] for r in rs)
                     for rs in res])


# (mirror, stage, k, metric) -> (JAX's tier, the port's tier) where they differ on the
# gaussian namespace: the one-stream int8 proof is the tightest, and a bound measured
# against the stored rows (C13) escalates the port's ip k=100 search where JAX's, measured
# against the written values, certifies (both answers are the exact set); at cosine
# k=100 both escalate, and JAX's scan ranks bf16(q) with the written rows' norms, a set
# off the stored rows' exact one, where the port's scan scores them as its rescan does
GAUSSIAN_PINS = {("int8_one_stream", "after", 100, "ip"): ("fast", "exact_scan")}
GAUSSIAN_JAX_OFF = {("int8_one_stream", "after", 100, "cosine")}


def test_engine_gaussian_matches_jax_before_and_after_deletes(engines):
    """l2, ip and cosine at k=10 and 100 over 16 queries, before and after 300 deletes:
    the port's sets are the float64 oracle's over the stored rows and JAX's; tiers are
    JAX's (C13's pins apart); tier 0 is one copy each way; no light_ tier."""
    kind, rng, ids, jqp, tqp, _ = engines
    queries = rng.standard_normal((16, D), dtype=np.float32)
    gone = [ids[i] for i in rng.choice(len(ids), 300, replace=False)]
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_tpu(mp)
        for stage in ("before", "after"):
            if stage == "after":
                assert (sorted(map(str, jqp.delete(gone, "ns")))
                        == sorted(map(str, tqp.delete(gone, "ns"))))
            for k in (10, 100):
                for metric in ("l2", "ip", "cosine"):
                    key = (kind, stage, k, metric)
                    jr, tr, jt, tt, xfer = _search(jqp, tqp, queries, k, metric, "ns")
                    want_d, want_i = _oracle(tqp, "ns", queries, k, metric)
                    slots = [{tqp.storage.namespace("ns")._id_to_slot[r["id"]] for r in rs}
                             for rs in tr]
                    assert slots == [set(o.tolist()) for o in want_i], key
                    np.testing.assert_allclose(_scores(tr, metric), want_d, rtol=1e-4,
                                               atol=1e-4)
                    same = [{r["id"] for r in a} == {r["id"] for r in b}
                            for a, b in zip(jr, tr)]
                    assert all(same) == (key not in GAUSSIAN_JAX_OFF), key
                    pin = GAUSSIAN_PINS.get(key)
                    assert (jt, tt) == (({pin[0]: 1}, {pin[1]: 1}) if pin else (jt, jt)), key
                    assert xfer == (1, 1) if tt == {"fast": 1} else xfer[0] == 1
    assert not any(t.startswith("light_") for t in tqp.cert_tier_counts("ns"))
    assert tqp._cert_mode == {}


# the clustered namespace: (JAX's tiers, the port's tiers) per metric at k=10.  Its rows
# round to a few bf16 points per cluster, so the written values and the stored rows
# rank differently: JAX's answers (its tier 0 on ip over an f32 or two-stream int8
# mirror, its scan elsewhere) are off the stored rows' exact distances, the port's
# escalate to its scan, which scores the stored rows as its rescan does (C13)
CLUSTERED_TIERS = {
    "float32": {"l2": ("exact_scan", "exact_scan"), "ip": ("fast", "exact_scan"),
                "cosine": ("exact_scan", "exact_scan")},
    "int8": {"l2": ("exact_scan", "exact_scan"), "ip": ("fast", "exact_scan"),
             "cosine": ("exact_scan", "exact_scan")},
    "int8_one_stream": {"l2": ("exact_scan", "exact_scan"), "ip": ("exact_scan", "exact_scan"),
                        "cosine": ("exact_scan", "exact_scan")},
}


def test_engine_clustered_is_exact_over_the_stored_rows(engines):
    """Tight clusters: the port's sorted distances equal the float64 oracle's over the
    stored rows within f32 rounding (1e-4 relative + 1e-4 + 16 ulps of the products'
    scale: |q|^2 + max |row|^2 for l2, |q| max |row| for ip), JAX's do not (ROADMAP
    C13); the tiers are pinned."""
    kind, _, _, jqp, tqp, qc = engines
    xc = tqp.storage.namespace("c").device_state().data.float().numpy()
    qn, xn = (qc * qc).sum(-1), (xc * xc).sum(-1).max()
    scale = {"l2": qn + xn, "ip": np.sqrt(qn * xn), "cosine": 0 * qn}
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_tpu(mp)
        for metric in ("l2", "ip", "cosine"):
            jr, tr, jt, tt, _ = _search(jqp, tqp, qc, 10, metric, "c")
            want, _ = _oracle(tqp, "c", qc, 10, metric)
            atol = (1e-4 + 16 * 2.0 ** -24 * scale[metric])[:, None]
            assert (np.abs(_scores(tr, metric) - want) <= 1e-4 * np.abs(want) + atol).all()
            assert not (np.abs(_scores(jr, metric) - want) <= 1e-4 * np.abs(want) + atol).all()
            j, t = CLUSTERED_TIERS[kind][metric]
            assert (jt, tt) == ({j: 1}, {t: 1}), metric
    assert not any(t.startswith("light_") for t in tqp.cert_tier_counts("c"))


def test_engine_bytes_match_the_capacity_plan(engines):
    """``nbytes`` of each namespace: the rows at 2 B, the mirror at its own width (an f32
    tensor of its own, or one or two int8 code streams), liveness, norms and the per-row
    vectors; ``plan_capacity`` counts the same bytes per element."""
    kind, _, _, _, tqp, _ = engines
    for name in ("ns", "c"):
        ns = tqp.storage.namespace(name)
        st = ns.device_state()
        per_row = sum(getattr(st, n).numel() for n in _NAMES[kind] if n != "mirror"
                      and getattr(st, n).dim() == 1) * 4
        plan = plan_capacity(ns.live_count, D, tqp.config)
        assert plan.dim_padded == ns.dpad
        assert ns.nbytes == plan.data_bytes + ns.capacity * 5 + per_row
        width = {"int8": 2, "int8_one_stream": 1, "float32": 4}[kind]
        assert ns.nbytes == ns.capacity * (D * (2 + width) + 5) + per_row


# ------------------------------------------------------------------ ROADMAP C13


def _near_tie(metric):
    """C2's construction for these mirrors: row A is written just under half an ulp off
    its bf16 row, each element rounding the way that ranks its written value worse (l2:
    1.5 + d, at distance 32 from the all-ones query over the stored rows and 32.49 as
    written; ip: 1.5 - d; cosine: 1.5 + d in its first half, 1.0 - d/2 in its second, its
    direction turned off the query's); 16 decoys one per window rank between its stored
    and its written value, 24 more just better than the written one; the other rows are
    far (ip, cosine: pointing away)."""
    rng = np.random.default_rng(0)
    n = 2 * TILE
    x = (rng.standard_normal((n, D)) + 8).astype(np.float32)
    q = np.ones(D, np.float32)
    a_row, dev = 100, np.float32(2.0 ** -8 - 2.0 ** -14)
    decoys = list(range(1000, 1000 + 40 * 64, 64))
    steps = [7 + i if i < 16 else 30 for i in range(len(decoys))]
    if metric == "cosine":
        x[a_row, : D // 2], x[a_row, D // 2 :] = np.float32(1.5) + dev, np.float32(1.0) - dev / 2
        for r, m in zip(decoys, [m - 2 for m in steps]):
            x[r, : D // 2], x[r, D // 2 :] = 1.5, 1.0
            x[r, 0] = np.float32(1.5 + m / 128)      # a longer row: its direction turns
    else:
        sign = 1 if metric == "l2" else -1
        x[a_row] = np.float32(1.5) + sign * dev
        for i, (r, m) in enumerate(zip(decoys, steps)):
            x[r] = 1.5
            x[r, i % D] = np.float32(1.5 + sign * m / 128)
    if metric != "l2":
        far = np.ones(n, bool)
        far[[a_row] + decoys] = False
        x[far] -= 16
    return x, q, a_row, decoys


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("kind", list(MIRRORS))
def test_certificate_covers_the_written_values_gap(kind, metric):
    """A bf16 store before any compaction: JAX ranks row A by its written value and
    proves a set without it (at tier 0, or through its scan, which ranks bf16(q) with the
    written norms, where the one-stream int8 band fails the proof), a wrong set over the
    stored rows.  The port's bound rows measure the mirror against the
    stored rows and its scan scores them as its rescan does: the exact set comes back, A
    first, at JAX's tier.  After a compaction (the mirror rebuilt from the rows) JAX's
    plan holds and both return the exact set."""
    x, q, a_row, decoys = _near_tie(metric)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    b = _bf16(x).astype(np.float64)
    dist = {"l2": lambda: ((b - q) ** 2).sum(1), "ip": lambda: -(b @ q),
            "cosine": lambda: -(b @ q) / np.sqrt((b * b).sum(1))}[metric]()
    want = set(np.argsort(dist, kind="stable")[:10].tolist())
    assert a_row in want and np.sort(dist)[10] > np.sort(dist)[9]
    cfg = dict(dtype="bfloat16", **MIRRORS[kind])
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_tpu(mp)
        jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
        tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
        for qp in (jqp, tqp):
            qp.bulk_load(x, "ns", ids=ids)
        # the one-stream int8 band fails every l2 and cosine proof here, in both packages
        tier = "exact_scan" if kind == "int8_one_stream" and metric != "ip" else "fast"
        for stage in ("written values", "compacted"):
            if stage == "compacted":
                for qp in (jqp, tqp):
                    with qp._write_lock:
                        qp.storage.namespace("ns").compact()
            jt, tt = dict(jqp.cert_tier_counts("ns")), dict(tqp.cert_tier_counts("ns"))
            jr = jqp.find_similar_batch([JaxDTO(q)], 10, "ns", metric)[0]
            tr = tqp.find_similar_batch([VectorDTO(q)], 10, "ns", metric)[0]
            jax_set = {r["id"].int - 1 for r in jr}
            port_set = {r["id"].int - 1 for r in tr}
            assert port_set == want and tr[0]["id"] == ids[a_row], stage
            assert _served(tqp, "ns", tt) == {tier: 1}, stage
            assert _served(jqp, "ns", jt) == {tier: 1}, stage
            if stage == "written values":
                assert a_row not in jax_set and jax_set != want    # the reference
            else:
                assert jax_set == want
            st = tqp.storage.namespace("ns").device_state()
            bound = [p["eb_rows"][0] for key, p in st.prep_cache.items() if key != "zero_query"]
            assert len(bound) == 1
            # search_prep gives the engine's prep when it is handed the stored rows
            mine = T.search_prep(st.mirror, st.valid, st.sq_norms, metric=metric,
                                 live_prefix=st.high_water, sweep_err=st.sweep_err,
                                 resid=st.sweep_resid, rscale=st.sweep_rscale,
                                 err1=st.sweep_err1, rscale2=st.sweep_rscale2, rows=st.data)
            assert torch.equal(mine["eb_rows"][0], bound[0])
            assert torch.equal(mine["rank_norms"], T.row_sq_norms(st.data))
            with pytest.raises(ValueError, match="needs the rows"):
                T.search_prep(st.mirror, st.valid, st.sq_norms, metric=metric,
                              live_prefix=st.high_water, rescan_dtype=torch.bfloat16)
            if kind == "float32":   # ||stored row - mirror row||: zero for bf16-exact rows
                assert float(bound[0][decoys[0]]) == 0.0
                assert (float(bound[0][a_row]) > 0.0) == (stage == "written values")


# ------------------------------------------------------------------ the mesh


@pytest.fixture(scope="module")
def mesh_rows():
    """65,536 bf16 rows x 128 (their f32 widening, the norms of the stored rows) and 8
    queries: 8,192 rows a shard on (1, 8), 16,384 on (2, 4)."""
    rng = np.random.default_rng(17)
    db = _bf16(rng.standard_normal((65536, D), dtype=np.float32))
    q = rng.standard_normal((8, D), dtype=np.float32)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    valid = rng.random(65536) > 0.05
    return db, q, sq, valid


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
def test_sharded_knn_f32_mirror_of_bf16_rows_matches_jax(mesh_rows, mesh, metric):
    """``sharded_knn`` over bf16 shards with an f32 mirror of their rows (a rebuilt
    mirror) against JAX's on its 8-device CPU mesh: JAX's distances within its own
    tolerance (tests/test_parallel.py:66) and its id sets."""
    import jax
    import jax.numpy as jnp
    from mlvectordb_tpu.parallel import ShardingManager as JShardingManager
    from mlvectordb_tpu.parallel import build_mesh as jbuild_mesh
    from mlvectordb_tpu_torch.parallel import ShardingManager, build_mesh

    db, q, sq, valid = mesh_rows
    jsm = JShardingManager(jbuild_mesh(*mesh))
    data, v, n = jsm.place_database(jnp.asarray(db, jnp.bfloat16), jnp.asarray(valid),
                                    jnp.asarray(sq))
    dt = jax.device_put(J.to_sweep_layout(data, dtype=jnp.float32,
                                          shard_cap=db.shape[0] // jsm.n_shards),
                        jsm.db_sharding_2d_t())
    jd, ji = jsm.sharded_knn(jnp.asarray(q), data, v, n, dt, k=5, metric=metric)
    sm = ShardingManager(build_mesh(*mesh, devices=[torch.device("cpu")] * 8))
    rows = torch.from_numpy(db).to(torch.bfloat16)
    shards = sm.place_database(rows, torch.from_numpy(valid), torch.from_numpy(sq),
                               rows.float())
    assert shards[0][0].mirror.dtype == torch.float32 and shards[0][0].data.dtype == rows.dtype
    d, i = sm.sharded_knn(torch.from_numpy(q), shards, k=5, metric=metric)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=2e-4, atol=2e-4)
    assert [set(r) for r in i.tolist()] == [set(r) for r in np.asarray(ji).tolist()]


@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_sharded_store_keeps_jaxs_mirror_per_cell(kind):
    """A (2, 4) distributed processor on a bf16 store: under an f32 sweep each cell keeps
    an f32 mirror of its own (write upkeep: the written values; growth by zero rows;
    page-in: the rows widened), under int8 none (the masked row-major kernel per shard,
    as in the JAX package); its answers are JAX's distributed processor's and the float64
    oracle's over the stored rows, before and after a delete."""
    from mlvectordb_tpu.parallel import make_distributed_processor as jmake
    from mlvectordb_tpu_torch.parallel import make_distributed_processor

    rng = np.random.default_rng(31)
    # a first capacity below a tile a shard: the JAX store raises on the first int8 write
    # otherwise (test_sharded_int8_first_capacity_divergence)
    kw = dict(dtype="bfloat16", sweep_dtype=kind, initial_capacity=1024,
              capacity_multiple=1024, db_tile=64, query_buckets=(8, 64), k_buckets=(8, 32),
              use_pallas=False)
    qp = make_distributed_processor(2, 4, EngineConfig(**kw), devices=[torch.device("cpu")] * 8)
    jqp = jmake(2, 4, JaxConfig(**kw))
    rows = rng.standard_normal((200, 16)).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(rows))]
    bulk = rng.standard_normal((18000, 16)).astype(np.float32)
    bulk_ids = [uuid.UUID(int=i + 10**6) for i in range(len(bulk))]
    for p, dto in ((qp, VectorDTO), (jqp, JaxDTO)):
        p.upsert_many([dto(r, {"i": i}, id=v) for i, (r, v) in enumerate(zip(rows, ids))],
                      "ns")
        p.bulk_load(bulk, "ns", ids=bulk_ids)
    ns, jns = qp.storage.namespace("ns"), jqp.storage.namespace("ns")
    assert ns.shard_capacity == jns.shard_capacity > 4096

    def check_cells(written):
        """``written``: the ids whose mirror rows hold their written values (the rest:
        their stored rows, widened)."""
        for row in ns.device_state().shards:
            for s, cell in enumerate(row):
                if kind == "int8":
                    assert cell.mirror is None and cell.sweep_err is None
                    continue
                assert cell.mirror.dtype == torch.float32 and cell.mirror is not cell.data
                assert cell.sweep_err is None
                want = cell.data.float().clone()
                for vid in written:
                    slot = ns._id_to_slot[vid]
                    if slot // ns.shard_capacity == s:
                        want[slot % ns.shard_capacity, :16] = torch.from_numpy(
                            ns._slot_values[slot])
                assert torch.equal(cell.mirror, want)

    # the first eligible capacity came with the bulk load: the mirror was built from the
    # rows then (the first 200 ids'), the bulk load's own rows written after it
    check_cells(written=bulk_ids)
    assert ns.offload() and ns.ensure_resident()
    check_cells(written=())
    for p in (qp, jqp):
        p.delete(ids[:3], "ns")
    q = rng.standard_normal((5, 16)).astype(np.float32)
    live = sorted(ns._id_to_slot.items(), key=lambda kv: kv[1])
    b = np.stack([_bf16(ns._slot_values[s]) for _, s in live]).astype(np.float64)
    for metric in ("l2", "cosine"):
        got = qp.find_similar_batch([VectorDTO(v) for v in q], 5, "ns", metric)
        want = jqp.find_similar_batch([JaxDTO(v) for v in q], 5, "ns", metric)
        dots = q.astype(np.float64) @ b.T
        d = ((q * q).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * dots if metric == "l2"
             else -dots / np.sqrt((b * b).sum(1))[None])
        oracle = [{live[j][0] for j in np.argsort(r, kind="stable")[:5]} for r in d]
        assert [{r["id"] for r in rs} for rs in got] == oracle
        assert [{r["id"] for r in rs} for rs in want] == oracle
        np.testing.assert_allclose([r["score"] for rs in got for r in rs],
                                   [r["score"] for rs in want for r in rs],
                                   rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ carry-over, durability


def _filled(kind, n=9000):
    """A JAX and a port processor of this bf16-store config holding the same writes:
    a bulk load, 50 overwrites at half scale, 300 deletes (no compaction)."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((n, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, n)]
    cfg = dict(dtype="bfloat16", **MIRRORS[kind])
    jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    for qp, dto in ((jqp, JaxDTO), (tqp, VectorDTO)):
        qp.bulk_load(x, "ns", ids=ids)
        qp.upsert_many([dto(x[i] * 0.5, {"over": i}, id=ids[i]) for i in range(50)], "ns")
        qp.delete(ids[1000:1300], "ns")
    return jqp, tqp, rng.standard_normal((8, D), dtype=np.float32), cfg


def _assert_answers_equal(jqp, tqp, queries):
    for metric in ("l2", "ip", "cosine"):
        jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], 10, "ns", metric)
        tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], 10, "ns", metric)
        assert [{r["id"] for r in a} for a in jr] == [{r["id"] for r in b} for b in tr]
        np.testing.assert_allclose(_scores(tr, metric), _scores(jr, metric), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("kind", list(MIRRORS))
def test_carry_over_and_snapshots_in_both_packages(tmp_path, kind):
    """``convert.store_from_jax_snapshot`` of a JAX store of this config, and each
    package's snapshot loaded by the other: the same rows, a mirror built from the
    snapshot's values (the stored bf16 rows, through ``bulk_upsert``), the same answers
    as JAX's loaded store, at tier 0."""
    from mlvectordb_tpu.engine.persist import load_storage as jax_load_storage

    jqp, tqp, queries, cfg = _filled(kind)
    jns = jqp.storage.namespace("ns")
    snap = jns.snapshot_arrays()
    carried = convert.store_from_jax_snapshot(snap, EngineConfig(**cfg), "cpu")
    st = carried.device_state()
    n = len(snap["ids"])
    assert carried.capacity == jns.capacity == 16384 and n == 8700
    np.testing.assert_array_equal(st.data[:n].float().numpy(), snap["values"])
    assert torch.equal(st.mirror, _mine(kind, st.data.float().numpy())[0])
    jqp.save(str(tmp_path / "jax"))
    tqp.save(str(tmp_path / "port"))
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_tpu(mp)
        for snap in ("jax", "port"):
            jl = JaxQueryProcessor(jax_load_storage(str(tmp_path / snap), JaxConfig(**cfg)),
                                   JaxConfig(**cfg))
            tl = QueryProcessor.load(str(tmp_path / snap), EngineConfig(**cfg), device="cpu")
            lst = tl.storage.namespace("ns").device_state()
            np.testing.assert_array_equal(
                lst.data.float().numpy(), np.asarray(jl.storage.namespace("ns")._data, np.float32))
            assert torch.equal(lst.mirror, _mine(kind, lst.data.float().numpy())[0])
            _assert_answers_equal(jl, tl, queries)
            assert tl.cert_tier_counts("ns") == jl.cert_tier_counts("ns") == {"fast": 3}


@pytest.mark.parametrize("kind", list(MIRRORS))
def test_wal_replay_gives_jaxs_store(tmp_path, kind):
    """A log the port wrote (a bulk load, overwrites, deletes) replayed by both packages:
    the JAX store's rows and mirror, whose rows come from the logged values (write
    upkeep; a deleted row keeps its last one), and the same answers."""
    cfg = dict(dtype="bfloat16", **MIRRORS[kind])
    rng = np.random.default_rng(43)
    log = str(tmp_path / "wal")
    src = QueryProcessor(EngineConfig(**cfg), device="cpu")
    src.enable_wal(log)
    x = rng.standard_normal((9000, D), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    src.bulk_load(x, "ns", ids=ids)
    src.upsert_many([VectorDTO(x[i] * 0.5, None, id=ids[i]) for i in range(20)], "ns")
    src.delete(ids[100:400], "ns")
    jqp = JaxQueryProcessor(config=JaxConfig(**cfg, use_pallas=False))
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    assert tqp.replay_wal(log) == jqp.replay_wal(log) == 3
    jns, tns = jqp.storage.namespace("ns"), tqp.storage.namespace("ns")
    assert tns._id_to_slot == jns._id_to_slot and tns._id_to_slot[ids[500]] == 500
    written = np.zeros((tns.capacity, D), np.float32)   # slot i holds ids[i]'s values
    written[: len(x)] = x
    written[:20] *= 0.5
    _assert_store_matches_jax(kind, jns, tns, written, rebuilt=False)
    queries = rng.standard_normal((8, D), dtype=np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _jax_on_tpu(mp)
        served = JaxQueryProcessor(config=JaxConfig(**cfg))
        assert served.replay_wal(log) == 3
        _assert_answers_equal(served, tqp, queries)


def test_sharded_int8_first_capacity_divergence():
    """A (1, 2) distributed processor under ``sweep_dtype="int8"`` whose first capacity
    already holds a tile a shard (ROADMAP C14): the JAX store allocates an int8 mirror
    without its scales and raises on the first write; the port keeps every cell
    mirror-less (the masked kernel per shard, as JAX's store is at any other capacity)
    and serves the write and the search."""
    from mlvectordb_tpu.parallel import make_distributed_processor as jmake
    from mlvectordb_tpu_torch.parallel import make_distributed_processor

    kw = dict(dtype="bfloat16", sweep_dtype="int8", initial_capacity=8192,
              capacity_multiple=4096, use_pallas=False)
    rows = np.random.default_rng(5).standard_normal((10, 16)).astype(np.float32)
    jqp = jmake(1, 2, JaxConfig(**kw))
    with pytest.raises(AttributeError):
        jqp.bulk_load(rows, "ns")
    qp = make_distributed_processor(1, 2, EngineConfig(**kw), devices=[torch.device("cpu")] * 2)
    qp.bulk_load(rows, "ns", ids=[uuid.UUID(int=i + 1) for i in range(10)])
    ns = qp.storage.namespace("ns")
    assert ns.shard_capacity % 4096 == 0
    assert all(c.mirror is None for row in ns.device_state().shards for c in row)
    assert qp.find_similar(VectorDTO(rows[3]), top_k=1, namespace="ns")[0]["id"] == uuid.UUID(int=4)

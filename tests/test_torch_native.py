"""The port's native host runtime (mlvectordb_tpu_torch.native): the columnar
metadata-filter evaluator (native/metafilter.cpp) and the hydration extension
(native/hydrate.c), built by the port's loader into build/native/.

The cases of tests/test_native.py against the port's loader: masks bit-identical to the
Python evaluator over curated and randomized metadata and specs, overwrite, clear and
resize, and the hydration extension's rows identical to the pure-Python hydration,
delete-after-snapshot drops included.  Beside them: the port's masks equal the JAX
package's, the engine's answers are the same with and without the native layer, and the
loader builds into build/native/ (never native/build/) safely from several builders at
once.
"""

import ctypes
import os
import random
import threading
import uuid
from unittest import mock

import numpy as np
import pytest

from mlvectordb_tpu import filters as jax_filters
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.filters import FilterMaskCache, matches_filter

native = pytest.importorskip("mlvectordb_tpu_torch.native")
if not native.available():  # pragma: no cover
    pytest.skip("native metafilter not buildable here", allow_module_level=True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_store(metas):
    mc = native.MetaColumns(len(metas))
    for i, m in enumerate(metas):
        assert mc.set(i, m)
    return mc


def check(metas, spec, allow_fallback=False):
    mc = make_store(metas)
    got = mc.eval(spec)
    if got is None:
        # the native grammar rejects some Python-only semantics (sequence ordering):
        # callers fall back to matches_filter
        assert allow_fallback, f"native unexpectedly failed to parse {spec}"
        return
    want = np.asarray([matches_filter(m or {}, spec) for m in metas])
    np.testing.assert_array_equal(got, want)


METAS = [
    {},
    {"color": "red", "n": 5},
    {"color": "blue", "n": 2.5, "active": True},
    {"color": "red", "n": -1, "active": False},
    {"n": True},          # bool/number interop: True == 1
    {"n": 0},
    {"n": None},
    {"tag": "zebra"},
    {"tag": "apple", "n": 5},
    {"nested": {"a": {"b": 3}}, "arr": [1, 2, {"x": None}]},
    {"nested": {"a": {"b": "s"}}},
    {"mixed": "5"},       # string "5" vs number 5: never equal
    {"mixed": 5},
]

SPECS = [
    {"color": "red"},
    {"color": {"$ne": "red"}},
    {"n": {"$gt": 0}},
    {"n": {"$gte": 2.5}},
    {"n": {"$lt": 5}},
    {"n": {"$lte": True}},
    {"n": 1},                      # matches {"n": True}
    {"n": {"$in": [5, 2.5, "x"]}},
    {"n": {"$nin": [5]}},
    {"n": {"$exists": True}},
    {"n": {"$exists": False}},
    {"n": None},
    {"tag": {"$gt": "m"}},         # string ordering
    {"tag": {"$lt": "m"}},
    {"mixed": {"$gt": 3}},         # "5" > 3 -> TypeError -> False; 5 > 3 -> True
    {"mixed": "5"},
    {"nested.a.b": 3},
    {"nested.a.b": {"$gte": 3}},
    {"nested.a": {"b": 3}},        # complex-value equality via canonical JSON
    {"arr": [1, 2, {"x": None}]},
    {"$and": [{"color": "red"}, {"n": {"$gt": 0}}]},
    {"$or": [{"color": "blue"}, {"tag": "zebra"}]},
    {"$not": {"color": "red"}},
    {"$or": [{"$and": [{"n": {"$gte": 0}}, {"n": {"$lt": 3}}]},
             {"$not": {"n": {"$exists": True}}}]},
    {"color": "red", "n": {"$gt": 0, "$lt": 10}},
    {},
]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s)[:50] for s in SPECS])
def test_parity_on_curated_cases(spec):
    check(METAS, spec)


def test_parity_randomized():
    rnd = random.Random(42)
    fields = ["a", "b", "c", "d.e"]
    values = [0, 1, -3.5, True, False, None, "x", "y", "long string", [1, 2], {"k": 1}]
    ops = ["$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in", "$nin", "$exists"]

    def rand_meta():
        m = {}
        for f in rnd.sample(["a", "b", "c"], rnd.randint(0, 3)):
            m[f] = rnd.choice(values)
        if rnd.random() < 0.3:
            m["d"] = {"e": rnd.choice(values[:9])}
        return m

    def rand_leaf():
        f = rnd.choice(fields)
        op = rnd.choice(ops)
        if op == "$exists":
            return {f: {"$exists": rnd.choice([True, False])}}
        if op in ("$in", "$nin"):
            return {f: {op: rnd.sample(values[:9], rnd.randint(0, 3))}}
        return {f: {op: rnd.choice(values)}}

    def rand_spec(depth=0):
        r = rnd.random()
        if depth < 2 and r < 0.25:
            return {"$and": [rand_spec(depth + 1) for _ in range(rnd.randint(1, 3))]}
        if depth < 2 and r < 0.45:
            return {"$or": [rand_spec(depth + 1) for _ in range(rnd.randint(1, 3))]}
        if depth < 2 and r < 0.55:
            return {"$not": rand_spec(depth + 1)}
        return rand_leaf()

    metas = [rand_meta() for _ in range(80)]
    for _ in range(150):
        check(metas, rand_spec(), allow_fallback=True)


def test_clear_and_overwrite():
    mc = native.MetaColumns(4)
    mc.set(0, {"a": 1})
    mc.set(1, {"a": 2})
    assert mc.eval({"a": 1}).tolist() == [True, False, False, False]
    mc.set(0, {"b": 9})  # overwrite wipes previous fields
    assert mc.eval({"a": 1}).tolist() == [False, False, False, False]
    assert mc.eval({"b": 9}).tolist() == [True, False, False, False]
    mc.clear(1)
    assert mc.eval({"a": {"$exists": True}}).tolist() == [False, False, False, False]


def test_resize_preserves_data():
    mc = native.MetaColumns(2)
    mc.set(0, {"a": 1})
    mc.resize(8)
    mc.set(5, {"a": 1})
    assert mc.eval({"a": 1}).tolist() == [True, False, False, False, False, True, False, False]


def test_unknown_operator_returns_none():
    mc = make_store([{"a": 1}])
    assert mc.eval({"a": {"$regex": "x"}}) is None


def test_set_many_matches_individual_sets():
    metas = [{"i": i, "grp": "x" if i % 2 else "y"} for i in range(10)]
    a = native.MetaColumns(10)
    assert a.set_many(list(range(10)), metas)
    b = make_store(metas)
    for spec in ({"grp": "x"}, {"i": {"$gte": 5}}, {"i": 3}):
        np.testing.assert_array_equal(a.eval(spec), b.eval(spec))


# ------------------------------------------------------------------ the store and engine


def _store_with_columns(n=300, seed=3):
    rng = np.random.default_rng(seed)
    tqp = QueryProcessor(EngineConfig(initial_capacity=64, capacity_multiple=32),
                         device="cpu")
    vs = tqp.upsert_many(
        [VectorDTO(rng.standard_normal(8).astype(np.float32),
                   {"i": i, "odd": bool(i % 2), "tag": ["a", "b", "c"][i % 3]})
         for i in range(n)], "ns")
    return rng, tqp, vs


def test_store_columns_follow_writes_growth_deletes_and_compaction():
    """The namespace's columns are kept in step with upsert, bulk_upsert, growth
    (resize), delete and compaction: the native mask equals the Python one after each."""
    rng, tqp, vs = _store_with_columns(n=40)      # capacity 64
    ns = tqp.storage.namespace("ns")
    specs = ({"odd": True}, {"tag": {"$in": ["a", "c"]}}, {"i": {"$lt": 50}}, {"new": 1})

    def same():
        assert ns.meta_columns is not None
        for spec in specs:
            want = np.zeros(ns.capacity, bool)
            for slot, _vid, meta in ns.iter_slots():
                want[slot] = matches_filter(meta or {}, spec)
            np.testing.assert_array_equal(ns.meta_columns.eval(spec, ns.capacity), want)

    same()
    tqp.bulk_load(rng.standard_normal((100, 8)).astype(np.float32), "ns",
                  metadatas=[{"i": 100 + i, "new": 1} for i in range(100)])
    assert ns.capacity > 64 and ns.meta_columns.capacity == ns.capacity   # grown
    same()
    tqp.upsert_many([VectorDTO(vs[3].values, {"odd": False, "new": 1}, id=vs[3].id)], "ns")
    same()
    tqp.delete([v.id for v in vs[:30]], "ns")     # past the threshold: compacts
    assert ns._tombstones == 0
    same()
    assert ns.slot_metadata(0) == ns.iter_slots()[0][2] and ns.slot_to_id(10**6) is None


def test_masks_equal_the_jax_package_masks():
    """The port's FilterMaskCache over the port's store equals the JAX package's over
    its own store, natively and on the Python branch."""
    from mlvectordb_tpu.config import EngineConfig as JaxConfig
    from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
    from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO

    rng = np.random.default_rng(9)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    metas = [{"i": i, "t": ["a", "b"][i % 2], "d": {"e": i % 7}} for i in range(200)]
    jqp = JaxQueryProcessor(config=JaxConfig(initial_capacity=64, capacity_multiple=32,
                                             use_pallas=False))
    tqp = QueryProcessor(EngineConfig(initial_capacity=64, capacity_multiple=32),
                         device="cpu")
    ids = [uuid.UUID(int=i + 1) for i in range(200)]
    jqp.upsert_many([JaxDTO(v, m, id=i) for v, m, i in zip(x, metas, ids)], "ns")
    tqp.upsert_many([VectorDTO(v, m, id=i) for v, m, i in zip(x, metas, ids)], "ns")
    for qp in (jqp, tqp):
        qp.delete(ids[::9], "ns")
    jns, tns = jqp.storage.namespace("ns"), tqp.storage.namespace("ns")
    specs = [{"t": "a"}, {"d.e": {"$gte": 3}}, {"$or": [{"i": 5}, {"t": {"$ne": "a"}}]}]
    for spec in specs:
        live = np.zeros(tns.capacity, bool)
        live[[s for s, _, _ in tns.iter_slots()]] = True
        jm = jax_filters.FilterMaskCache().mask_for(jns, spec)
        tm = FilterMaskCache().mask_for(tns, spec)
        np.testing.assert_array_equal(tm & live, jm & live)
        tns_py = mock.patch.object(tns, "meta_columns", None)
        with tns_py:
            np.testing.assert_array_equal(FilterMaskCache().mask_for(tns, spec) & live,
                                          tm & live)


def test_engine_uses_native_mask():
    """Through the stack: hybrid results identical whether or not the native evaluator
    serves the namespace."""
    rng, tqp, _ = _store_with_columns(n=40)
    ns = tqp.storage.namespace("ns")
    assert ns.meta_columns is not None
    calls = []
    real = ns.meta_columns.eval
    ns.meta_columns.eval = lambda *a, **kw: calls.append(a) or real(*a, **kw)
    q = VectorDTO(rng.standard_normal(8).astype(np.float32))
    native_res = tqp.find_similar(q, top_k=40, namespace="ns", filter={"odd": True})
    assert len(calls) == 1
    ns.meta_columns = None  # the Python branch; a fresh mask cache
    tqp._filter_masks._cache.clear()
    tqp._result_cache.clear()
    python_res = tqp.find_similar(q, top_k=40, namespace="ns", filter={"odd": True})
    assert [r["id"] for r in native_res] == [r["id"] for r in python_res]
    assert len(native_res) == 20
    assert ([v.id for v in tqp.storage.query_by_metadata({"tag": "b"}, "ns")]
            == [v.id for v in tqp.get_namespace_vectors("ns") if v.metadata["tag"] == "b"])


# ------------------------------------------------------------------ _hydrate extension


def test_hydrate_build_nested_parity_and_isolation():
    """build_nested (the engine's hydration) builds the rows the pure-Python hydration
    builds, per query and in order, from list or numpy inputs; copies metadata (mutating
    a result cannot leak into the store's tables), aliases values, and drops hits past
    the mask's half, outside the tables or nulled by a delete-after-snapshot."""
    mod = native.hydrate_module()
    assert mod is not None
    n_slots = 32
    ids = [uuid.uuid4() for _ in range(n_slots)]
    vals = [np.arange(4, dtype=np.float32) + i for i in range(n_slots)]
    metas = [{"i": i} if i % 3 == 0 else ({} if i % 3 == 1 else None)
             for i in range(n_slots)]
    slots = [[5, 0, 9], [31, 5, 2]]
    scores = [[0.5, 1.0, -2.0], [3.25, 0.0, 7.0]]
    dists = [[0.1, 0.2, 0.3], [0.4, 0.5, 2e38]]          # the last one past half MASKED
    half = 1.5e38

    def python_rows(ids_):
        return [[{"id": ids_[s], "values": vals[s],
                  "metadata": dict(m) if (m := metas[s]) else {}, "score": sc}
                 for s, sc, d in zip(sr, cr, dr) if d < half and ids_[s] is not None]
                for sr, cr, dr in zip(slots, scores, dists)]

    for sdt, fdt in ((np.int32, np.float32), (np.int64, np.float64)):
        got = mod.build_nested(ids, vals, metas, np.asarray(slots, sdt).reshape(-1),
                               np.asarray(scores, fdt).reshape(-1),
                               np.asarray(dists, fdt).reshape(-1), half, 2, 3)
        want = python_rows(ids)
        assert [[r["id"] for r in q] for q in got] == [[r["id"] for r in q] for q in want]
        assert [[r["metadata"] for r in q] for q in got] == [
            [r["metadata"] for r in q] for q in want]
        assert [r["score"] for q in got for r in q] == pytest.approx(
            [r["score"] for q in want for r in q])
        assert all(r["values"] is w["values"] for q, wq in zip(got, want)
                   for r, w in zip(q, wq))
    got[0][0]["metadata"]["injected"] = True
    assert "injected" not in (metas[5] or {})
    assert got[0][0]["metadata"] is not got[1][1]["metadata"]
    ids[9] = None                                   # deleted after the snapshot
    got = mod.build_nested(ids, vals, metas, np.asarray(slots, np.int32).reshape(-1),
                           np.asarray(scores, np.float32).reshape(-1),
                           np.asarray(dists, np.float32).reshape(-1), half, 2, 3)
    assert [len(q) for q in got] == [2, 2] == [len(q) for q in python_rows(ids)]
    got = mod.build_nested(ids, vals, metas, np.asarray([n_slots, -1], np.int32),
                           np.zeros(2, np.float32), np.zeros(2, np.float32), half, 1, 2)
    assert got == [[]]


@pytest.mark.parametrize("cfg", [dict(use_pallas=False), dict(sweep_dtype="bfloat16")])
def test_hydrate_batch_native_matches_python(cfg):
    """End to end: the engine's hydration through build_nested returns exactly what the
    pure-Python branch returns (values aliasing the host mirror), also when rows were
    deleted after the snapshot was taken (those hits are dropped on both branches)."""
    rng = np.random.default_rng(5)
    n = 9000 if cfg.get("sweep_dtype") else 300
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    ids = tqp.bulk_load(rng.standard_normal((n, 16)).astype(np.float32), "ns",
                        metadatas=[{"i": i} if i % 4 else None for i in range(n)])
    q = rng.standard_normal((6, 16)).astype(np.float32)
    dist, slots, _, tables = tqp._raw_search(q, "ns", 7, "l2", {"i": {"$gte": 0}})
    dead = {int(s) for s in slots[0, :2]} | {int(slots[3, 6])}
    tqp.delete([tables[0][s] for s in dead], "ns")
    user = tqp._to_user_score(dist, "l2")
    got = tqp._hydrate_batch(user, dist, slots, tables)
    with mock.patch("mlvectordb_tpu_torch.engine.query_processor._hydrate_native",
                    return_value=None):
        want = tqp._hydrate_batch(user, dist, slots, tables)
    kept = [sum(int(s) not in dead for s in row) for row in slots]
    assert [len(r) for r in got] == [len(r) for r in want] == kept and sum(kept) <= 39
    for a, b in zip(got, want):
        assert [r["id"] for r in a] == [r["id"] for r in b]
        assert [r["score"] for r in a] == [r["score"] for r in b]
        assert [r["metadata"] for r in a] == [r["metadata"] for r in b]
        assert all(ra["values"] is rb["values"] for ra, rb in zip(a, b))
    assert all(r["metadata"]["i"] % 4 for rs in got for r in rs)
    assert ids  # the namespace still serves
    res = tqp.find_similar_batch([VectorDTO(v) for v in q], 7, "ns")
    with mock.patch("mlvectordb_tpu_torch.engine.query_processor._hydrate_native",
                    return_value=None):
        tqp._result_cache.clear()
        assert tqp.find_similar_batch([VectorDTO(v) for v in q], 7, "ns") == res


# ------------------------------------------------------------------ the build


def test_built_into_build_native_never_native_build():
    so = native.load()._name
    hyd = native.hydrate_module().__file__
    want = os.path.join(REPO, "build", "native")
    assert native.BUILD_DIR == want
    assert os.path.dirname(so) == want and os.path.dirname(hyd) == want
    runs = []
    real = native.subprocess.run
    with mock.patch.object(native.subprocess, "run",
                           lambda cmd, **kw: runs.append(cmd) or real(cmd, **kw)), \
            mock.patch.object(native, "BUILD_DIR", os.path.join(want, "probe-build")):
        try:
            assert native._built(native._SO_NAME, "metafilter.cpp")
        finally:
            import shutil

            shutil.rmtree(os.path.join(want, "probe-build"), ignore_errors=True)
    (cmd,) = runs
    assert cmd[:3] == ["make", "-C", os.path.join(REPO, "native")]
    build = next(a for a in cmd if a.startswith("BUILD="))[len("BUILD="):]
    assert build.startswith(os.path.join(want, "probe-build") + os.sep)
    assert any(a.startswith("PYINC=-I") for a in cmd) and any(a.startswith("EXT=") for a in cmd)
    assert not any("native/build" in a for a in cmd)


def test_concurrent_builders_all_load(tmp_path):
    """Builders racing on an empty build directory (test workers, several processes)
    each get a whole library: make writes into a directory of its own and the file is
    renamed into place."""
    out, errors = [], []

    def build():
        try:
            out.append(native._built(native._SO_NAME, "metafilter.cpp"))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    with mock.patch.object(native, "BUILD_DIR", str(tmp_path / "native")):
        ts = [threading.Thread(target=build) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    assert not errors and len(out) == 4 and len(set(out)) == 1
    lib = ctypes.CDLL(out[0])
    assert lib.mf_create
    assert sorted(os.listdir(tmp_path / "native")) == [native._SO_NAME]

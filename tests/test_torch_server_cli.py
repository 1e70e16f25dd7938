"""End-to-end CLI test of the port: drive `python -m mlvectordb_tpu_torch.api.server
--device cpu` as a real subprocess with --snapshot, --wal and --grpc-port wired together
(the cases of tests/test_server_cli.py): REST serving, gRPC co-serving, crash (SIGKILL)
recovery from snapshot+WAL on restart, and --mesh-shards/--mesh-replicas serving the
distributed engine with /mesh/reconcile (test_server_cli_mesh_mode; --snapshot with a
mesh is refused, as in the JAX package).  And ``import mlvectordb_tpu_torch`` imports no
server package."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _req(port, path, payload=None, method=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method=method or ("POST" if data else "GET"),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _wait_healthy(port, proc, timeout=60):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f"server died rc={proc.returncode}")
        try:
            status, _body = _req(port, "/health")
            if status == 200:
                return
        except Exception:
            time.sleep(0.3)
    raise TimeoutError("server never became healthy")


def _spawn(port, grpc_port, snap, wal):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [
            sys.executable, "-m", "mlvectordb_tpu_torch.api.server",
            "--host", "127.0.0.1", "--port", str(port),
            "--grpc-port", str(grpc_port),
            "--snapshot", snap, "--wal", wal,
            "--no-pallas", "--device", "cpu", "--log-level", "warning",
        ],
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )


def test_server_cli_snapshot_wal_grpc_roundtrip(tmp_path):
    port, grpc_port = _free_port(), _free_port()
    snap, wal = str(tmp_path / "snap"), str(tmp_path / "wal")
    rng = np.random.default_rng(3)
    vecs = [
        {"values": rng.standard_normal(8).astype(float).tolist(), "metadata": {"i": i}}
        for i in range(12)
    ]

    proc = _spawn(port, grpc_port, snap, wal)
    try:
        _wait_healthy(port, proc)
        status, body = _req(port, "/vectors/batch?namespace=ns", {"vectors": vecs}, "PUT")
        assert status == 200
        ids = body["ids"]
        status, results = _req(
            port, "/search?namespace=ns",
            {"query": vecs[4]["values"], "top_k": 3, "metric": "l2"},
        )
        assert status == 200 and results[0]["id"] == ids[4]

        # gRPC co-serves the same engine
        grpc = pytest.importorskip("grpc")
        from mlvectordb_tpu_torch.api import vectordb_pb2 as pb
        from mlvectordb_tpu_torch.api.grpc_server import make_stub

        channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        stub = make_stub(channel)
        sr = stub.Search(pb.SearchRequest(
            namespace="ns", query=vecs[7]["values"], top_k=2, metric="l2"
        ))
        assert sr.hits[0].id == ids[7]
        channel.close()

        # hard crash: SIGKILL — WAL must carry everything (no snapshot ran yet)
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()

    proc = _spawn(port, grpc_port, snap, wal)
    try:
        _wait_healthy(port, proc)
        status, info = _req(port, "/storage/info")
        assert info["total_vectors"] == 12, "WAL replay lost writes across SIGKILL"
        status, results = _req(
            port, "/search?namespace=ns",
            {"query": vecs[4]["values"], "top_k": 1, "metric": "l2"},
        )
        assert results[0]["id"] == ids[4]
        # snapshot save via REST, then deletes land in the fresh WAL segment
        status, _ = _req(port, f"/snapshot/save", {"path": snap})
        assert status == 200
        status, body = _req(port, "/vectors?namespace=ns", {"ids": ids[:2]}, "DELETE")
        assert body["message"] == "2 vectors deleted"
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()

    # third boot: snapshot + WAL tail replay → 10 vectors
    proc = _spawn(port, grpc_port, snap, wal)
    try:
        _wait_healthy(port, proc)
        status, info = _req(port, "/storage/info")
        assert info["total_vectors"] == 10
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_server_cli_mesh_mode(tmp_path):
    """--mesh-shards 4 --mesh-replicas 2 --device cpu serves a distributed engine (a
    (2, 4) mesh of CPU devices in the subprocess) with the in-mesh /mesh/reconcile
    verification surface, and recovers its writes from the WAL after SIGKILL."""
    port = _free_port()
    wal = str(tmp_path / "wal")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "mlvectordb_tpu_torch.api.server",
           "--host", "127.0.0.1", "--port", str(port), "--mesh-shards", "4",
           "--mesh-replicas", "2", "--wal", wal, "--no-pallas", "--device", "cpu",
           "--log-level", "warning"]
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        _wait_healthy(port, proc)
        rng = np.random.default_rng(5)
        vecs = [{"values": rng.standard_normal(8).astype(float).tolist()}
                for _ in range(24)]
        status, body = _req(port, "/vectors/batch?namespace=m", {"vectors": vecs}, "PUT")
        assert status == 200
        ids = body["ids"]
        status, results = _req(
            port, "/search?namespace=m",
            {"query": vecs[3]["values"], "top_k": 2, "metric": "l2"},
        )
        assert status == 200 and results[0]["id"] == ids[3]

        status, rep = _req(port, "/mesh/reconcile?namespace=m", method="POST")
        assert status == 200 and rep["consistent"] is True
        assert rep["replicas"] == [0, 1] and len(rep["fingerprints"]) == 2
        status, rep = _req(port, "/mesh/reconcile?namespace=m&repair=1", method="POST")
        assert status == 200 and rep.get("repaired") is False
        import urllib.error
        with pytest.raises(urllib.error.HTTPError) as exc:
            _req(port, "/mesh/reconcile?namespace=nope", method="POST")
        assert exc.value.code == 404
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        _wait_healthy(port, proc)
        status, info = _req(port, "/storage/info")
        assert info["total_vectors"] == 24, "WAL replay into the mesh lost writes"
        status, results = _req(
            port, "/search?namespace=m",
            {"query": vecs[9]["values"], "top_k": 1, "metric": "l2"},
        )
        assert results[0]["id"] == ids[9]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()


@pytest.mark.parametrize(
    "extra",
    [["--device", "cpu"], ["--snapshot", "snap"]],
    ids=["device_cpu", "with_snapshot"],
)
def test_server_cli_mesh_shards_raises_naming_a14(capsys, monkeypatch, tmp_path, extra):
    """--mesh-shards 4 with --device cpu serves a (1, 4) mesh of CPU devices (the server
    is built, its run loop stubbed out); with --snapshot it is refused with a usage error
    before anything is built, as the JAX package refuses it.  0 (the default) serves one
    device."""
    import torch

    from mlvectordb_tpu_torch import VectorDTO
    from mlvectordb_tpu_torch.api import server
    from mlvectordb_tpu_torch.api.server import build_parser, main

    served = []
    monkeypatch.setattr(server.RestAPI, "run", lambda self, **kw: served.append(self))
    extra = [str(tmp_path / a) if a == "snap" else a for a in extra]
    if "--snapshot" in extra:
        with pytest.raises(SystemExit) as exc:
            main(["--mesh-shards", "4", *extra])
        assert exc.value.code == 2
        assert "--snapshot is not supported with --mesh-shards" in capsys.readouterr().err
        assert not (tmp_path / "snap").exists() and not served
    else:
        main(["--mesh-shards", "4", "--no-file-logging", *extra])
        qp = served[0].query_processor
        mesh = qp.sharding_manager.mesh
        assert mesh.shape == {"replica": 1, "shard": 4}
        assert mesh.devices == [[torch.device("cpu")] * 4]
        vs = qp.upsert_many([VectorDTO(row) for row in np.eye(8, dtype=np.float32)], "ns")
        got = qp.find_similar(vs[5], top_k=1, namespace="ns", metric="l2")
        assert got[0]["id"] == vs[5].id
    args = build_parser().parse_args([])
    assert args.mesh_shards == 0 and args.mesh_replicas == 1 and args.device == "cuda"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--device", "tpu"])


def test_importing_the_port_imports_no_server_package():
    """``import mlvectordb_tpu_torch`` (the engine, the store, the kernels' wrappers, IVF)
    imports none of aiohttp, pydantic, grpc or protobuf: the card's machine has none of
    them, and only whoever serves imports ``mlvectordb_tpu_torch.api``."""
    code = (
        "import sys, mlvectordb_tpu_torch, mlvectordb_tpu_torch.store.ivf\n"
        "import mlvectordb_tpu_torch.engine.batcher, mlvectordb_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('aiohttp', 'pydantic', 'grpc') or m.startswith('google.protobuf'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, check=False,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr

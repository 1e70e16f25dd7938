"""End-to-end CLI test of the port: drive `python -m mlvectordb_tpu_torch.api.server
--device cpu` as a real subprocess with --snapshot, --wal and --grpc-port wired together
(the cases of tests/test_server_cli.py): REST serving, gRPC co-serving, crash (SIGKILL)
recovery from snapshot+WAL on restart.  The distributed engine (--mesh-shards) is refused
naming ROADMAP A14 until it is ported; its serving case (test_server_cli_mesh_mode) waits
for it.  And ``import mlvectordb_tpu_torch`` imports no server package."""

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


@pytest.mark.parametrize(
    "extra",
    [["--device", "cpu"], ["--snapshot", "snap"]],
    ids=["device_cpu", "with_snapshot"],
)
def test_server_cli_mesh_shards_raises_naming_a14(capsys, tmp_path, extra):
    """--mesh-shards (the distributed engine) is refused with a usage error naming
    ROADMAP A14 before anything is built, whatever comes with it (JAX also refuses a
    mesh with --snapshot); 0 (the default) serves one device."""
    from mlvectordb_tpu_torch.api.server import build_parser, main

    extra = [str(tmp_path / a) if a == "snap" else a for a in extra]
    with pytest.raises(SystemExit) as exc:
        main(["--mesh-shards", "4", *extra])
    assert exc.value.code == 2
    assert "A14" in capsys.readouterr().err
    assert not (tmp_path / "snap").exists()
    args = build_parser().parse_args([])
    assert args.mesh_shards == 0 and args.device == "cuda"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--device", "tpu"])
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--mesh-replicas", "2"])


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

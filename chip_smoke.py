#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mlvectordb_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from csrc/ with nvcc (into build/kernels/), then, printing
one line per phase:
  1. device: the card's name and power limit; each kernel's registers and spills
     (-Xptxas -v) and the mma.sync (HMMA) instructions of each tensor-core kernel: the
     sweep kernel's body over bf16, int8 and f32 mirrors (four f32 instantiations, each
     with at least its six split products; every program's wide and narrow query tile
     streamed, so that no Dp is refused) and the six row-major window-min
     instantiations (cuobjdump of the built library; none, a program without its
     streamed tiles, or an FMA body left in the library, is a failure); the route the
     sweep kernel takes for each program at Dp = 128 to 8192; the native host runtime
     (native/metafilter.cpp, native/hydrate.c) built beside the kernels into
     build/native/ (the metadata filter must build; whether _hydrate built is printed);
  2. the row-major window-min kernels (the tensor cores: f32 rows as a three-way bf16
     split) against their plain torch versions on the card (l2/ip/cosine, N = 65,536 and
     1,048,576, D = 128, B = 512, r1 in {8, 32}), each live window within the
     per-element budget fused_knn._phase1_budget; B = 512 with 128 live queries: the
     live-column launch bit-equal to the full one; a NaN query through both (NaN mins
     exactly where the plain version has them); at Dp = 1536 (2^18 rows, f32 and bf16,
     the query chunks streamed) both kernels within the budget, the live launch bit-equal
     to the full one, timed with its bound;
  3. the default exact-kNN serving path at SIFT-1M shape through QueryProcessor:
     bulk_load of 1,048,576 x 128 f32, find_similar_batch (l2 at B=128, ip and cosine
     at B=16), delete of 1,000 ids and search again, each held to set-exact
     recall@10 = 1.0 against a float64 numpy oracle, plus the launch counts and the query
     columns computed (the live ones alone) showing which kernels served it and the
     one-h2d/one-d2h transfer rule; every batch proven at tier 0 (ROADMAP C20: the
     row-major path records the tier it proved; phases 6, 11, 15's B5 over a filter and
     19b's sharded B5 assert the same, 19b by its proofs' count and one copy each way);
     then C20's near duplicates (``check_near_duplicates``): 64 rows c + N(0, 1e-4^2) of
     one c ~ N(0, 10^2) in a 2^20-row namespace of their own, 128 queries c + N(0, 1)
     through B4 and, after the deletes, B5: escalated, the float64 oracle's ids in order
     (0 missed), the tier mix and the kernels' launches printed (phase 11: bf16 rows);
  4. the certified sweep kernels against their plain versions on the card: the sweep
     window-min kernel (bf16 mirror: the tensor cores), light and heavy, l2/ip/cosine,
     N = 65,536 and 1,048,576, B = 512, ~1% tombstones in the bias row, each window min
     within the per-element phase-1 budget (fused_knn_t._phase1_budget), the block mins
     the kernel's own; B = 512 with 128 live queries computing 128 columns, every column
     bit-equal to the full launch; the gather-score rescan B2 at the main path's B = 512,
     32 windows of 32 rows, and its launch over the 128 live queries and the first padded
     one bit-equal to the full launch; B2 at Dp = 1536 over 2^18 rows made on the card (f32
     and bf16), within the bound of plain, the live launch bit-equal, timed with its bound;
  5. the certified sweep path (EngineConfig(sweep_dtype="bfloat16")) at the same shape
     and with the same checks as phase 3, the light program serving at tier 0; then a
     clustered namespace of 131,072 rows where the light proof fails, the exact scan
     serves, the namespace flips to the heavy program, and both batches match the
     oracle's k-distances; the launch counts of the sweep kernels;
  6. times on the card (CUDA events; informative only): B4/B5 at the engine's operands
     (128 live columns of the 512 bucket, r1 from the padded batch), their plain
     versions, their full 512-column launch and the f32 product alone (torch.matmul, TF32
     off) as a yardstick; B2 at the engine's operands (its full launch within the bound
     of plain, its live launch bit-equal to the full one, the candidate rows it computed, the live launch, the full launch, plain and
     data.index_select of the same rows, the kernels timed with the L2 cache flushed); the
     engine's search (light and heavy) with n_live equal to the one without it;
  7. the k-bucket-128 certified sweep program: the sweep kernel's per-tile top-m pool
     (N = 65,536 and 1,048,576, B = 512 pool only and B = 8 window mins plus pool, r1 =
     16, m = 8, light and heavy, l2/ip/cosine) bit-equal to the plain pool of the
     kernel's own window mins, those within the budget of the plain version's, and the
     live-column launch bit-equal to the full one;
     find_similar_batch at k=100 on the phase-5 namespace (l2 at B=128, ip and cosine at
     B=16, before and after the deletes; set-exact recall@100 = 1.0; l2 at tier 0 with
     transfers (1, 1), ip and cosine there or, after a failed light proof, at the exact
     scan with (1, 2); the pool launched and no window-min matrix written); range_search
     (limit 100 and 1000) and similarity_search against the oracle's hits within the
     radius; a batch holding a NaN query (NaN mins where the plain version has them, and
     tier 2 as on the CPU); times, B2 checked and timed at the k-bucket-128 operands as
     in phase 6, and the
     search with n_live equal to the one without it;
  8. the int8 mirror (EngineConfig(sweep_dtype="int8"): two int8 streams): the sweep
     kernel over int8 codes (one pass, two_pass, two_pass with the second stream; the
     k = 10 and k = 100 programs at 2^20 rows, B = 512, and B = 8 at 2^16; l2/ip/cosine)
     within the budget of its plain version, block mins and pool the kernel's own;
     find_similar_batch at the same shape (l2 at B=128, ip and cosine at B=16, k = 10 and
     100, before and after 1,000 deletes; set-exact recall = 1.0; tiers and transfers
     printed, tier 0 only with (1, 1), no light_ tier); the launch counts showing the
     heavy int8 kernel served every search and computed only the live query columns; each
     search (k = 10, 100) with n_live equal to the one without it; one
     l2 batch with one int8 stream (sweep_resid=False); times and the engine wall beside
     the bf16 sweep's;
  9. the f32 mirror (sweep_dtype="float32", the store's own rows): the same checks, the
     kernel (six bf16 passes of a three-way split on the tensor cores) within the budget
     of its plain version, the mirror the data tensor; its launches at the engine's
     B = 16 operands (ip, cosine) timed too, and each f32 entry's route, its bound on that
     route beside the f32 FMA route's, and its share;
 10. probe B7 over the phase-8 codes (B = 128): B3's int8 pass (codes widened to bf16 on
     the tensor cores), int8 mma.sync and the stream floor, each against its plain
     version; times, GB/s and bounds;
 11. a bf16 store, row-major (EngineConfig(dtype="bfloat16")) on the phase-3 corpus: the
     window-min kernels over bf16 rows against their plain versions (as phase 2, NaN
     query and live columns included), then the phase-3 searches before and after the
     deletes, each set-exact against a float64 oracle over the bf16-rounded rows with the
     f32 query; launch counts and query columns, device bytes, times at the engine's
     operands as in phase 6 (the bf16 product alone as the yardstick); ROADMAP C3's near
     tie at 1,048,576 rows before a compaction: row A first at distance 0 through B4, B5
     and the scan, its norm in the store its stored row's; ROADMAP C18 at 1,048,576 rows
     (the phase-3 corpus copied to the card): 64 pairs q +- e per metric that the plain
     f32 formula orders strictly against float64, through B2's rescan, B5's row-major
     rescan and the scan, l2 and cosine, each pair first in float64 order;
 12. DEEP: a bf16 store with the same-dtype sweep (sweep_dtype="bfloat16": the mirror is
     the rows themselves, one pass) at 8,388,608 x 128: cosine B=128 k=10, l2 B=128
     k=10, ip B=16 k=10 and cosine B=128 k=100, before and after 1,000 deletes, each
     set-exact against the bf16-row oracle (computed on the card in chunks) with its
     tier and transfers and the query columns computed; the sweep and gather kernels
     against their plain versions at the engine's operands (the budget; the live-column
     launch bit-equal to the full one); B2 checked and timed as in phase 6 at the cosine
     searches' k buckets 16 and 128; each search with n_live
     equal to the one without it; device bytes; the rows' rounding gap beside the
     query's; times, torch.matmul of the rows against the live queries as a yardstick,
     and the engine wall;
 13. probe B6 over the phase-12 rows (B = 128, r1 = 32): the sweep kernel writing its
     window mins [B, P] and tile-major, each within the budget of its plain version and
     bit-equal to the other; times, GB/s and bounds;
 14. the sweep kernel at every engine operand set of phases 6-9: the live-column launch
     (128 of 512 columns) bit-equal to the full launch on every column; the tensor-core
     dots against float64 over the DEEP rows, hard rows and int8 codes of +-127, an f32
     mirror (the phase-3 corpus and hard f32 rows), and B4's
     (f32 rows: the phase-3 corpus and hard f32 rows; bf16 rows: the DEEP rows), each
     max |dot - exact| / (|q||x|) printed against the bar Dp * 2^-23;
 15. hybrid search at the GloVe-1.2M shape (BASELINE.json config #3): 1,183,514 x 100 f32
     rows of default_rng(60) with their metadata (parity, bucket, language; a 5-row
     field), cosine, EngineConfig(sweep_dtype="bfloat16"): B=128 k=10 under the 50%, 1%,
     25% and 5-row filters, k=100 under the 50% one and a filtered similarity_search,
     before and after 1,000 deletes, each set-exact against a float64 oracle over the
     matching live rows, with no hit outside its filter, its tier and transfers; every
     mask from the native evaluator and one mask upload per (snapshot, filter); B1 over
     the 50% filter's masked bias row and B2 on its rescan against their plain versions,
     timed with their bounds; exact_knn_t light and heavy; the engine wall and its split
     (mask build, _raw_search, hydration); the mask build natively and in Python; then
     B5 over a filter: the default config on the first 2^18 rows, l2 and cosine, and B5
     against plain at those operands, timed;
 16. durability and operations on phase 6's namespace (1,048,576 x 128 f32 rows of
     default_rng(42), sweep_dtype="bfloat16", after its 1,000 deletes), its files under
     build/durability/: save (seconds, bytes on disk, MB/s) and QueryProcessor.load on the
     card (seconds), the loaded namespace's nbytes and live count equal to the source's,
     the phase-6 batches (B=128 l2, k=10 and 100) with the live processor's ids and
     scores, set-exact against the float64 oracle, at tier 0 with transfers (1, 1), B1 and
     B2 launched; crash recovery: the snapshot reloaded with a WAL (fsync), 10,000 rows
     acknowledged in 100 upsert_many batches, 1,000 deletes and one batch overwriting 100
     ids, the processor abandoned (no save, no close) and recovered with
     QueryProcessor.load(..., wal_path=...): every acknowledged write read back, no
     deleted id present, the abandoned processor's answers, set-exact against an oracle
     over the recovered rows (replay seconds and records/s); offload: device memory
     freed by at least 0.9 x nbytes, the namespace listed as offloaded, the next search
     paging it in (ms) with the same answers and nbytes; warmup(detail=True) with the
     kernel launches it caused, explain_query, get_statistics, deep_health, render_metrics,
     plan_capacity for 100M x 1536 bf16 against the card's memory, and a PROFILER trace
     around one search;
 17. IVF (store/ivf.py, ops/kmeans.py: torch ops, no hand-written kernel) at the JAX
     package's SIFT-1M stand-in: 1,048,576 x 128 clustered rows and 128 held-out queries
     (synthesize_clustered, copied from benchmarks/datasets.py, seed 7), EngineConfig()
     on the card; build_ivf with the defaults (C = 2048, L = 1128), the k-means, the
     assignment, the host layout and the device scatter timed apart, then again with
     spill=2; l2 k=10 at nprobe 1, 4, 16, 64 and 2048: per query the recall@10 against a
     float64 oracle never falls as nprobe grows, transfers (1, 1) per search, the full
     probe exact (the oracle's rows, ties within f32 rounding) as the exact path is; ms per
     batch (CUDA events around the probe scan and its copy to the host); a 2^16-row slice
     built on the card and on the CPU: centroids within 1e-5, the same assignment, the
     same ids at nprobe 4; 1,000 upserts and 1,000 deletes through the engine followed by
     the index; a snapshot with its IVF entry saved and loaded on the card, the same ids;
 18. the server: RestAPI over phase 17's processor in aiohttp's in-process test server
     (/health?deep=1 naming the card, an insert and a delete, /search/batch of the 128
     queries equal to the direct call and launching B4/B5, /ivf/build then nprobe=16
     equal to the direct call, 32 concurrent searches through --auto-batch's
     micro-batcher equal to the direct calls, the HTTP round trip against the direct call,
     median of 5), and gRPC Search and BatchSearch where grpc imports.  Where aiohttp or
     pydantic does not import, phase 18 prints one line naming it and does not run.
 19. the distributed engine (parallel.make_distributed_processor; the mesh's cells are
     the visible cards in turn, so one card holds them all): (a) the first half of phase
     12's DEEP rows (4,194,304; the depth cut to keep the run inside its time limit) and
     their ids on a (1, 4) mesh (the same-dtype sweep per shard), cosine k=10 and k=100
     and l2 k=10 at B=128 before and after phase 12's deletes among them: recall 1.0
     against the bf16-row oracle and its distances as the scores, one launch of B1
     and of B2 per shard and search, transfers (1, 1) on every search whose shards all
     certified; the capacity and device bytes; B1 and B2 at a shard's operands against
     their plain versions and timed with their bounds, the merge of the shards' lists as
     one engine search's ``knn_sharded.merge`` span records it (host time from RECORDER,
     device time from a PROFILER trace), the engine wall beside phase 12's; (b) the SIFT-1M shape (phase 3's rows and ids) on
     a (2, 2) mesh with EngineConfig() (B5 per shard) and sweep_dtype="bfloat16": l2 k=10
     at B=128 (replica 0's half of the bucket) and B=384 (both replicas), before and after
     the 1,000 deletes: recall 1.0, the unsharded processors' answers (phases 3 and 6),
     a launch per shard of each replica holding a live query; B5 at a shard's operands
     against plain; then reconcile, one row of replica 1 corrupted and named, repair and
     the answers restored, and the cluster-sharded IVF (C = 2048) exact at full probe.
     Its record is one JSON line starting {"mesh".
 20. a bf16 store with an int8 or f32 sweep mirror (dtype="bfloat16", sweep_dtype="int8"
     with two streams, and "float32") on phase 3's rows (1,048,576 x 128 of
     default_rng(42), not cut): the device bytes equal to the exact arithmetic (rows at
     2 B, the mirror at its own width, liveness, norms, the per-row vectors) and to
     plan_capacity; the mirror the stored rows' codes or widening and the norms the
     rows' f32 sums (ROADMAP C17) after the writes and after compact(); l2 at B=128, ip
     and cosine at B=16, k = 10 and 100, before and after
     phase 3's 1,000 deletes, each set-exact against phase 11's oracle over the
     bf16-rounded rows with the f32 query, with its tier and transfers ((1, 1) at tier 0,
     no light_ tier) and the launch counts (B3 over the mirror's type, B2 over the bf16
     rows, the live query columns alone); B3 and B2 at the engine's l2 B=128 operands
     against their plain versions (the phase-1 budget, the live launch bit-equal to the
     full one), timed with their bounds (the f32 mirror also at B = 16 and with its route,
     as in phase 9); the prep a snapshot's first search pays; compact() and one l2 batch
     on it; one l2 batch with one int8 stream; ROADMAP C17's near tie on the card and the
     CPU (the exact set at the tier the CPU tests pin, each mirror).  (The f32 mirror
     sharded runs on the card in tests/test_torch_gpu.py.)  Its record is one JSON line
     starting {"bf16_mirrors".
 21. wide embeddings through QueryProcessor: (a) a bf16 store with the same-dtype sweep at
     1,048,576 x 1536 (BASELINE.json config #5's width, default_rng(63)); (b) an f32
     store at 524,288 x 3072 (OpenAI text-embedding-3-large's width, default_rng(64))
     with an int8 mirror (two streams), then with a bf16 mirror; cosine / l2 at B=128
     and ip / cosine at B=16, k=10, and B=128 at k=100, before and after 1,000 deletes,
     each set-exact against a float64 oracle on the card (the bf16 store's over its bf16
     rows), with its tier (one tier; light_ ones only from the light program, whose
     escalation to the scan flips it to heavy) and transfers ((1, 1) exactly at tier
     0); (c) phase 5's clustered namespace at 131,072 x 3072 (the first batch escalates
     and flips, the second runs the heavy program); B1/B3 of every program at the
     engine's operands (B=128 and 16, k buckets 16 and 128) against plain (the phase-1
     budget, the pool the plain pool of its own mins, the live launch bit-equal to the
     full one), timed with its bound, the route it took (the query tile resident or
     streamed, the ring's depth) and the bf16 torch.matmul yardstick of its one-pass
     product; B2 checked and timed as in phase 6; exact_knn_t and the engine wall with
     its host split; each search's device memory beyond the store at its peak within
     fused_knn_t.search_bytes_bound (ROADMAP C16).  Its record is one JSON line starting
     {"wide".
After each phase, one line counts ROADMAP C18's float64 settles in it: the queries
settled, those whose returned set or order the settle changed against the pure f32 order,
and those flagged for the wider settle (the timing loops are not counted).
Any failure raises, so the process exits non-zero.  Before them, one JSON line holds the
IVF and server records, one C18's (phase 11's paths and every phase's settle counts), one
the distributed engine's, one phase 20's and one phase 21's;
the last two lines
are the kernels'
JSON record (with each kernel's bound: bytes over 3.35 TB/s or operations over the peak
for their type, whichever is larger; for the sweep kernel and B4/B5 the products of the
live queries, with the bound at the whole padded batch and the time of a launch over every
column beside it; B4/B5 also the route the bound assumes and the torch.matmul yardstick)
and {"ok": true, "device": {...}}.  Needs no network
and imports no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO, filters, native
from mlvectordb_tpu_torch.engine import query_processor as qp_mod
from mlvectordb_tpu_torch.store.namespace import NamespaceStore
from mlvectordb_tpu_torch.utils.capacity import plan_capacity
from mlvectordb_tpu_torch.utils.health import deep_health
from mlvectordb_tpu_torch.utils.metrics import render_metrics
from mlvectordb_tpu_torch.utils.tracing import PROFILER, RECORDER
from mlvectordb_tpu_torch.ops import _kernels, fused_knn, fused_knn_t, settle, topk
from mlvectordb_tpu_torch.ops.distances import MASKED, require_f32_matmul
from mlvectordb_tpu_torch.parallel import make_distributed_processor
from mlvectordb_tpu_torch.parallel.mesh import mesh_devices
from mlvectordb_tpu_torch.probes.time_gather import time_ms as _time_cold_ms

N, D, K, B = 1 << 20, 128, 10, 128
K100 = 100
SEED = 42
CSRC = "mlvectordb_tpu_torch/csrc/"
SWEEP = EngineConfig(sweep_dtype="bfloat16")
# NVIDIA's H100 SXM data sheet at 700 W: HBM rate, f32 on the CUDA cores, dense bf16 on the
# tensor cores
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _start_ptxas_report():
    """Start one nvcc per kernel source with the build's own flags plus ``-Xptxas -v``
    (into build/kernels/ptxas/), beside the build; ``_ptxas_report`` reads them."""
    out = _kernels.BUILD_DIR / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return out, [subprocess.Popen(
        [_kernels._nvcc(), *_kernels._ARCH, "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c",
         "-o", str(out / f"{src.stem}.o"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in _kernels._sources()]


def _short(name: str) -> str:
    """A kernel's mangled name cut to its own name and template arguments."""
    return re.sub(r"^_ZN\w*?\d+(?=[a-z_]+kernel)", "", name)[:40]


def _ptxas_report(started):
    """(kernel, registers, spill stores, spill loads, shared bytes) of each kernel, from
    the assembler's report of the compiles ``_start_ptxas_report`` started."""
    out, procs = started
    rows = []
    for proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed: {text}")
        name, spills = None, (0, 0)
        for line in text.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                name = m.group(1)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = (int(m.group(1)), int(m.group(2)))
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                smem = re.search(r"(\d+) bytes smem", line)
                rows.append((name, int(m.group(1)), *spills, int(smem.group(1)) if smem else 0))
                name = None
    shutil.rmtree(out, ignore_errors=True)
    return rows


# the tensor-core kernels' names: the sweep kernel's one body over bf16, int8 and f32
# mirrors (B1/B3) and the row-major window-min kernel over bf16 and f32 rows (B4/B5)
MMA_KERNELS = ("sweep_mma_kernel", "window_mma_kernel")


def _mma_counts(lib):
    """({kernel: HMMA instructions} of the built library's tensor-core kernels (each
    instantiation of MMA_KERNELS), every kernel's name), from its SASS (cuobjdump, beside
    nvcc): the proof that the sweep body over each mirror type and B4/B5 over bf16 and f32
    rows run mma.sync."""
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, names, name = {}, [], None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            names.append(m.group(1))
            name = m.group(1) if any(k in m.group(1) for k in MMA_KERNELS) else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts, names


# B1/B3's programs as (mirror type in the kernel's mangled name, two_pass, the second
# stream): the bf16 mirror's four, the int8 mirror's three, the f32 mirror's one
SWEEP_PROGRAMS = {"light": ("t", "0", "0"), "two_pass": ("t", "1", "0"),
                  "resid": ("t", "0", "1"), "heavy": ("t", "1", "1"),
                  "int8_light": ("a", "0", "0"), "int8_two_pass": ("a", "1", "0"),
                  "int8": ("a", "1", "1"), "f32": ("f", "0", "0")}
_SWEEP_NAME = re.compile(r"sweep_mma_kernelI([taf])Lb([01])ELb([01])ELi(\d+)ELi(\d+)ELb([01])E")


def check_streamed_tiles(mma):
    """Every program of B1/B3 holds a streamed instantiation with mma.sync for its wide and
    its narrow query tile (so no Dp is refused): a failure otherwise."""
    streamed = {}
    for name, hmma in mma.items():
        if (m := _SWEEP_NAME.search(name)) and m.group(6) == "1" and hmma > 0:
            streamed.setdefault(m.groups()[:3], set()).add((int(m.group(4)), int(m.group(5))))
    print(f"  B1/B3 streamed query tiles (n-tiles a warp, ring depth) by program: "
          f"{ {p: sorted(streamed.get(k, ())) for p, k in SWEEP_PROGRAMS.items()} }")
    missing = [p for p, k in SWEEP_PROGRAMS.items() if len(streamed.get(k, ())) != 2]
    if missing:
        raise AssertionError(f"B1/B3 lacks a streamed wide or narrow tile for {missing}")


def print_routes():
    """The route B1/B3 takes for each engine program at Dp = 128 to 8192, at 16 and 128
    live queries: the queries a block owns, the query resident or streamed, the ring."""
    programs = {"light": (torch.bfloat16, False, False), "heavy": (torch.bfloat16, True, True),
                "int8": (torch.int8, True, True), "int8_one_stream": (torch.int8, True, False),
                "f32": (torch.float32, False, False)}
    for dim in (128, 384, 1536, 3072, 8192):
        line = {}
        for name, (dtype, two_pass, resid) in programs.items():
            for bq in (16, 128):
                r = fused_knn_t.sweep_route(dtype, dim, bq, bq, two_pass=two_pass, resid=resid)
                line[f"{name} B={bq}"] = f"{r['tile_queries']}q {r['query']} {r['stages']}-stage"
        print(f"  B1/B3 route at Dp = {dim}: {line}")


def _untallied(fn):
    """``fn`` with ROADMAP C18's settle tally off (``settle.TALLY``), so that no timing
    carries its counting."""
    @functools.wraps(fn)
    def run(*a, **kw):
        saved, settle.TALLY = settle.TALLY, None
        try:
            return fn(*a, **kw)
        finally:
            settle.TALLY = saved
    return run


_C18 = {"phase": None, "counts": {}}


def _c18_phase(label):
    """ROADMAP C18's settle counts of the phase that ends here, printed and kept: the
    queries the float64 settle ordered, those whose returned set or order it changed
    against the pure f32 order, and those flagged for the wider settle; then the tally
    starts again for ``label`` (None: the last phase ended)."""
    got, settle.TALLY = settle.TALLY or [], None if label is None else []
    if _C18["phase"] is not None:
        n = [sum(int(t[0]) for t in got), sum(int(t[1]) for t in got),
             sum(int(t[2]) for t in got)]
        _C18["counts"][_C18["phase"]] = dict(zip(("settled", "changed", "flagged"), n))
        print(f"  C18 settle in {_C18['phase']}: {n[0]} queries settled in float64, {n[1]} "
              f"of them changed against the f32 order, {n[2]} flagged for the wider settle")
    _C18["phase"] = label
    return _C18["counts"]


def _xfer_mark(qp):
    """``qp``'s copy counts now, for ``_xfer``."""
    return dict(qp.transfer_counts, settle=qp.settle_copies)


def _xfer(qp, mark):
    """(h2d, d2h) copies of ``qp`` since ``mark``, less those of ROADMAP C18's wider
    settle of flagged queries (``settle_copies``, counted per phase in the C18 line)."""
    return (qp.transfer_counts["h2d"] - mark["h2d"],
            qp.transfer_counts["d2h"] - mark["d2h"] - (qp.settle_copies - mark["settle"]))


@_untallied
def _time_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@_untallied
def _engine_wall(qp, q_np, runs: int = 5, k: int = K, namespace="sift", metric="l2",
                 filter=None):
    """Host wall times (ms) of find_similar_batch at B=128, l2, k=10 (or ``k``, the
    ``namespace``, ``metric`` and ``filter`` given): distinct queries per run, so the
    result cache cannot serve them; each run ends in its device->host copy."""
    wall = []
    for i in range(runs):
        qs = [VectorDTO(v) for v in q_np + np.float32(i + 1) * np.float32(1e-3)]
        t0 = time.perf_counter()
        qp.find_similar_batch(qs, k, namespace, metric, filter)
        wall.append((time.perf_counter() - t0) * 1e3)
    return wall


@_untallied
def _engine_split(qp, q_np, runs: int = 5, k: int = K, namespace="sift", metric="l2",
                  filter=None):
    """Median host ms of the parts of find_similar_batch at B=128, l2, k=10 (or ``k``,
    the ``namespace``, ``metric`` and ``filter`` given): stacking the query DTOs,
    _raw_search (h2d, kernel, selection and rescan, d2h; with a filter, its mask from the
    engine's cache) and hydration of the result dicts; with a filter first the mask
    build a search pays after each write (the cache emptied, the engine's mask_for)."""
    parts = {"stack": [], "raw_search": [], "hydrate": []}
    if filter:
        parts = {"mask_build": [], **parts}
    ns = qp.storage.namespace(namespace)
    for i in range(runs):
        qs = [VectorDTO(v) for v in q_np + np.float32(i + 11) * np.float32(1e-3)]
        ms = []
        if filter:
            qp._filter_masks._cache.clear()
            t0 = time.perf_counter()
            with ns._lock:
                qp._filter_masks.mask_for(ns, filter)
            ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        q = np.stack([np.asarray(x.values, np.float32).reshape(-1) for x in qs])
        t1 = time.perf_counter()
        dist, slots, _, tables = qp._raw_search(q, namespace, k, metric, filter)
        t2 = time.perf_counter()
        qp._hydrate_batch(qp._to_user_score(dist, metric), dist, slots, tables)
        t3 = time.perf_counter()
        ms += [(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3]
        for name, m in zip(parts, ms):
            parts[name].append(m)
    return {name: statistics.median(v) for name, v in parts.items()}


def _oracle_dists(db64, q, metric, dead=None):
    """[nq, n] float64 brute-force distances (rows in ``dead`` at +inf)."""
    q64 = q.astype(np.float64)
    dots = q64 @ db64.T
    sq = (db64 * db64).sum(-1)
    if metric == "l2":
        d = sq[None, :] - 2.0 * dots + (q64 * q64).sum(-1)[:, None]
    elif metric == "ip":
        d = 1.0 - dots
    else:
        d = 1.0 - dots / np.sqrt(np.maximum(sq[None, :] * (q64 * q64).sum(-1)[:, None], 1e-30))
    if dead is not None:
        d[:, dead] = np.inf
    return d


class Oracle:
    """Top-k row sets of the float64 brute force, shared by every phase (same corpus, same
    queries).  The distances are computed once per (metric, batch); the nearest ``KEEP``
    rows of each query are kept in order, enough for any k <= 100 after the 1,000 deletes."""

    KEEP = 1200

    def __init__(self, db64, q_np):
        self.db64, self.q_np, self.cache = db64, q_np, {}

    def nearest(self, metric, nq):
        """([nq, KEEP] row ids, [nq, KEEP] float64 distances), nearest first."""
        if (metric, nq) not in self.cache:
            d = _oracle_dists(self.db64, self.q_np[:nq], metric)
            part = np.argpartition(d, self.KEEP, axis=1)[:, : self.KEEP]
            dp = np.take_along_axis(d, part, axis=1)
            order = np.argsort(dp, axis=1, kind="stable")
            self.cache[(metric, nq)] = (np.take_along_axis(part, order, axis=1),
                                        np.take_along_axis(dp, order, axis=1))
        return self.cache[(metric, nq)]

    def sets(self, metric, nq, dead=None, k=K):
        rows, _ = self.nearest(metric, nq)
        dead = set() if dead is None else set(np.asarray(dead).tolist())
        return [set([i for i in r.tolist() if i not in dead][:k]) for r in rows]


def _check_recall(results, want_rows, ids, label, k=K):
    want = [{ids[i] for i in rows} for rows in want_rows]
    hits = sum(len({r["id"] for r in rs} & w) for rs, w in zip(results, want))
    recall = hits / (len(want) * k)
    exact = all(len(rs) == k for rs in results)
    print(f"  {label}: recall@{k} = {recall} over {len(want)} queries")
    if recall != 1.0 or not exact:
        raise AssertionError(f"{label}: recall@{k} = {recall}, result lengths ok: {exact}")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes, ops, peak):
    """(least ms, what bounds it, bytes, operations): the bytes the call must move over the
    HBM rate, or its operations over the peak for their type, whichever takes longer."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def _full(kw):
    """A B1/B3 call's keyword arguments without the live count: the full launch."""
    return {k: v for k, v in kw.items() if k not in ("n_live", "zero_cache")}


def _budget(a, kw):
    """The per-element phase-1 budget of a B1/B3 call's window mins (see
    fused_knn_t._phase1_budget); its block mins' is the largest over each tile."""
    return fused_knn_t._phase1_budget(*a, r1=kw["r1"], qe=kw.get("qe"),
                                      eb_rows=kw.get("eb_rows", ()),
                                      transposed=kw.get("transposed", True))


def _check_budget(got, want, budget, label):
    """The kernel's live windows within the budget of the plain version's, fully masked
    windows exactly 3e38.  Returns (max |err|, max |err| / budget)."""
    dead = want == float(MASKED)
    err = torch.where(dead, 0.0, (got - want).abs())
    ratio = float((err / torch.where(dead, 1.0, budget)).max())
    if not torch.equal(got[dead], want[dead]) or not bool((err <= budget).all()):
        raise AssertionError(f"{label}: |err| / budget {ratio}")
    return float(err.max()), ratio


def _bits_equal(x, y):
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def _check_live_tiles(a, kw, n_live, label):
    """The kernel on the first ``n_live`` columns, the rest filled from a fresh
    zero-query cache, against its full launch: bit-equal on every column of every output.
    Returns the query columns the live launch computed."""
    fn = fused_knn_t._window_mins_t
    full = fn(*a, **_full(kw))
    cols = fn.cols
    live = fn(*a, **_full(kw), n_live=n_live, zero_cache={})
    cols = fn.cols - cols
    torch.cuda.synchronize()
    for f, g in zip(full, live):
        if (f is None) != (g is None) or (f is not None and not _bits_equal(f, g)):
            raise AssertionError(f"{label}: the live-column launch differs from the full one")
    return cols


def check_kernels(db_np, rows=torch.float32):
    """Phases 2 and 11: each row-major kernel against its plain version on the card, over
    rows of type ``rows`` (f32: the three-way bf16 split; bf16 with the query rounded to
    bf16 and carried as f32, as exact_knn_fused passes it: one pass), l2/ip/cosine, r1 in
    {8, 32}, B = 512: live windows within the per-element budget fused_knn._phase1_budget,
    fully masked windows exactly 3e38; at 2^20 rows, the engine's padding of B = 128 to
    512: the launch of the 128 live columns bit-equal to those columns of the full launch.
    Returns ({variant: max |err|}, {variant: max |err| / budget})."""
    masked_value = float(MASKED)
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    worst = {"fast": 0.0, "masked": 0.0}
    ratios = {"fast": 0.0, "masked": 0.0}
    for n in (65536, N):
        src = torch.from_numpy(db_np[:n]).to(dev)
        data = src.to(rows)
        q = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
        qt, qn = q.T.to(rows).float().contiguous(), (q * q).sum(-1)[None, :].contiguous()
        hw = n - fused_knn.DB_TILE - 1234
        valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)   # ~1% tombstones
        valid[-fused_knn.DB_TILE:] = False                         # fully masked windows
        maskadd = torch.where(valid, 0.0, masked_value)
        for r1 in (8, 32):
            for metric in ("l2", "ip", "cosine"):
                kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=r1)
                bias = ((src * src).sum(-1) + maskadd if metric == "l2" else maskadd)
                bias = bias[:, None].contiguous()
                pairs = {
                    "fast": (fused_knn._window_mins_fast(data, qt, qn, hw, **kw),
                             fused_knn._window_mins_fast_ref(data, qt, qn, hw, **kw),
                             fused_knn._phase1_budget(data, qt, qn, hw=hw, **kw)),
                    "masked": (fused_knn._window_mins_masked(data, qt, qn, bias, **kw),
                               fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw),
                               fused_knn._phase1_budget(data, qt, qn, bias=bias, **kw)),
                }
                torch.cuda.synchronize()
                for name, (got, want, budget) in pairs.items():
                    label = f"{name} {rows} n={n} r1={r1} {metric}"
                    if not bool((want == masked_value).any()):
                        raise AssertionError(f"{label}: no masked window")
                    err, ratio = _check_budget(got, want, budget, label)
                    worst[name] = max(worst[name], err)
                    ratios[name] = max(ratios[name], ratio)
                del pairs
                if n == N and r1 == 8:
                    qz = q.clone()
                    qz[B:] = 0.0                    # the engine's padding of B=128 to 512
                    zt = qz.T.to(rows).float().contiguous()
                    zn = (qz * qz).sum(-1)[None, :].contiguous()
                    for name, fn, arg in (("fast", fused_knn._window_mins_fast, hw),
                                          ("masked", fused_knn._window_mins_masked, bias)):
                        full = fn(data, zt, zn, arg, **kw)
                        live = fn(data, zt, zn, arg, **kw, n_live=B)
                        torch.cuda.synchronize()
                        if live.shape[1] != B or not _bits_equal(live, full[:, :B]):
                            raise AssertionError(f"{name} {rows} {metric}: the live-column "
                                                 f"launch differs from the full one")
                    print(f"  {rows} {metric} r1={r1}, B=512 with {B} live queries: {B} columns "
                          f"computed, each bit-equal to the full launch's (fast and masked)")
        del src, data, q, qt, qn, valid, maskadd, bias
    print(f"  max |kernel - plain| on live windows, {rows} rows: fast {worst['fast']} "
          f"({ratios['fast']:.4f} of the budget), masked {worst['masked']} "
          f"({ratios['masked']:.4f}); masked windows exactly 3e38")
    return worst, ratios


# the sweep kernel's programs: the bf16 mirror's light and heavy ones, an int8 mirror's
# one pass, two_pass, and two_pass with the second stream (the engine's), the f32 mirror's;
# each with the per-row bound rows the certificate plan folds into it
PROGRAMS = {"light": ("err1", "sqn_sqrt"), "heavy": ("sweep_err", "err1"),
            "int8_light": ("err1", "sqn_sqrt"), "int8_two_pass": ("sweep_err",),
            "int8_resid": ("sweep_err", "err1"), "f32": ()}


def _sweep_operands(data, q, valid, metric, program):
    """Kernel B1/B3's operands as the certified search builds them (fused_knn_t._fused_t)
    for ``program`` (a key of PROGRAMS): the folded query, the bias/scale rows of
    ``valid``, the residual codes and multiplier, and the certificate bound rows with
    their per-query scales.  Returns (args, kwargs for r1 = 32 with the block mins,
    per-query slack)."""
    n = data.shape[0]
    wb = PROGRAMS[program]
    mirror_dtype = (torch.float32 if program == "f32" else torch.int8
                    if program.startswith("int8") else torch.bfloat16)
    resid = program in ("heavy", "int8_resid")
    if mirror_dtype == torch.bfloat16:
        z, s, e2, e1 = fused_knn_t.quantize_resid_rows(data)
        mirror, s2 = data.to(torch.bfloat16), None
    else:
        mirror, s, z, s2, e2, e1 = fused_knn_t.quantize_int8_resid_rows(data)
        mirror = data if program == "f32" else mirror
    prep = fused_knn_t._prep_terms(valid, (data * data).sum(-1), n, s, e2, e1, cap=n,
                                   metric=metric, masked=True, use_resid=resid,
                                   wb_sources=wb, rscale2=s2,
                                   int8_sweep=mirror_dtype == torch.int8)
    qh, qres, qres_f32 = fused_knn_t._fold_query(q, metric, program.endswith("light"),
                                                 mirror_dtype)
    qh_l2 = torch.linalg.vector_norm(q, dim=1) * (2.0 if metric == "l2" else 1.0)
    qe = torch.stack([qh_l2, torch.linalg.vector_norm(qres_f32, dim=1)], 1)[:, :len(wb)]
    args = (qh, qres, mirror, z if resid else None, prep["rscale_row"], prep["scale_row"],
            prep["bias_row"])
    kw = dict(r1=32, emit_block_mins=True, qe=qe.contiguous() if wb else None,
              eb_rows=prep["eb_rows"])
    slack = D * 2.0 ** -22 * qh_l2 * (1.0 if metric == "cosine" else prep["maxd"])
    return args, kw, slack


def check_sweep_kernels(db_np):
    """Phase 4: the sweep window-min kernel (light and heavy, l2/ip/cosine, at r1 = 32 with
    the block mins, as the k=10 path runs it) and the gather-score kernel against their
    plain versions.  Live windows within the per-element phase-1 budget (the tensor
    cores' Dp * 2^-23 and the plain version's Dp * 2^-24 of |a||b| per pass, inside the
    certificate's slack Dp * 2^-22 * |qh| * maxd); fully masked windows exactly 3e38; the
    block mins the kernel's own mins' min; at 2^20 rows and B = 512 with 128 live queries
    the live-column launch bit-equal to the full one; the rescan's dots and norms within
    Dp * 2^-24 * (|q| |row| + |row|^2).  Returns max |err|."""
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    worst = {"light": 0.0, "heavy": 0.0, "gather": 0.0, "light_ratio": 0.0, "heavy_ratio": 0.0}
    for n in (65536, N):
        data = torch.from_numpy(db_np[:n]).to(dev)
        q = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)   # ~1% tombstones
        valid[-fused_knn_t.SWEEP_TILE:] = False                    # a fully masked tile
        for heavy in (False, True):
            name = "heavy" if heavy else "light"
            for metric in ("l2", "ip", "cosine"):
                args, kw, slack = _sweep_operands(data, q, valid, metric, name)
                got = fused_knn_t._window_mins_t(*args, **kw)
                want = fused_knn_t._window_mins_t_ref(*args, **kw)
                budget = _budget(args, kw)
                torch.cuda.synchronize()
                label = f"sweep n={n} {name} {metric}"
                if not bool((want[0] == float(MASKED)).any()) or not bool(
                        (budget <= slack[None, :, None]).all()):
                    raise AssertionError(f"{label}: no dead tile, or the budget above the slack")
                for g, w, bd in zip(got[:2], want[:2], (budget, budget.amax(-1))):
                    err, ratio = _check_budget(g, w, bd, label)
                    worst[name] = max(worst[name], err)
                    worst[name + "_ratio"] = max(worst[name + "_ratio"], ratio)
                if not _bits_equal(got[1], got[0].amin(-1)):
                    raise AssertionError(f"{label}: block mins are not the kernel's own mins'")
                if n == N and metric == "l2":
                    qz = q.clone()
                    qz[B:] = 0.0                   # the engine's padding of B=128 to 512
                    za, zkw, _ = _sweep_operands(data, qz, valid, metric, name)
                    cols = _check_live_tiles(za, zkw, B, label)
                    print(f"  {label}: B=512 with {B} live queries: {cols} columns computed, "
                          f"every column bit-equal to the full launch")
                del args, kw, got, want, budget
        del data, q, valid
    data = torch.from_numpy(db_np).to(dev)
    q = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
    f = torch.sort(torch.randint(0, N // 32, (512, 32), device=dev), 1).values.to(torch.int32)
    worst["gather"] = _check_gather((q, data, f), {"r1": 32}, "gather_score")
    # the engine's padding of B=128 to 512: zero queries over one row's windows
    q[B:] = 0.0
    f[B:] = f[B]
    _check_gather_live((q, data, f), {"r1": 32, "n_live": B}, "gather_score B=512, 128 live")
    print(f"  max |kernel - plain|: sweep light {worst['light']} ({worst['light_ratio']:.3f} "
          f"of the budget), sweep heavy {worst['heavy']} ({worst['heavy_ratio']:.3f}) (live "
          f"windows; masked exactly 3e38); gather_score {worst['gather']} (bound "
          f"Dp*2^-24*(|q||row| + |row|^2)); the live-row launch bit-equal to the full one")
    return worst


# ---- kernel B2, the rescan ----------------------------------------------------------------

def _check_gather(a, kw, label):
    """B2 against its plain version on the same call: dots and norms within
    Dp * 2^-24 * (|q||row| + |row|^2) (the same f32 sums in another order).  Returns
    max |err|."""
    dots, sqn = fused_knn_t._gather_score(*a, **kw)
    want_dots, want_sqn = fused_knn_t._gather_score_ref(*a, **kw)
    torch.cuda.synchronize()
    q = a[0]
    bound = q.shape[1] * 2.0 ** -24 * (torch.linalg.vector_norm(q, dim=1)[:, None]
                                       * want_sqn.sqrt() + want_sqn)
    worst = 0.0
    for got, want in ((dots, want_dots), (sqn, want_sqn)):
        err = (got - want).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"{label}: |err| / bound {float((err / bound).max())}")
        worst = max(worst, float(err.max()))
    return worst


def _check_gather_live(a, kw, label):
    """B2's launch over the live rows (and the first padded one, copied to the rest)
    against its launch over every row: bit-equal.  Returns the candidate rows the live
    launch computed (its ``.rows`` delta)."""
    fn = fused_knn_t._gather_score
    full = fn(*a, **{k: v for k, v in kw.items() if k != "n_live"})
    rows = fn.rows
    live = fn(*a, **kw)
    rows = fn.rows - rows
    torch.cuda.synchronize()
    if not all(_bits_equal(x, y) for x, y in zip(live, full)):
        raise AssertionError(f"{label}: the live-row launch differs from the full one")
    return rows


def _gather_bound(a, kw, full_batch=False):
    """B2's bound: each candidate row of the live queries (``full_batch``: of every query
    of the padded batch) read once, its dot and norm written once, the queries and window
    ids read once, over the HBM rate; or its 4 flops a row element (the dot's and the
    norm's FMA) over the f32 peak."""
    q, data, f = a
    n_q = f.shape[0] if full_batch or kw.get("n_live") is None else kw["n_live"]
    rows = n_q * f.shape[1] * kw["r1"]
    return _bound(n_q * (q.shape[1] * 4 + f.shape[1] * 4)
                  + rows * (data.shape[1] * data.element_size() + 8),
                  4.0 * rows * data.shape[1], F32_FLOPS)


# the candidate rows each timed live B2 launch computed (its .rows delta), and the max
# |kernel - plain| of its full launch, by time name
TIMED_ROWS, GATHER_ERR = {}, {}


def time_gather(name, a, kw):
    """B2 at the operands ``a``, ``kw`` the engine gave it (the live count included): the
    full launch within Dp * 2^-24 * (|q||row| + |row|^2) of its plain version (every row
    computed), the live launch bit-equal to the full one, the candidate rows the timed live
    launch
    computed, the times of the live launch, of the full launch (every row of the padded
    batch), of the plain version on the same call and of ``data.index_select`` over the
    same rows (the gather alone, a yardstick the port never calls), and the bound at the
    live queries and at the padded batch.  The kernels' and index_select's times are
    taken with the L2 cache flushed before each call, as the engine's rescan finds it
    after phase 1 streamed the mirror (``_hot``: back to back).  Returns ({time name: ms},
    {bound name: bound}, rows computed, max |err|)."""
    q, data, f = a
    r1 = kw["r1"]
    err = GATHER_ERR[name] = _check_gather(a, {"r1": r1}, name)
    rows = TIMED_ROWS[name] = _check_gather_live(a, kw, name)
    n_c = fused_knn_t._gather_rows(f.shape[0], kw.get("n_live"))
    if rows != n_c * f.shape[1] * r1:
        raise AssertionError(f"{name}: the live launch computed {rows} rows")
    w = torch.clamp(f[:n_c].long(), 0, data.shape[0] // r1 - 1)
    idx = (w[:, :, None] * r1 + torch.arange(r1, device=f.device)).reshape(-1)
    full_kw = {k: v for k, v in kw.items() if k != "n_live"}
    times = {name: _time_cold_ms(lambda: fused_knn_t._gather_score(*a, **kw)),
             name + "_full": _time_cold_ms(lambda: fused_knn_t._gather_score(*a, **full_kw)),
             name + "_plain": _time_ms(lambda: fused_knn_t._gather_score_ref(*a, **kw)),
             name + "_index_select": _time_cold_ms(lambda: data.index_select(0, idx)),
             name + "_hot": _time_ms(lambda: fused_knn_t._gather_score(*a, **kw))}
    bounds = {name: _gather_bound(a, kw), name + "_full_batch": _gather_bound(a, kw, True)}
    ms, bd, bf = times[name], bounds[name], bounds[name + "_full_batch"]
    print(f"  B2 {name}: {f.shape[0]} queries ({kw.get('n_live')} live), s1={f.shape[1]}, "
          f"r1={r1}, D={data.shape[1]}, {data.dtype} rows: max |kernel - plain| {err} (within "
          f"the bound), {rows} candidate rows computed (.rows); live {ms:.4f} ms ({bd[2] / ms / 1e6:.1f} GB/s), full "
          f"{times[name + '_full']:.4f} ms ({bf[2] / times[name + '_full'] / 1e6:.1f} GB/s), "
          f"plain {times[name + '_plain']:.4f} ms, index_select of the live rows "
          f"{times[name + '_index_select']:.4f} ms (L2 flushed before each call; the live "
          f"launch back to back {times[name + '_hot']:.4f} ms); bound {bd[0]:.4f} ms ({bd[1]}) "
          f"[{bf[0]:.4f} at the padded batch], the live launch at {bd[0] / ms:.1%} of it, "
          f"the full at {bf[0] / times[name + '_full']:.1%} of its own")
    return times, bounds, rows, err


def check_gather_wide():
    """B2 at Dp = 1536 over 2^18 gaussian rows made on the card (f32, and the same rounded
    to bf16), where a row is wider than a stage's share: B = 512 with 128 live queries
    (the rest zero over one row's windows), 32 windows of 32 rows a query (repeats and
    out-of-range ids included): within the bound of the plain version, the live launch
    bit-equal to the full one, timed with its bound.  Returns {kernel key: record}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = torch.randn((WIDE_ROWS, WIDE_DP), generator=g, device=dev)
    q = torch.randn((512, WIDE_DP), generator=g, device=dev)
    q[B:] = 0.0
    f = torch.randint(-2, WIDE_ROWS // 32 + 2, (512, 32), generator=g, device=dev)
    f[:, 1] = f[:, 0]
    f = torch.sort(f, 1).values.to(torch.int32)
    f[B:] = f[B]
    out = {}
    for rows, key in ((torch.float32, "gather_score"), (torch.bfloat16, "gather_bf16")):
        a, kw = (q, x.to(rows), f.contiguous()), {"r1": 32, "n_live": B}
        times, bounds, n_rows, err = time_gather(f"{key}_dp{WIDE_DP}", a, kw)
        name = f"{key}_dp{WIDE_DP}"
        out[key] = {"dim": WIDE_DP, "rows": WIDE_ROWS, "r1": 32, "s1": 32, "max_abs_err": err,
                    "rows_computed": n_rows, "ms": times[name],
                    "full_launch_ms": times[name + "_full"], "plain_ms": times[name + "_plain"],
                    "index_select_ms": times[name + "_index_select"],
                    "hot_ms": times[name + "_hot"],
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                    "bound_full_batch_ms": bounds[name + "_full_batch"][0]}
        del a
    return out


def _check_result_live(search, label):
    """The engine's search with the live count (phase 1 on the live columns, B2 on the
    live rows) against the same search without it: every row's distances, the live rows'
    ids, the per-query proof and the tier equal; then the same after the proof is read
    (escalation included).  ``search(n_live)`` returns the deferred SweepResult."""
    live, full = search(B), search(None)
    same = (_bits_equal(live.dist, full.dist) and torch.equal(live.idx[:B], full.idx[:B])
            and live.tier == full.tier and (live.okq is None) == (full.okq is None)
            and (full.okq is None or torch.equal(live.okq, full.okq)))
    (ld, li, lt), (fd, fi, ft) = live.resolve(), full.resolve()
    if not (same and _bits_equal(ld, fd) and torch.equal(li[:B], fi[:B]) and lt == ft):
        raise AssertionError(f"{label}: the search with the live count differs from the one "
                             f"without it")
    print(f"  {label}: the SweepResult with n_live={B} equals the one without (tier {lt})")


def _check_kdists(results, db64, q, label):
    """Sorted returned l2 distances against the float64 oracle's k smallest, within the
    f32 cancellation of the expansion qn + sqn - 2 q.x (16 ulps of qn + max sqn at
    D = 128, growing as sqrt(D / 128) with the rounding of the D-term f32 sums), since
    ties on clustered data make id sets ambiguous."""
    want = np.sort(_oracle_dists(db64, q, "l2"), axis=1)[:, :K]
    got = np.sort(np.array([[r["score"] for r in rs] for rs in results]), axis=1)
    tol = 16 * max(1.0, (q.shape[1] / 128) ** 0.5) * 2.0 ** -24 * (
        (q.astype(np.float64) ** 2).sum(-1) + (db64 ** 2).sum(-1).max())
    err = np.abs(got - want)
    print(f"  {label}: max |k-dist - oracle| = {err.max():.3e} (bound {tol.max():.3e})")
    if got.shape != want.shape or not (err <= tol[:, None]).all():
        raise AssertionError(f"{label}: k-distances differ from the oracle")


def run_sweep_path(db_np, q_np, oracle, dead, self_row, before_delete):
    """Phase 5: the certified sweep path through QueryProcessor; ``before_delete(qp, ids)``
    runs phase 7's searches before the deletes and returns the tier counts they added.
    Returns the processor and the namespace's ids."""
    dev = torch.device("cuda")
    qp = QueryProcessor(SWEEP, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db_np, "sift")
    torch.cuda.synchronize()
    ns = qp.storage.namespace("sift")
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, capacity "
          f"{ns.capacity}, device bytes {ns.nbytes:,}")
    x0 = _xfer_mark(qp)
    res = qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "sift", "l2")
    xfer = _xfer(qp, x0)
    print(f"  transfers per search (h2d, d2h): {xfer}, tiers {qp.cert_tier_counts('sift')}")
    if xfer != (1, 1):
        raise AssertionError(f"transfer rule broken: {xfer}")
    _check_recall(res, oracle.sets("l2", B), ids, "sweep l2 B=128")
    for metric in ("ip", "cosine"):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:16]], K, "sift", metric)
        _check_recall(res, oracle.sets(metric, 16), ids, f"sweep {metric} B=16")
    k100_tiers = before_delete(qp, ids)
    removed = qp.delete([ids[i] for i in dead], "sift")
    if len(removed) != 1000 or ns.device_state().live_count == ns.device_state().high_water:
        raise AssertionError("delete did not leave tombstones")
    dead_ids = {ids[i] for i in dead}
    for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], K, "sift", metric)
        if any(r["id"] in dead_ids for rs in res for r in rs):
            raise AssertionError(f"sweep {metric}: a deleted id was returned")
        _check_recall(res, oracle.sets(metric, nq, dead), ids,
                      f"sweep {metric} B={nq} after delete")
    tiers = {name: n - k100_tiers.get(name, 0)
             for name, n in qp.cert_tier_counts("sift").items() if n != k100_tiers.get(name, 0)}
    print(f"  certificate tiers, gaussian namespace (k=10 searches): {tiers}")
    if tiers != {"light_fast": 6}:
        raise AssertionError(f"the light program did not serve every batch at tier 0: {tiers}")
    self_hit = qp.find_similar(VectorDTO(db_np[self_row]), 1, "sift", "l2")
    bound = 16 * 2.0 ** -24 * 2 * float((db_np[self_row].astype(np.float64) ** 2).sum())
    print(f"  self query (row {self_row}): score {self_hit[0]['score']} (f32 expansion "
          f"bound {bound:.3e})")
    if self_hit[0]["id"] != ids[self_row] or not self_hit[0]["score"] <= bound:
        raise AssertionError(f"stored row {self_row} queried as itself returned {self_hit[:1]}")

    # clustered: neighbour gaps far below the light program's bf16 band
    rng = np.random.default_rng(SEED + 3)
    centres = rng.standard_normal((8, D)).astype(np.float32) * 0.05
    xc = (centres[rng.integers(0, 8, 131072)]
          + rng.standard_normal((131072, D)).astype(np.float32) * 1e-3).astype(np.float32)
    qc = (centres[rng.integers(0, 8, 2 * B)]
          + rng.standard_normal((2 * B, D)).astype(np.float32) * 1e-3).astype(np.float32)
    xc64 = xc.astype(np.float64)
    qp.bulk_load(xc, "clustered")
    for i, label in enumerate(("first batch (light)", "second batch (after the flip)")):
        qb = qc[i * B:(i + 1) * B]
        before = qp.cert_tier_counts("clustered")
        x0 = _xfer_mark(qp)
        res = qp.find_similar_batch([VectorDTO(v) for v in qb], K, "clustered", "l2")
        after = qp.cert_tier_counts("clustered")
        served = [t for t in after if after[t] != before.get(t, 0)]
        xfer = _xfer(qp, x0)
        print(f"  clustered {label}: tier {served}, transfers {xfer}, mode "
              f"{qp._cert_mode.get(('clustered', 'l2', False), 'light')}")
        _check_kdists(res, xc64, qb, f"clustered {label}")
        if i == 0 and (served != ["light_exact_scan"]
                       or qp._cert_mode.get(("clustered", "l2", False)) != "heavy"):
            raise AssertionError("the light program did not escalate and flip to heavy")
        if i == 1 and any(t.startswith("light_") for t in served):
            raise AssertionError("the second clustered batch did not run the heavy program")
    return qp, ids


@contextlib.contextmanager
def _spying(fn_name, record, module=fused_knn_t):
    """Route <module>.<fn_name> through a spy that hands each call's (args, kwargs,
    result) to ``record``.  The wrapper counts its launches on the module attribute, which
    is the spy meanwhile, so the counts move to the spy and back."""
    real = getattr(module, fn_name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        record(a, kw, out)
        return out

    spy.__dict__.update(real.__dict__)
    setattr(module, fn_name, spy)
    try:
        yield
    finally:
        setattr(module, fn_name, real)
        real.__dict__.update(spy.__dict__)


def _capture(fn_name, call, module=fused_knn_t):
    """The positional and keyword arguments of the first call of <module>.<fn_name> made
    by ``call()``: the kernel's operands at the main path's shapes."""
    seen = []
    with _spying(fn_name, lambda a, kw, out: seen.append((a, kw)), module):
        call()
    return seen[0]


# ---- phase 7: the k-bucket-128 certified sweep program ---------------------------------

_SWEEP_COUNTERS = ((fused_knn_t._window_mins_t, "launches"),
                   (fused_knn_t._window_mins_t, "launches_heavy"),
                   (fused_knn_t._window_mins_t, "launches_topm"),
                   (fused_knn_t._gather_score, "launches"),
                   (fused_knn_t._window_mins_t, "launches_int8"),
                   (fused_knn_t._window_mins_t, "launches_f32"),
                   (fused_knn_t._gather_score, "launches_bf16"),
                   (fused_knn_t._window_mins_t, "launches_bp"),
                   (fused_knn_t._window_mins_t, "cols"),
                   (fused_knn_t._window_mins_t, "launches_zero"),
                   (fused_knn_t._gather_score, "rows"))
# "cols": the query columns the sweep kernel's launches computed; "zero": the launches that
# filled a snapshot's zero-query cache; "gather_rows": the candidate rows B2 computed
_COUNT_NAMES = ("sweep", "sweep_heavy", "topm", "gather", "int8", "f32", "gather_bf16", "bp",
                "cols", "zero", "gather_rows")


def _sweep_counts():
    return [getattr(fn, name) for fn, name in _SWEEP_COUNTERS]


def _set_sweep_counts(values):
    for (fn, name), v in zip(_SWEEP_COUNTERS, values):
        setattr(fn, name, v)


def check_pool_kernel(db_np):
    """Phase 7: the sweep kernel's top-m pool (r1 = 16, m = 8: the k bucket 128 at 2^20
    rows) against its plain version: B = 512 pool only (skip_wm, the engine's B=128
    bucket) and B = 8 window mins plus pool (range search), light and heavy, l2/ip/cosine,
    ~1% tombstones and a dead tile.  The pool bit-equal (values, packed positions,
    padding) to the plain pool of the kernel's own window mins; those mins within the
    phase-1 budget of the plain version's, as in phase 4 (near-ties may reorder against
    the plain pool: counted, not failed).  Returns the worst differences."""
    rng = np.random.default_rng(SEED + 5)
    dev = torch.device("cuda")
    worst = {"value": 0.0, "positions": 0, "wmin": 0.0, "ratio": 0.0}
    for n in (65536, N):
        data = torch.from_numpy(db_np[:n]).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)   # ~1% tombstones
        valid[-fused_knn_t.SWEEP_TILE:] = False                    # a fully masked tile
        for b, skip in ((512, True), (8, False)):
            q = torch.from_numpy(rng.standard_normal((b, D), dtype=np.float32)).to(dev)
            for heavy in (False, True):
                for metric in ("l2", "ip", "cosine"):
                    args, kw, _ = _sweep_operands(data, q, valid, metric,
                                                      "heavy" if heavy else "light")
                    kw.update(r1=16, emit_block_mins=False, emit_topm=8)
                    wmin, bm, pool = fused_knn_t._window_mins_t(*args, skip_wm=skip, **kw)
                    own = wmin if wmin is not None else fused_knn_t._window_mins_t(
                        *args, **{**kw, "emit_topm": 0})[0]
                    want_wmin, _, want = fused_knn_t._window_mins_t_ref(*args, **kw)
                    torch.cuda.synchronize()
                    label = f"pool n={n} B={b} heavy={heavy} {metric}"
                    if (wmin is None) != skip or bm is not None:
                        raise AssertionError(f"{label}: wrong outputs")
                    if not _bits_equal(pool, fused_knn_t._topm_pool_ref(own, 8)):
                        raise AssertionError(f"{label}: the pool is not the kernel's own mins'")
                    gv, gp = fused_knn_t._decode_topm(pool, 8, 256)
                    wv, wp = fused_knn_t._decode_topm(want, 8, 256)
                    worst["value"] = max(worst["value"], float((gv - wv).abs().max()))
                    worst["positions"] += int((gp != wp).sum())
                    err, ratio = _check_budget(own, want_wmin, _budget(args, kw), label)
                    worst["wmin"] = max(worst["wmin"], err)
                    worst["ratio"] = max(worst["ratio"], ratio)
                    if n == N and b == 512 and metric == "l2":
                        qz = q.clone()
                        qz[B:] = 0.0
                        za, zkw, _ = _sweep_operands(data, qz, valid, metric,
                                                     "heavy" if heavy else "light")
                        zkw.update(r1=16, emit_block_mins=False, emit_topm=8, skip_wm=True)
                        cols = _check_live_tiles(za, zkw, B, label)
                        print(f"  {label}: {B} live queries: {cols} columns computed, every "
                              f"column bit-equal to the full launch")
                    del args, kw, wmin, pool, want_wmin, want, own
        del data, valid, q
    print(f"  pool kernel: bit-equal to the plain pool of its own mins; against the plain "
          f"version's pool max |value err| {worst['value']}, differing positions "
          f"{worst['positions']} (near-ties); window mins max |err| {worst['wmin']} "
          f"({worst['ratio']:.3f} of the budget)")
    return worst


def run_k100_searches(qp, ids, q_np, oracle, dead, when):
    """Phase 7: find_similar_batch at k=100 on the phase-5 namespace (k bucket 128 at
    2^20 rows: r1 = 16, m = 8; every bucket here is too wide for tier 2, so the kernel
    writes the pool only).  l2 at B=128, ip and cosine at B=16, each set-exact against the
    float64 oracle.  The l2 batch (the main path) must be served by the light program at
    tier 0 with transfers (1, 1).  An ip or cosine batch may instead fail a light proof and
    then must be served by the exact scan with transfers (1, 2): which batch escalates is
    the port's own reading of its certificate (the CPU tests hold that reading to the JAX
    package's on smaller corpora).  The sweep counters are zeroed just before the engine's
    searches and read just after, then the enclosing path's counts are put back.  Returns
    (the tier counts these searches added, their launch counts)."""
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    tiers0 = qp.cert_tier_counts("sift")
    programs = []   # (batch, m, skip_wm, window mins written) per kernel call
    served = {}

    def record(a, kw, out):
        programs.append((a[0].shape[0], kw["emit_topm"], kw["skip_wm"], out[0] is not None))

    with _spying("_window_mins_t", record):
        for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
            x0, t0 = _xfer_mark(qp), qp.cert_tier_counts("sift")
            res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], K100, "sift",
                                        metric)
            xfer = _xfer(qp, x0)
            tier = [t for t, n in qp.cert_tier_counts("sift").items() if n != t0.get(t, 0)]
            served[metric] = (tier, xfer)
            if (tier, xfer) != (["light_fast"], (1, 1)) and (
                    metric == "l2" or (tier, xfer) != (["light_exact_scan"], (1, 2))):
                raise AssertionError(f"k=100 {metric} {when}: served by {tier}, transfers "
                                     f"{xfer}")
            _check_recall(res, oracle.sets(metric, nq, dead, k=K100), ids,
                          f"k=100 {metric} B={nq} {when}", k=K100)
    counts = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts(outer)
    tiers = {name: n - tiers0.get(name, 0) for name, n in qp.cert_tier_counts("sift").items()
             if n != tiers0.get(name, 0)}
    print(f"  k=100 {when}: (tier, transfers) per batch {served}, kernel calls (batch, m, "
          f"skip_wm, window mins written) {programs}, launches {counts}")
    if counts["topm"] < 1 or counts["gather"] < 1 or any(
            not p[1] or not p[2] or p[3] for p in programs):
        raise AssertionError(f"k=100 {when}: the pool-only program did not serve: {programs}")
    if counts["cols"] != B + 16 + 16:
        raise AssertionError(f"k=100 {when}: {counts['cols']} query columns computed, not the "
                             f"live {B + 32}")
    return tiers, counts


def check_range_search(qp, ids, q_np, oracle, dead):
    """Phase 7: range_search (limit 100: k bucket 128 at B bucket 8, the pool beside the
    window mins; the default limit 1000: r1 = 4) and similarity_search against the
    oracle's hits within the radius, set halfway between its 50th and 51st live hit.
    Returns the host ms of 5 range searches at limit 100."""
    dead_set = set(np.asarray(dead).tolist())
    want = {}
    for metric, nq in (("l2", B), ("cosine", 16)):     # distances phase 3 computed
        rows, dist = oracle.nearest(metric, nq)
        live = [(r, d) for r, d in zip(rows[0].tolist(), dist[0].tolist()) if r not in dead_set]
        want[metric] = ({ids[r] for r, _ in live[:50]}, (live[49][1] + live[50][1]) / 2)
    q0 = VectorDTO(q_np[0])
    radius = want["l2"][1]
    threshold = 1.0 - want["cosine"][1]
    calls = {"range limit=100": lambda: qp.range_search(q0, radius, "sift", "l2", limit=100),
             "range limit=1000": lambda: qp.range_search(q0, radius, "sift", "l2"),
             "similarity": lambda: qp.similarity_search(q0, threshold, "sift"),
             "similarity limit=100": lambda: qp.similarity_search(q0, threshold, "sift",
                                                                  limit=100)}
    for label, call in calls.items():
        metric = "cosine" if label.startswith("similarity") else "l2"
        hits = call()
        got = {h["id"] for h in hits}
        print(f"  {label}: {len(hits)} hits, equal to the oracle's: {got == want[metric][0]}")
        if got != want[metric][0] or len(hits) != 50:
            raise AssertionError(f"{label}: hits differ from the oracle's")
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        calls["range limit=100"]()
        wall.append((time.perf_counter() - t0) * 1e3)
    return wall


def check_nan_query(db_np):
    """Phase 7: a B=8 batch with one NaN query at 2^16 rows, light and heavy, k=10 and
    k=100.  The kernel's mins are NaN exactly where the plain version's are (jnp.minimum's
    rule; the pool's NaN rows), and exact_knn_t reports tier 2 on the card as on the CPU."""
    n = 65536
    rng = np.random.default_rng(SEED + 6)
    q = rng.standard_normal((8, D), dtype=np.float32)
    q[2, 5] = np.nan
    dev = torch.device("cuda")
    for light in (True, False):
        for k in (10, 100):
            tiers = []
            for device in ("cpu", dev):
                data = torch.from_numpy(db_np[:n]).to(device)
                z, s, e2, e1 = fused_knn_t.quantize_resid_rows(data)
                _, _, tier = fused_knn_t.exact_knn_t(
                    torch.from_numpy(q).to(device), data.to(torch.bfloat16), data,
                    torch.ones(n, dtype=torch.bool, device=device), (data * data).sum(-1),
                    k=k, metric="l2", live_prefix=n, sweep_err=e2, resid=z, rscale=s,
                    err1=e1, light=light, report_tier=True)
                tiers.append(tier)
            args, kw, _ = _sweep_operands(data, torch.from_numpy(q).to(dev),
                                          torch.ones(n, dtype=torch.bool, device=dev), "l2",
                                          "light" if light else "heavy")
            if k == 100:
                kw.update(r1=16, emit_block_mins=False, emit_topm=8)
            got = fused_knn_t._window_mins_t(*args, **kw)
            want = fused_knn_t._window_mins_t_ref(*args, **kw)
            torch.cuda.synchronize()
            same = [torch.equal(torch.isnan(g), torch.isnan(w)) and bool(torch.isnan(w).any())
                    for g, w in zip(got, want) if w is not None]
            print(f"  NaN query, {'light' if light else 'heavy'} k={k}: tiers (cpu, cuda) "
                  f"{tiers}; NaN at the plain version's places in every output: {all(same)}")
            if tiers != [2, 2] or not all(same):
                raise AssertionError(f"NaN query light={light} k={k}: {tiers} {same}")


def check_window_min_nan(db_np, rows=torch.float32):
    """Phases 2 and 11: a NaN query through the row-major kernels over rows of type
    ``rows`` (2^16 rows, B = 8, r1 = 8, l2/ip/cosine, live prefix and tombstoned): its
    window mins are NaN exactly where the plain version's are (jnp.maximum /
    jnp.minimum's rule), the other queries' within the per-element budget."""
    n = 65536
    rng = np.random.default_rng(SEED + 7)
    dev = torch.device("cuda")
    data = torch.from_numpy(db_np[:n]).to(dev).to(rows)
    q = torch.from_numpy(rng.standard_normal((8, D), dtype=np.float32)).to(dev)
    q[3, 11] = float("nan")
    qt, qn = q.T.to(rows).float().contiguous(), (q * q).sum(-1)[None, :].contiguous()
    valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    valid[-fused_knn.DB_TILE:] = False
    maskadd = torch.where(valid, 0.0, float(MASKED))
    for metric in ("l2", "ip", "cosine"):
        kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=8)
        rows32 = data.float()
        bias = ((rows32 * rows32).sum(-1) + maskadd if metric == "l2" else maskadd)[:, None]
        bias = bias.contiguous()
        hw = n - fused_knn.DB_TILE - 1234
        live = [b for b in range(8) if b != 3]
        lt, ln = qt[:, live], qn[:, live]
        pairs = {"fast": (fused_knn._window_mins_fast(data, qt, qn, hw, **kw),
                          fused_knn._window_mins_fast_ref(data, qt, qn, hw, **kw),
                          fused_knn._phase1_budget(data, lt, ln, hw=hw, **kw)),
                 "masked": (fused_knn._window_mins_masked(data, qt, qn, bias, **kw),
                            fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw),
                            fused_knn._phase1_budget(data, lt, ln, bias=bias, **kw))}
        torch.cuda.synchronize()
        for name, (got, want, budget) in pairs.items():
            nan = torch.isnan(want)
            g, w = got[:, live], want[:, live]
            dead = w == float(MASKED)
            err = torch.where(dead, torch.zeros_like(g), (g - w).abs())
            ok = (torch.equal(torch.isnan(got), nan) and bool(nan[:, 3].any())
                  and not bool(nan[:, live].any()) and torch.equal(g[dead], w[dead])
                  and bool((err <= budget).all()))
            print(f"  NaN query, {name} {metric}, {rows} rows: NaN mins {int(nan.sum())} (plain) "
                  f"{int(torch.isnan(got).sum())} (kernel), at the same places: {ok}")
            if not ok:
                raise AssertionError(f"{name} {metric}: NaN query mins differ from plain")


# a wide embedding (the OpenAI width BASELINE.json names), where B4/B5 stream their query
# chunks; rows made on the card
WIDE_DP, WIDE_ROWS = 1536, 1 << 18


def check_wide_dims():
    """Phase 2: B4/B5 at Dp = 1536 over 2^18 gaussian rows (f32, and the same rounded to
    bf16), where the kernel streams its query chunks through shared memory: each variant
    and metric at B = 512 within the per-element budget of its plain version; at the
    engine's operands (128 live of the 512 bucket, l2, r1 from the padded batch, ~1%
    tombstones and a dead tile in B5's bias) the live launch bit-equal to the full one, its
    time, the full launch's and plain's, and the bound at the live columns and at the
    padded batch.  Returns {kernel key: record}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn((WIDE_ROWS, WIDE_DP), generator=g, device=dev)
    q = torch.randn((512, WIDE_DP), generator=g, device=dev)
    valid = torch.rand(WIDE_ROWS, generator=g, device=dev) > 0.01
    valid[-fused_knn.DB_TILE:] = False
    maskadd = torch.where(valid, 0.0, float(MASKED))
    sqn = (x * x).sum(-1)
    hw = WIDE_ROWS - fused_knn.DB_TILE - 1234
    r1 = fused_knn._pick_r1(512, WIDE_ROWS, 16)
    qz = q.clone()
    qz[B:] = 0.0                                 # the engine's padding of B=128 to 512
    out = {}
    for rows, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        data = x.to(rows)
        worst = {"fast": 0.0, "masked": 0.0}
        qt, qn = q.T.to(rows).float().contiguous(), (q * q).sum(-1)[None, :].contiguous()
        for metric in ("l2", "ip", "cosine"):
            kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=r1)
            bias = ((sqn + maskadd) if metric == "l2" else maskadd)[:, None].contiguous()
            for name, arg, side in (("fast", hw, {"hw": hw}), ("masked", bias, {"bias": bias})):
                fn = getattr(fused_knn, "_window_mins_" + name)
                ref = getattr(fused_knn, "_window_mins_" + name + "_ref")
                _, ratio = _check_budget(
                    fn(data, qt, qn, arg, **kw), ref(data, qt, qn, arg, **kw),
                    fused_knn._phase1_budget(data, qt, qn, **side, **kw),
                    f"{name}{tag} Dp={WIDE_DP} {metric}")
                worst[name] = max(worst[name], ratio)
        zt, zn = qz.T.to(rows).float().contiguous(), (qz * qz).sum(-1)[None, :].contiguous()
        kw = dict(metric="l2", db_tile=fused_knn.DB_TILE, r1=r1, n_live=B)
        for name, arg in (("fast", WIDE_ROWS), ("masked", (sqn + maskadd)[:, None].contiguous())):
            key, a = name + tag, (data, zt, zn, arg)
            times, cols = _time_b4(key, "_window_mins_" + name, a, kw)
            bound, full = _b4_bound(a, kw), _b4_bound(a, kw, full_batch=True)
            out[key] = {"dim": WIDE_DP, "rows": WIDE_ROWS, "r1": r1, "live_columns": cols,
                        "ms": times[key], "full_launch_ms": times[key + "_full"],
                        "plain_ms": times[key + "_plain"], "bound_ms": bound[0],
                        "bound_by": bound[1], "bound_full_batch_ms": full[0],
                        "max_err_over_budget": worst[name]}
            print(f"  Dp={WIDE_DP}, {WIDE_ROWS:,} {rows} rows: {name} within "
                  f"{worst[name]:.4f} of the budget (l2/ip/cosine, B=512); {cols} live columns "
                  f"of 512 {times[key]:.4f} ms, full launch {times[key + '_full']:.4f} ms, plain "
                  f"{times[key + '_plain']:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}) "
                  f"[{full[0]:.4f}], the kernel at {bound[0] / times[key]:.1%} of it")
            if cols != B:
                raise AssertionError(f"{key} Dp={WIDE_DP}: {cols} columns computed, not {B}")
        del data
    return out


# ---- phases 8 and 9: the int8 and f32 mirrors (kernel B3) -------------------------------

B3_PROGRAMS = ("int8_light", "int8_two_pass", "int8_resid", "f32")


def check_b3_kernels(db_np, programs):
    """Phases 8 and 9: kernel B3 against its plain version at the engine's shapes (2^20
    rows, B = 512: r1 = 32 with the block mins, the k = 10 program, and r1 = 16 with the
    pool only, the k = 100 one; 2^16 rows at B = 8: r1 = 16 window mins and pool),
    l2/ip/cosine, ~1% tombstones and a dead tile.  The window mins within the phase-1
    budget of the plain version's (int8: exact products, tensor-core sums; f32: the six
    products of the split, tensor-core sums), the block mins and the pool bit-equal to the
    plain min and pool of the kernel's own mins.  Returns {program: (max |err|, elements
    that differ from the plain version, max |err| / budget)}."""
    rng = np.random.default_rng(SEED + 8)
    dev = torch.device("cuda")
    worst = {p: [0.0, 0, 0.0] for p in programs}
    shapes = ((N, 512, dict(r1=32, emit_block_mins=True)),
              (N, 512, dict(r1=16, emit_block_mins=False, emit_topm=8, skip_wm=True)),
              (65536, 8, dict(r1=16, emit_block_mins=False, emit_topm=8)))
    for n, b, opts in shapes:
        data = torch.from_numpy(db_np[:n]).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, D), dtype=np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)
        valid[-fused_knn_t.SWEEP_TILE:] = False
        for program in programs:
            for metric in ("l2", "ip", "cosine"):
                args, kw, _ = _sweep_operands(data, q, valid, metric, program)
                kw.update(opts)
                got = fused_knn_t._window_mins_t(*args, **kw)
                want = fused_knn_t._window_mins_t_ref(*args, **{**kw, "skip_wm": False})
                torch.cuda.synchronize()
                label = f"B3 {program} n={n} B={b} {opts} {metric}"
                own = got[0]
                if own is None:
                    own = fused_knn_t._window_mins_t(
                        *args, **{**kw, "emit_topm": 0, "skip_wm": False})[0]
                if not bool((want[0] == float(MASKED)).any()):
                    raise AssertionError(f"{label}: no masked window")
                budget = _budget(args, kw)
                err, ratio = _check_budget(own, want[0], budget, label)
                unequal = int((own.view(torch.int32) != want[0].view(torch.int32)).sum())
                for g, w in zip(got[1:], want[1:]):
                    if g is not None:
                        unequal += int((g.view(torch.int32) != w.view(torch.int32)).sum())
                if got[1] is not None:
                    _check_budget(got[1], want[1], budget.amax(-1), label)
                    if not _bits_equal(got[1], own.amin(-1)):
                        raise AssertionError(f"{label}: block mins are not the kernel's own")
                if got[2] is not None and not _bits_equal(
                        got[2], fused_knn_t._topm_pool_ref(own, opts["emit_topm"])):
                    raise AssertionError(f"{label}: the pool is not the kernel's own mins'")
                worst[program][0] = max(worst[program][0], err)
                worst[program][1] += unequal
                worst[program][2] = max(worst[program][2], ratio)
                del args, kw, got, want, own, budget
        del data, q, valid
    for program, (err, unequal, ratio) in worst.items():
        print(f"  B3 {program} vs plain: max |err| {err} ({ratio:.3f} of the budget), "
              f"elements not bit-equal {unequal}; block mins and pool the kernel's own")
    return worst


def check_b3_f32_wide(dim=2048, n=1 << 16, b=128, n_live=16):
    """Phase 9: B3 over an f32 mirror where neither query tile's three parts fit in shared
    memory (Dp > 1280) and the query streams: ``n`` x ``dim`` gaussian rows made on the
    card, ~1% tombstones and a dead tile, ``b`` queries of which ``n_live`` are live (the
    rest zero), l2, r1 = 32 with the block mins.  The full launch's window mins (the
    64-query tile) within the phase-1 budget of the plain version's, its block mins the
    kernel's own, the live launch (the 16-query tile) bit-equal to it.  Returns (max
    |err|, max |err| / budget)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    data = torch.randn((n, dim), generator=gen, device="cuda")
    q = torch.zeros((b, dim), device="cuda")
    q[:n_live] = torch.randn((n_live, dim), generator=gen, device="cuda")
    valid = torch.rand(n, generator=gen, device="cuda") > 0.01
    valid[-fused_knn_t.SWEEP_TILE:] = False
    args, kw, _ = _sweep_operands(data, q, valid, "l2", "f32")
    label = f"B3 f32 Dp={dim} n={n} B={b}"
    full = fused_knn_t._window_mins_t(*args, **kw)
    want = fused_knn_t._window_mins_t_ref(*args, **kw)
    err, ratio = _check_budget(full[0], want[0], _budget(args, kw), label)
    if not _bits_equal(full[1], full[0].amin(-1)):
        raise AssertionError(f"{label}: block mins are not the kernel's own")
    cols = _check_live_tiles(args, kw, n_live, label)
    print(f"  {label} (the query streamed): max |err| {err} ({ratio:.3f} of the "
          f"budget), block mins the kernel's own, the live launch ({cols} columns) bit-equal "
          f"to the full one")
    return err, ratio


def run_mirror_path(cfg, label, db_np, q_np, oracle, dead):
    """Phases 8 and 9: QueryProcessor(cfg) at SIFT-1M shape: bulk_load, then l2 at B=128
    and ip and cosine at B=16, each at k = 10 and k = 100, then 1,000 deletes and the
    same searches again, each set-exact against the oracle.  The launch counts are zeroed
    just before the searches and read just after (the outer counts put back).  Every batch
    served at tier 0 came with transfers (1, 1); an escalation is reported, never hidden
    (recall holds its correctness).  No light_ tier: an int8 or f32 store has one
    program.  Returns (processor, ids, launch counts, per-batch (tier, transfers))."""
    dev = torch.device("cuda")
    qp = QueryProcessor(cfg, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db_np, "sift")
    torch.cuda.synchronize()
    ns = qp.storage.namespace("sift")
    st = ns.device_state()
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, capacity "
          f"{ns.capacity}, device bytes {ns.nbytes:,} (mirror {st.mirror.dtype}, the row "
          f"store itself: {st.mirror is st.data})")
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    served = {}
    for when, dead_rows in (("before delete", None), ("after delete", dead)):
        if dead_rows is not None:
            removed = qp.delete([ids[i] for i in dead_rows], "sift")
            if len(removed) != 1000 or ns.device_state().live_count == ns.device_state().high_water:
                raise AssertionError(f"{label}: delete did not leave tombstones")
        for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
            for k in (K, K100):
                x0, t0_ = _xfer_mark(qp), qp.cert_tier_counts("sift")
                res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], k, "sift",
                                            metric)
                xfer = _xfer(qp, x0)
                tier = [t for t, c in qp.cert_tier_counts("sift").items()
                        if c != t0_.get(t, 0)]
                served[f"{metric} k={k} {when}"] = (tier, xfer)
                if ((tier == ["fast"] and xfer != (1, 1)) or xfer[0] != 1 or len(tier) != 1
                        or tier[0].startswith("light_")):
                    raise AssertionError(f"{label} {metric} k={k} {when}: {tier} {xfer}")
                _check_recall(res, oracle.sets(metric, nq, dead_rows, k=k), ids,
                              f"{label} {metric} B={nq} {when}", k=k)
    counts = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts(outer)
    print(f"  {label}: (tier, transfers) per batch {served}")
    print(f"  {label}: launches {counts} (query columns computed: {counts['cols']}, the live "
          f"2 x 2 x ({B} + 16 + 16) of the buckets' 2 x 2 x (512 + 64 + 64))")
    if counts["cols"] != 4 * (B + 32):
        raise AssertionError(f"{label}: {counts['cols']} query columns computed")
    return qp, ids, counts, served


def time_mirror_kernels(qp, q_pad, name, light_variants):
    """Phases 8 and 9: kernel B3 at the operands the engine's l2 B=128 search gives it
    (bucket 512, k bucket 16: r1 = 32 with the block mins; k bucket 128: r1 = 16, the
    pool only), on the tombstoned namespace; the plain version and exact_knn_t beside it.
    ``light_variants``: also the int8 one-pass and two_pass programs at the same
    operands.  Returns ({time name: ms}, {time name: (args, kwargs)})."""
    st = qp.storage.namespace("sift").device_state()

    def search(k, n_live=B, defer=False):
        return fused_knn_t.exact_knn_t(
            q_pad, st.mirror, st.data, st.valid, st.sq_norms, k=k, metric="l2",
            live_prefix=None, sweep_err=st.sweep_err, resid=st.sweep_resid,
            rscale=st.sweep_rscale, err1=st.sweep_err1, rscale2=st.sweep_rscale2,
            prep_cache=st.prep_cache, report_tier=True, n_live=n_live, defer=defer)

    times, operands = {}, {}
    for k, suffix in ((16, ""), (128, "_k128")):
        a, kw = operands[name + suffix] = _capture("_window_mins_t", lambda: search(k))
        times.update(_time_b1(name + suffix, a, kw))
        times[f"exact_knn_t_{name}{suffix}"] = _time_ms(lambda: search(k))
        _check_result_live(lambda n: search(k, n, defer=True), f"{name} l2, k bucket {k}")
    if light_variants:
        a, kw = operands[name]
        for variant, args in (("_two_pass", (a[0], a[1], a[2], None, None) + a[5:]),
                              ("_light", (a[0], None, a[2], None, None) + a[5:])):
            operands[name + variant] = (args, kw)
            times.update(_time_b1(name + variant, args, kw))
    return times, operands


def _time_b1(name, a, kw):
    """Times of a B1/B3 call at the engine's operands ``a``, ``kw`` (live count and the
    snapshot's zero-query cache included): the kernel as the engine runs it, its plain
    version on the same call (a zero-query cache of its own), and the kernel's full launch
    over every column (the parent's work)."""
    return {name: _time_ms(lambda: fused_knn_t._window_mins_t(*a, **kw)),
            name + "_plain": _time_ms(lambda: fused_knn_t._window_mins_t_plain(
                *a, **{**kw, "zero_cache": {}})),
            name + "_full": _time_ms(lambda: fused_knn_t._window_mins_t(*a, **_full(kw)))}


def _b3_bound(args, kw, outs, full_batch=False, route="split"):
    """Kernel B1/B3's bound: its inputs read once and outputs written once over the HBM
    rate, or its products over the peak for their type, whichever is longer: bf16 tensor
    cores for an int8 or bf16 mirror against bf16 queries, and for the f32 mirror the six
    bf16 passes of its three-way split (``route="fma"``: one f32 pass on the CUDA cores
    instead, the route the earlier FMA body took).  The products are those of the live
    query columns the call needs (``full_batch``: of every column, the bound at the
    engine's padded batch)."""
    passes = 1 + (args[1] is not None) + (args[3] is not None)
    peak = BF16_FLOPS
    if args[2].dtype == torch.float32:
        passes, peak = (1, F32_FLOPS) if route == "fma" else (6, BF16_FLOPS)
    cols = args[0].shape[0] if full_batch else fused_knn_t._live_columns(
        args[0].shape[0], kw.get("n_live"))
    return _bound(_nbytes(*args, kw["qe"], *kw["eb_rows"], *outs),
                  2.0 * args[2].shape[0] * args[2].shape[1] * cols * passes, peak)


F32_ROUTE = "bf16 tensor cores, 6 passes of the 3-way split"


def time_b3_f32(st, q_np, name):
    """Phases 9 and 20: B3 over the f32 mirror at the engine's B = 16 operands (ip and
    cosine, the 64 bucket, k bucket 16) on the tombstoned snapshot ``st``, timed as the
    engine runs it, plain and over every column (``_time_b1``).  Returns ({time name: ms},
    {time name: (args, kwargs)})."""
    q16 = torch.zeros((64, D), device="cuda")
    q16[:16] = torch.from_numpy(q_np[:16]).to(q16.device)
    times, operands = {}, {}
    for metric in ("ip", "cosine"):
        key = f"{name}_b16_{metric}"
        a, kw = operands[key] = _capture("_window_mins_t", lambda: fused_knn_t.exact_knn_t(
            q16, st.mirror, st.data, st.valid, st.sq_norms, k=16, metric=metric,
            live_prefix=None, sweep_err=st.sweep_err, resid=st.sweep_resid,
            rscale=st.sweep_rscale, err1=st.sweep_err1, rscale2=st.sweep_rscale2,
            prep_cache=st.prep_cache, n_live=16))
        if a[2].dtype != torch.float32 or a[0].shape[0] != 64 or kw.get("n_live") != 16:
            raise AssertionError(f"{key}: not the f32 mirror's live launch")
        times.update(_time_b1(key, a, kw))
    return times, operands


def print_f32_route(times, operands, names, launches, label):
    """Phases 9 and 20: each f32-mirror B3 entry's route, its bound on that route beside
    the f32 FMA route's, and the kernel's share of it.  Returns {name: (bound, the FMA
    route's bound ms)}."""
    out = {}
    for name in names:
        a, kw = operands[name]
        outs = fused_knn_t._window_mins_t(*a, **kw)
        bound, fma = _b3_bound(a, kw, outs), _b3_bound(a, kw, outs, route="fma")[0]
        del outs
        out[name] = (bound, fma)
        ms, by = bound[0], bound[1]
        print(f"  {label} {name}: {times[name]:.4f} ms on the {F32_ROUTE}; bound {ms:.4f} ms "
              f"({by}), share {ms / times[name]:.1%}; the f32 FMA route's bound {fma:.4f} ms; "
              f"plain {times[name + '_plain']:.4f} ms, every column {times[name + '_full']:.4f}"
              f" ms; main-path launches {launches}")
    return out


# ---- B4/B5 at the engine's operands (phases 6 and 11) ------------------------------------

def _capture_b4(data, valid, sq_norms, q_pad, masked):
    """B4's (``masked``: B5's) operands in the engine's l2 search of B = 128 queries padded
    to the 512 bucket, k bucket 16: exact_knn_fused with n_live = B, r1 from the padded
    batch.  Returns (wrapper name, args, kwargs)."""
    name = "_window_mins_masked" if masked else "_window_mins_fast"
    a, kw = _capture(name, lambda: fused_knn.exact_knn_fused(
        q_pad, data, valid, sq_norms, k=16, metric="l2",
        live_prefix=None if masked else data.shape[0], n_live=B), module=fused_knn)
    if kw.get("n_live") != B or kw["r1"] != fused_knn._pick_r1(q_pad.shape[0], data.shape[0], 16):
        raise AssertionError(f"{name}: not the engine's live launch: {kw}")
    return name, a, kw


def _time_b4(key, name, a, kw):
    """Times of a B4/B5 call at the engine's operands: the kernel on the live columns as
    the engine runs it, its plain version on the same columns, the kernel's full launch
    over every column of the bucket (the parent's work); and the live launch bit-equal to
    those columns of the full one.  Returns ({time name: ms}, the query columns the live
    launch computed, read from the wrapper's ``.cols``)."""
    fn, ref = getattr(fused_knn, name), getattr(fused_knn, name + "_ref")
    n_c = fused_knn_t._live_columns(a[1].shape[1], kw["n_live"])
    plain_args = (a[0], a[1][:, :n_c], a[2][:, :n_c], a[3])
    cols = fn.cols
    live = fn(*a, **kw)
    cols = fn.cols - cols
    if not _bits_equal(live, fn(*a, **_full(kw))[:, :n_c]):
        raise AssertionError(f"{key}: the live-column launch differs from the full one")
    return {key: _time_ms(lambda: fn(*a, **kw)),
            key + "_plain": _time_ms(lambda: ref(*plain_args, **_full(kw))),
            key + "_full": _time_ms(lambda: fn(*a, **_full(kw)))}, cols


def _b4_bound(a, kw, full_batch=False, route="split"):
    """B4/B5's bound at ``a``, ``kw``: the rows, queries, bias and outputs read or written
    once over the HBM rate, or the products over the peak of the route's type: "split",
    the kernel's bf16 tensor-core passes (6 for f32 rows, 1 for bf16 rows), or "fma", f32
    FMA on the CUDA cores.  The products and outputs of the live query columns the call
    needs (``full_batch``: of every column of the padded batch)."""
    data, qt = a[0], a[1]
    n, d = data.shape
    cols = qt.shape[1] if full_batch else fused_knn_t._live_columns(qt.shape[1], kw.get("n_live"))
    bias = a[3] if torch.is_tensor(a[3]) else None
    nbytes = _nbytes(data, bias) + cols * (d + 1) * 4 + n // kw["r1"] * cols * 4
    if route == "fma":
        return _bound(nbytes, 2.0 * n * d * cols, F32_FLOPS)
    passes = 6 if data.dtype == torch.float32 else 1   # the split's six products, or one
    return _bound(nbytes, 2.0 * n * d * cols * passes, BF16_FLOPS)


def _matmul_ms(data, q_live):
    """The product alone as one PyTorch call, a yardstick the port never calls: the rows
    against the live queries in the rows' type (f32 with TF32 off, as the port keeps it)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 yardstick would not be f32")
    ql = q_live.to(data.dtype)
    return _time_ms(lambda: torch.matmul(data, ql.T))


# ---- ROADMAP C20: the row-major path's proof (phases 3, 6, 11, 15, 19b) -------------------

def _row_major_mark(qp, namespace):
    """``qp``'s copies and ``namespace``'s tier counts now, for ``_row_major_tier0``."""
    return _xfer_mark(qp), dict(qp.cert_tier_counts(namespace))


def _row_major_tier0(qp, namespace, mark, label):
    """Every search of ``namespace`` since ``mark`` (the row-major path records the tier
    it proved each batch at, ROADMAP C20) served at tier 0 with one copy each way (a
    flagged query's float64 settle counted apart).  Returns the number of searches."""
    x0, t0 = mark
    h2d, d2h = _xfer(qp, x0)
    tiers = {t: n - t0.get(t, 0) for t, n in qp.cert_tier_counts(namespace).items()
             if n != t0.get(t, 0)}
    print(f"  {label}: {h2d} row-major searches, tiers {tiers}, copies back {d2h}")
    if not h2d or tiers != {"fast": h2d} or d2h != h2d:
        raise AssertionError(f"{label}: not every batch proven at tier 0 with (1, 1) copies: "
                             f"tiers {tiers}, transfers ({h2d}, {d2h})")
    return h2d


_ROW_COUNTERS = ((fused_knn._window_mins_fast, "launches"),
                 (fused_knn._window_mins_masked, "launches"))


def check_near_duplicates(qp, db_np, dead, label):
    """ROADMAP C20 at 2^20 rows, in a namespace of its own on ``qp`` (the default config's
    processor of phase 3, or phase 11's bf16 store): the phase-3 rows with 64 of them
    overwritten by near duplicates c + N(0, 1e-4^2) of one centre c ~ N(0, 10^2), 128
    queries c + N(0, 1), l2 k=10, through B4 (no tombstones), then B5 after ``dead`` (the
    phase's 1,000 deletes, none of the 64) are deleted.  The f32 error of the l2 expansion
    grows with |q|^2 + |x|^2, so the 64 windows of the duplicates lie inside phase 1's
    error, beyond the 32 the selection keeps: the proof fails at tier 0 and the widened
    tier 1 serves.  Each batch: the float64 oracle's ids in order (the duplicates as
    stored, ties by slot; every other row farther than any of them by the triangle
    inequality), its tier mix and copies, B4's and B5's launches (counted apart and put
    back).  The namespace is dropped after.  Returns the record."""
    n = len(db_np)
    rng = np.random.default_rng(SEED + 20)
    dup_rows = np.sort(rng.choice(np.setdiff1d(np.arange(n), dead), 64, replace=False))
    c = rng.normal(0, 10, D)
    x = db_np.copy()
    x[dup_rows] = (c + rng.normal(0, 1e-4, (64, D))).astype(np.float32)
    q_np = (c + rng.normal(0, 1, (B, D))).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(n)]
    row_of = {u: i for i, u in enumerate(ids)}
    qp.bulk_load(x, "dup", ids=ids)
    st = qp.storage.namespace("dup").device_state()
    dev = st.data.device
    stored = st.data[torch.from_numpy(dup_rows).to(dev)].double().cpu().numpy()
    q64 = q_np.astype(np.float64)
    d_dup = ((q64[:, None, :] - stored[None]) ** 2).sum(-1)              # [B, 64]
    want = dup_rows[np.argsort(d_dup, axis=1, kind="stable")[:, :K]]     # slots ascending
    others = torch.ones(st.capacity, dtype=torch.bool, device=dev)
    others[torch.from_numpy(dup_rows).to(dev)] = False
    far = float(torch.where(others & st.valid, st.sq_norms, 0.0).max().sqrt()) * (1 + 1e-3)
    gap = ((np.linalg.norm(q64, axis=1) - far) ** 2).min()
    if not gap > np.sort(d_dup, axis=1)[:, K - 1].max():
        raise AssertionError(f"{label}: a row outside the duplicates could be nearer")
    outer = [getattr(fn, a) for fn, a in _ROW_COUNTERS]
    for fn, a in _ROW_COUNTERS:
        setattr(fn, a, 0)
    rec = {}
    for when in ("B4", "B5"):
        if when == "B5":
            qp.delete([ids[i] for i in dead], "dup")
        mark = _row_major_mark(qp, "dup")
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "dup", "l2")
        xfer = _xfer(qp, mark[0])
        tiers = {t: n - mark[1].get(t, 0) for t, n in qp.cert_tier_counts("dup").items()
                 if n != mark[1].get(t, 0)}
        got = np.array([[row_of[r["id"]] for r in rs] for rs in res])
        missed = int(sum(len(set(w) - set(g)) for w, g in zip(want.tolist(), got.tolist())))
        rec[when] = {"tiers": tiers, "transfers": xfer, "missed": missed,
                     "order_equal": bool((got == want).all())}
    launched = dict(zip(("fast", "masked"), [getattr(fn, a) for fn, a in _ROW_COUNTERS]))
    for (fn, a), v, c in zip(_ROW_COUNTERS, outer, launched.values()):
        setattr(fn, a, v + c)
    rec["launches"] = launched
    qp.delete_namespace("dup")
    del st
    torch.cuda.empty_cache()
    print(f"  C20 near duplicates ({label}, {n:,} rows, 64 duplicates, B={B} l2 k={K}): "
          f"launches {launched}")
    print(f"  C20 near duplicates ({label}): {rec}")
    # escalated (tier 1, or the scan should the widened proof fail too), never tier 0
    if (launched != {"fast": 1, "masked": 1}
            or any(rec[w]["missed"] or not rec[w]["order_equal"]
                   or rec[w]["tiers"] not in ({"widened": 1}, {"exact_scan": 1})
                   or rec[w]["transfers"][0] != 1 for w in ("B4", "B5"))):
        raise AssertionError(f"C20 near duplicates ({label}): {rec}")
    return rec


# ---- phase 10: probe B7 (int8 convert vs int8 tensor cores vs the stream floor) ----------

INT8_PEAK = 1979e12  # dense int8 tensor-core operations per second, H100 SXM at 700 W


def run_int8_probe(codes, rng):
    """Phase 10: probe B7 at its own shape (the 2^20 x 128 int8 codes of the phase-8
    mirror, B = 128 queries, 32-row window mins [256, 128, 128]): kA (B3's int8 one
    pass, bf16 mma.sync of the widened codes), kB (int8 mma.sync) and kC (the stream
    floor), each against its plain version (kA within its phase-1 budget; kB and kC
    exact integers, equal); launch counts of the run, CUDA-event times, GB/s of codes and
    bounds.  Returns the kernels' records."""
    from mlvectordb_tpu_torch.probes import int8_mma

    dev = torch.device("cuda")
    n, bq = codes.shape[0], 128
    q = torch.from_numpy(rng.standard_normal((bq, D), dtype=np.float32)).to(dev)
    qh, q8 = q.to(torch.bfloat16), int8_mma.quantize_queries(q)
    kernels = {
        "int8_probe_convert_mma": (lambda: int8_mma.convert_mma_min(qh, codes),
                                   lambda: int8_mma.convert_mma_min_ref(qh, codes),
                                   (fused_knn_t._window_mins_t, "launches_int8"), BF16_FLOPS,
                                   _nbytes(qh)),
        "int8_probe_mma": (lambda: int8_mma.mma_min(q8, codes),
                           lambda: int8_mma.mma_min_ref(q8, codes),
                           (int8_mma.mma_min, "launches"), INT8_PEAK, _nbytes(q8)),
        "int8_probe_stream": (lambda: int8_mma.stream_sum(codes, bq),
                              lambda: int8_mma.stream_sum_ref(codes, bq),
                              (int8_mma.stream_sum, "launches"), INT8_PEAK, 0),
    }
    out = {}
    for name, (kernel, plain, (fn, attr), peak, q_bytes) in kernels.items():
        outer = getattr(fn, attr)
        setattr(fn, attr, 0)
        got = kernel()
        launches = getattr(fn, attr)
        setattr(fn, attr, outer + launches)
        want = plain()
        torch.cuda.synchronize()
        if name == "int8_probe_convert_mma":
            _check_budget(got, want, fused_knn_t._phase1_budget(
                qh, None, codes, None, None, None, None, r1=32), name)
            unequal = 0
        else:
            unequal = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if unequal or launches != 1:
            raise AssertionError(f"{name}: {unequal} elements differ from plain, {launches} "
                                 "launches")
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
        ops = n * D if name == "int8_probe_stream" else 2.0 * n * D * bq
        bound = _bound(_nbytes(codes, got) + q_bytes, ops, peak)
        out[name] = dict(launches=launches, ms=ms, plain_ms=plain_ms, bound=bound,
                         err=float((got.float() - want.float()).abs().max()))
        print(f"  {name}: matches plain; {ms:.4f} ms ({n * D / ms / 1e6:.1f} GB/s of codes), "
              f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
              f"{bound[0] / ms:.1%} of it")
    return out


# ---- phases 11-13: bf16 storage, DEEP and probe B6 --------------------------------------

N_DEEP = 1 << 23
BF16_ROWS = EngineConfig(dtype="bfloat16")
DEEP = EngineConfig(dtype="bfloat16", sweep_dtype="bfloat16")


class DeviceOracle(Oracle):
    """The float64 brute force over rows held on the card, here a bf16 store's exact
    answer: its rows as stored (rounded on the card from the f32 corpus, apart from the
    store) against the f32 queries.  In chunks of 2^20 rows: each chunk's nearest KEEP,
    then the nearest KEEP of those."""

    CHUNK = 1 << 20

    def __init__(self, rows, q_np):
        self.rows, self.q_np, self.cache = rows, q_np, {}

    def nearest(self, metric, nq):
        if (metric, nq) not in self.cache:
            q = torch.from_numpy(self.q_np[:nq]).to(self.rows.device, torch.float64)
            qn = (q * q).sum(-1)[:, None]
            vals, found = [], []
            for lo in range(0, self.rows.shape[0], self.CHUNK):
                x = self.rows[lo:lo + self.CHUNK].double()
                dots, sq = q @ x.T, (x * x).sum(-1)[None, :]
                if metric == "l2":
                    d = sq - 2.0 * dots + qn
                elif metric == "ip":
                    d = 1.0 - dots
                else:
                    d = 1.0 - dots / torch.sqrt(torch.clamp_min(sq * qn, 1e-30))
                v, i = torch.topk(d, min(self.KEEP, d.shape[1]), dim=1, largest=False)
                vals.append(v)
                found.append(i + lo)
            v, p = torch.topk(torch.cat(vals, 1), self.KEEP, dim=1, largest=False)  # sorted
            self.cache[(metric, nq)] = (torch.gather(torch.cat(found, 1), 1, p).cpu().numpy(),
                                        v.cpu().numpy())
        return self.cache[(metric, nq)]


def _served(qp, namespace, q_np, metric, nq, k):
    """One find_similar_batch: (results, the tiers it added, its (h2d, d2h) transfers)."""
    x0, t0 = _xfer_mark(qp), qp.cert_tier_counts(namespace)
    res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], k, namespace, metric)
    xfer = _xfer(qp, x0)
    tier = [t for t, c in qp.cert_tier_counts(namespace).items() if c != t0.get(t, 0)]
    return res, tier, xfer


def _deleted(qp, namespace, ids, dead):
    ns = qp.storage.namespace(namespace)
    removed = qp.delete([ids[i] for i in dead], namespace)
    if len(removed) != len(dead) or ns.device_state().live_count == ns.device_state().high_water:
        raise AssertionError(f"{namespace}: delete did not leave tombstones")
    return {ids[i] for i in dead}


_BF16_COUNTERS = ((fused_knn._window_mins_fast, "launches"),
                  (fused_knn._window_mins_fast, "launches_bf16"),
                  (fused_knn._window_mins_masked, "launches"),
                  (fused_knn._window_mins_masked, "launches_bf16"),
                  (fused_knn._window_mins_fast, "cols"),
                  (fused_knn._window_mins_masked, "cols"))


def run_bf16_row_major(db_np, q_np, dead, self_row, q_pad):
    """Phase 11: QueryProcessor(dtype="bfloat16") on the phase-3 corpus, row-major.  The
    launch counts are zeroed just before the searches and read just after (the outer
    counts put back); each search computes its live query columns alone.  B4/B5 over the
    bf16 rows timed at the engine's operands (``q_pad``: the phase-3 queries padded to
    the 512 bucket).  Returns (launch counts, {time name: ms}, {bound name: bound}, {kernel:
    query columns its timed live launch computed})."""
    dev = torch.device("cuda")
    rows = torch.from_numpy(db_np).to(dev).to(torch.bfloat16)
    oracle = DeviceOracle(rows, q_np)
    qp = QueryProcessor(BF16_ROWS, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db_np, "sift")
    torch.cuda.synchronize()
    ns = qp.storage.namespace("sift")
    st = ns.device_state()
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, capacity "
          f"{ns.capacity}, device bytes {ns.nbytes:,} (rows {st.data.dtype}, no mirror: "
          f"{st.mirror is None})")
    if (st.data.dtype != torch.bfloat16 or st.mirror is not None
            or ns.nbytes != ns.capacity * (D * 2 + 5)
            or not torch.equal(st.data[:N].view(torch.int16), rows.view(torch.int16))):
        raise AssertionError("the bf16 store does not hold the rounded rows alone")
    outer = [getattr(fn, a) for fn, a in _BF16_COUNTERS]
    for fn, a in _BF16_COUNTERS:
        setattr(fn, a, 0)
    dead_ids = set()
    for when, dead_rows in (("before delete", None), ("after delete", dead)):
        if dead_rows is not None:
            dead_ids = _deleted(qp, "sift", ids, dead_rows)
        for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
            res, tier, xfer = _served(qp, "sift", q_np, metric, nq, K)
            if xfer != (1, 1) or tier != ["fast"]:   # proven at tier 0 (ROADMAP C20)
                raise AssertionError(f"bf16 row-major {metric} {when}: {tier} {xfer}")
            if any(r["id"] in dead_ids for rs in res for r in rs):
                raise AssertionError(f"bf16 row-major {metric}: a deleted id was returned")
            _check_recall(res, oracle.sets(metric, nq, dead_rows), ids,
                          f"bf16 row-major {metric} B={nq} {when} (bf16-row oracle)")
    counts = dict(zip(("fast", "fast_bf16", "masked", "masked_bf16", "fast_cols",
                       "masked_cols"), [getattr(fn, a) for fn, a in _BF16_COUNTERS]))
    for (fn, a), v, n in zip(_BF16_COUNTERS, outer, counts.values()):
        setattr(fn, a, v + n)
    print(f"  launches on the bf16 row-major path: {counts}")
    if (counts["fast_bf16"] < 1 or counts["masked_bf16"] < 1
            or counts["fast"] != counts["fast_bf16"] or counts["masked"] != counts["masked_bf16"]
            or counts["fast_cols"] != B + 32 or counts["masked_cols"] != B + 32):
        raise AssertionError(f"a bf16 kernel of the path never launched, or it computed other "
                             f"than the live {B} + 16 + 16 query columns: {counts}")
    self_hit = qp.find_similar(VectorDTO(db_np[self_row]), 1, "sift", "l2")
    print(f"  self query (row {self_row}): score {self_hit[0]['score']} (|x - bf16(x)|^2)")
    if self_hit[0]["id"] != ids[self_row] or not self_hit[0]["score"] < 1e-3:
        raise AssertionError(f"stored row {self_row} queried as itself returned {self_hit[:1]}")

    # B4/B5 over bf16 rows at the operands the engine's l2 B=128 search gives them (bucket
    # 512, k bucket 16, the 128 live columns), on the tombstoned namespace
    st = ns.device_state()
    data = st.data
    times, bounds, cols = {}, {}, {}
    for key, masked in (("fast_bf16", False), ("masked_bf16", True)):
        name, a, k_ = _capture_b4(data, st.valid, st.sq_norms, q_pad, masked)
        t, cols[key] = _time_b4(key, name, a, k_)
        times.update(t)
        bounds[key] = _b4_bound(a, k_)
        bounds[key + "_full_batch"] = _b4_bound(a, k_, full_batch=True)
    times["matmul_bf16"] = _matmul_ms(data, q_pad[:B])
    times["exact_knn_fused_bf16_masked"] = _time_ms(lambda: fused_knn.exact_knn_fused(
        q_pad, data, st.valid, st.sq_norms, k=16, metric="l2", live_prefix=None, n_live=B))
    mark = _row_major_mark(qp, "sift")
    wall = _engine_wall(qp, q_np)
    times["engine_wall_bf16_masked_median"] = statistics.median(wall)
    split = _engine_split(qp, q_np)
    proof = {"phase 11": _row_major_tier0(qp, "sift", mark, "phase 11 (ROADMAP C20)")}
    flop = 2.0 * N * B * D
    for name, ms in times.items():
        extra = (f", {flop / ms / 1e9:.1f} TFLOP/s on the {B} live queries"
                 if name in ("fast_bf16", "masked_bf16") else "")
        print(f"  {name}: {ms:.4f} ms{extra}")
    print(f"  engine wall runs (ms), B={B} l2 k={K}, tombstoned bf16 store: {wall}")
    print(f"  engine split, median ms (host clock): {split}")
    print(f"  query columns of the timed live launches: {cols}")
    if any(c != B for c in cols.values()):
        raise AssertionError(f"a timed B4/B5 launch computed other than {B} columns: {cols}")
    proof["near_duplicates_bf16"] = check_near_duplicates(qp, db_np, dead, "bf16 rows")
    return counts, times, bounds, cols, proof


def check_c3(db_np):
    """Phase 11: ROADMAP C3's construction (tests/test_torch_filters.py) at full row count,
    before any compaction: the phase-3 rows moved 8 away from the all-ones query, row A
    (100) written 2^-8 - 2^-12 above 1.0 in every element (its bf16 row is the query, its
    written norm 0.94 larger), 40 decoys at 0.25-0.38 and 0.71.  The store's norm of A is
    its stored row's (ROADMAP C17); A comes first at distance 0 through B4 (no holes),
    through B5 (after one far delete) and through the scan (use_pallas=False).  Returns
    {path: (first row, its score, the launches of the path's kernel)}."""
    dev = torch.device("cuda")
    x = db_np + np.float32(8)
    a_row = 100
    x[a_row] = np.float32(1 + 2.0 ** -8 - 2.0 ** -12)
    for i, r in enumerate(range(1000, 1000 + 40 * 64, 64)):
        x[r] = 1.0
        x[r, i % D] += np.float32(0.5 + i / 128 if i < 16 else 0.84375)
    q = [VectorDTO(np.ones(D, np.float32))]
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    rows = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    d = torch.cat([((c.double() - 1.0) ** 2).sum(1) for c in torch.split(rows, 1 << 18)])
    best = torch.topk(d, K + 1, largest=False)
    want = set(best.indices[:K].tolist())
    if a_row not in want or not float(best.values[K]) > float(best.values[K - 1]):
        raise AssertionError(f"C3's construction: exact top {K} {sorted(want)}")
    del rows, d
    seen = {}
    for path, cfg in (("B4", BF16_ROWS), ("scan", EngineConfig(dtype="bfloat16",
                                                                use_pallas=False))):
        qp = QueryProcessor(cfg, device=dev)
        qp.bulk_load(x, "c3", ids=ids)
        ns = qp.storage.namespace("c3")
        written = float((x[a_row].astype(np.float64) ** 2).sum())
        stored = float(ns.device_state().sq_norms[a_row])
        if stored != float(D):
            raise AssertionError(f"C3: A's norm in the store is {stored}, not its stored row's")
        steps = [(path, None)] + ([("B5", ids[5000])] if path == "B4" else [])
        for name, gone in steps:
            if gone is not None:
                qp.delete([gone], "c3")
            fn = fused_knn._window_mins_masked if name == "B5" else fused_knn._window_mins_fast
            before = fn.launches_bf16
            res = qp.find_similar_batch(q, K, "c3", "l2")[0]
            launched = fn.launches_bf16 - before
            seen[name] = (res[0]["id"].int - 1, res[0]["score"], launched)
            if ({r["id"].int - 1 for r in res} != want or seen[name][:2] != (a_row, 0.0)
                    or (name != "scan") != (launched == 1)):
                raise AssertionError(f"C3 {name}: {seen[name]}, exact top {K} {sorted(want)}")
        del qp, ns
    print(f"  C3 at {N:,} rows before a compaction: A's norm in the store {stored} (its "
          f"written value's {written:.4f}); (first row, score, kernel launches) per path "
          f"{seen}: the exact set, A first at distance 0")
    return seen


def _c18_pairs(rng, metric, n_pairs, slots):
    """ROADMAP C18's pairs: per query q + e and q - e (e orthogonal to q: equal distances in
    exact arithmetic), kept where the plain f32 formula (numpy, every step rounded to f32)
    orders them strictly against float64.  Returns (queries, rows [n, 2, D], float64
    distances [n, 2], the slots)."""
    f = np.float32

    def f32(q, x):
        qn, sqn, dot = f(q @ q), f(x @ x), f(q @ x)
        if metric == "l2":
            return max(f(f(qn + sqn) - f(2) * dot), f(0))
        return f(f(1) - dot * f(f(1) / np.sqrt(f(qn * sqn))))

    def f64(q, x):
        q, x = q.astype(np.float64), x.astype(np.float64)
        if metric == "l2":
            return ((x - q) ** 2).sum()
        return 1 - x @ q / np.sqrt((x @ x) * (q @ q))

    qs, rows, d64 = [], [], []
    while len(qs) < n_pairs:
        q = rng.standard_normal(D).astype(f)
        e = rng.standard_normal(D) * 0.1
        e -= (e @ q) / (q.astype(np.float64) @ q) * q
        a, c = (q + e).astype(f), (q - e).astype(f)
        da, dc = f64(q, a), f64(q, c)
        if da != dc and (f32(q, a) - f32(q, c)) * (da - dc) < 0:
            qs.append(q)
            rows.append((a, c))
            d64.append((da, dc))
    return np.stack(qs), np.array(rows), np.array(d64), [slots(b) for b in range(n_pairs)]


def check_c18(db_np):
    """Phase 11: ROADMAP C18 at 2^20 rows, on the phase-3 corpus copied to the card (no
    engine ingest): 64 queries per metric, each with a pair q + e, q - e (e orthogonal to
    q) planted over two phase-3 rows in different tiles, kept where the plain f32 formula
    orders the pair strictly against float64; 1,000 other rows dead.  Through B2's rescan
    (``exact_knn_t`` over a bf16 mirror, heavy program, masked), B5's row-major rescan
    (``exact_knn_fused``, masked) and the scan (``topk.exact_knn``, the f32 query), l2 and
    cosine, k = 10: every pair comes first in float64 order, the rest of the ten is the
    float64 oracle's set.  Prints per path the kernel's launches, the pairs the card's
    own f32 product (cuBLAS, the scan's) orders against float64, and the settle's counts.
    Returns {path_metric: {...}}."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 18)
    nq = 64
    data = torch.from_numpy(db_np).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    dead = rng.choice(np.arange(N // 2, N), 1000, replace=False)
    valid[torch.from_numpy(dead).to(dev)] = False
    out = {}
    for metric in ("l2", "cosine"):
        q_np, rows, d64, slots = _c18_pairs(
            rng, metric, nq, lambda b: (N // 256 * b + 11, N // 2 - N // 128 * (b + 1) + 5))
        if len(set(np.ravel(slots).tolist())) != 2 * nq:
            raise AssertionError("C18: two pairs share a slot")
        saved = data[torch.tensor(np.ravel(slots), device=dev)].clone()
        data[torch.tensor(np.ravel(slots), device=dev)] = torch.from_numpy(
            rows.reshape(-1, D)).to(dev)
        sq = fused_knn_t.row_sq_norms(data)
        mirror = data.to(torch.bfloat16)
        err = fused_knn_t.sweep_err_norms(data)
        q = torch.from_numpy(q_np).to(dev)
        oracle = DeviceOracle(data, q_np).sets(metric, nq, dead)
        x = torch.from_numpy(rows.reshape(-1, D)).to(dev)
        pair = torch.repeat_interleave(q, 2, 0)
        require_f32_matmul()
        dot = torch.bmm(pair[:, None, :], x[:, :, None]).flatten()   # cuBLAS, as the scan's
        qn, xn = (pair * pair).sum(-1), (x * x).sum(-1)
        f32 = (torch.clamp_min(qn + xn - 2.0 * dot, 0.0) if metric == "l2"
               else 1.0 - dot * torch.rsqrt(qn * xn)).reshape(nq, 2).cpu().numpy()
        reversed_f32 = int(((f32[:, 0] - f32[:, 1]) * (d64[:, 0] - d64[:, 1]) < 0).sum())
        want = [list(s if d[0] < d[1] else s[::-1]) for s, d in zip(slots, d64)]
        paths = {
            "B2": (fused_knn_t._gather_score, lambda: fused_knn_t.exact_knn_t(
                q, mirror, data, valid, sq, k=K, metric=metric, sweep_err=err, light=False,
                report_tier=True)),
            "B5": (fused_knn._window_mins_masked, lambda: fused_knn.exact_knn_fused(
                q, data, valid, sq, k=K, metric=metric, live_prefix=None) + (None,)),
            "scan": (None, lambda: topk.exact_knn(
                q, data, valid, sq, k=K, metric=metric, db_tile=8 * fused_knn_t.SWEEP_TILE,
                round_query=False) + (None,)),
        }
        for path, (fn, call) in paths.items():
            before = 0 if fn is None else fn.launches
            saved_tally, settle.TALLY = settle.TALLY, []
            d, i, tier = call()
            tally = settle.TALLY
            settle.TALLY = saved_tally
            got = i.cpu().numpy()
            launched = None if fn is None else fn.launches - before
            rec = {"launches": launched, "tier": tier, "pairs": nq,
                   "f32_product_reversed": reversed_f32,
                   "settled": sum(int(t[0]) for t in tally),
                   "changed": sum(int(t[1]) for t in tally),
                   "flagged": sum(int(t[2]) for t in tally)}
            out[f"{path}_{metric}"] = rec
            bad = [b for b in range(nq) if got[b, :2].tolist() != want[b]
                   or set(got[b].tolist()) != oracle[b]]
            print(f"  C18 {path} {metric} at {N:,} rows: {nq} pairs first in float64 order "
                  f"({nq - len(bad)} of {nq}); {rec}")
            if bad or launched == 0 or (tier or 0) > 1:
                raise AssertionError(f"C18 {path} {metric}: queries {bad[:8]} not in float64 "
                                     f"order or not the oracle's set; {rec}")
            if not (torch.diff(d, dim=1) >= 0).all():
                raise AssertionError(f"C18 {path} {metric}: distances not non-decreasing")
        data[torch.tensor(np.ravel(slots), device=dev)] = saved
    return out


def _slack_rows(st, q, metric):
    """The certificate's accumulation slack Dp * 2^-22 * |qh| * maxd per query."""
    sqn = torch.where(st.valid, st.sq_norms, torch.zeros_like(st.sq_norms))
    maxd = 1.0 if metric == "cosine" else torch.sqrt(sqn.max())
    return D * 2.0 ** -22 * torch.linalg.vector_norm(q, dim=1) * (
        2.0 if metric == "l2" else 1.0) * maxd


def check_same_dtype_kernels(st, q_pad, search):
    """Phase 12: kernel B1 over the bf16 rows (one pass) at the operands the engine's
    searches give it: cosine and l2 at k bucket 16 (r1 = 32, block mins), cosine at k
    bucket 128 (the pool); kernel B2's operands over the bf16 rows at the cosine searches'
    (k buckets 16 and 128), checked where ``run_deep`` times them.  The
    window mins (the kernel's own, where it wrote the pool only) within the phase-1
    budget of the plain version's (the plain version of the same call: live columns,
    padding from its own zero query), block mins too, the pool bit-equal to the plain
    pool of the kernel's own mins; the live-column launch bit-equal to the full one.
    Returns (max |err| of B1, {program: (args, kwargs)})."""
    worst, operands = 0.0, {}
    for metric, k in (("cosine", 16), ("l2", 16), ("cosine", 128)):
        a, kw = operands[f"{metric}_k{k}"] = _capture("_window_mins_t",
                                                      lambda: search(metric, k))
        if a[1] is not None or a[3] is not None or a[2].data_ptr() != st.data.data_ptr():
            raise AssertionError(f"{metric} k={k}: not the one-pass program over the rows")
        got = fused_knn_t._window_mins_t(*a, **kw)
        want = fused_knn_t._window_mins_t_plain(*a, **{**kw, "skip_wm": False, "zero_cache": {}})
        own = got[0] if got[0] is not None else fused_knn_t._window_mins_t(
            *a, **{**kw, "emit_topm": 0, "skip_wm": False})[0]
        torch.cuda.synchronize()
        budget = _budget(a, kw)
        # the live queries' budget inside their slack (a zero query's slack is 0, and its
        # ranks are the bias exactly on both sides)
        if not bool((budget[:, :B] <= _slack_rows(st, q_pad, metric)[None, :B, None]).all()):
            raise AssertionError(f"same-dtype B1 {metric} k={k}: the budget above the slack")
        for g, w, bd in ((own, want[0], budget), (got[1], want[1], budget.amax(-1))):
            if g is not None:
                worst = max(worst, _check_budget(g, w, bd, f"same-dtype B1 {metric} k={k}")[0])
        cols = _check_live_tiles(a, kw, B, f"same-dtype B1 {metric} k={k}")
        if got[2] is not None and not torch.equal(
                got[2].view(torch.int32),
                fused_knn_t._topm_pool_ref(own, kw["emit_topm"]).view(torch.int32)):
            raise AssertionError(f"same-dtype B1 {metric} k={k}: the pool is not its mins'")
        print(f"  B1 same-dtype {metric} k bucket {k}: r1={kw['r1']}, block mins "
              f"{kw['emit_block_mins']}, pool m={kw['emit_topm']}, skip_wm {kw['skip_wm']}, "
              f"bound rows {len(kw['eb_rows'])}: within the budget of plain; {cols} of "
              f"{a[0].shape[0]} columns computed, every column bit-equal to the full launch")
        del got, want, own
    for k in (16, 128):
        a, _ = operands[f"gather_k{k}"] = _capture("_gather_score", lambda: search("cosine", k))
        if a[1].dtype != torch.bfloat16:
            raise AssertionError("the same-dtype rescan did not read the bf16 rows")
    print(f"  max |kernel - plain|: B1 same-dtype {worst} (within the phase-1 budget)")
    return worst, operands


def run_deep():
    """Phase 12: the DEEP configuration's single-chip portion (BASELINE.json config #4,
    benchmarks/suite.py:363-381): 8,388,608 x 128 bf16 rows with the same-dtype sweep.
    Returns (launch counts, max |err| of B1 and B2, times, bounds, the store's rows)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    t0 = time.perf_counter()
    db = rng.standard_normal((N_DEEP, D), dtype=np.float32)
    qd = rng.standard_normal((B, D), dtype=np.float32)
    # the oracle's rows, rounded on the card apart from the store, and the rounding's gap
    # |‖row‖ - ‖bf16(row)‖| / ‖row‖ the sweep's bias and scale rows hold before a compaction
    rows = torch.empty((N_DEEP, D), dtype=torch.bfloat16, device=dev)
    gap = 0.0
    for lo in range(0, N_DEEP, DeviceOracle.CHUNK):
        x = torch.from_numpy(db[lo:lo + DeviceOracle.CHUNK]).to(dev)
        rows[lo:lo + x.shape[0]] = x.to(torch.bfloat16)
        n32 = torch.linalg.vector_norm(x.double(), dim=1)
        n16 = torch.linalg.vector_norm(rows[lo:lo + x.shape[0]].double(), dim=1)
        gap = max(gap, float(((n32 - n16).abs() / n32).max()))
    print(f"  corpus: {N_DEEP:,} x {D} gaussian f32 made in {time.perf_counter() - t0:.1f} s")
    qp = QueryProcessor(DEEP, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db, "deep")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ns = qp.storage.namespace("deep")
    st = ns.device_state()
    print(f"  bulk_load: {len(ids)} rows in {ingest_s:.2f} s, capacity {ns.capacity}, device "
          f"bytes {ns.nbytes:,}; mirror is the rows: {st.mirror.data_ptr() == st.data.data_ptr()}")
    if (st.data.dtype != torch.bfloat16 or st.mirror.data_ptr() != st.data.data_ptr()
            or st.sweep_err is not None or st.sweep_resid is not None
            or ns.capacity != N_DEEP or ns.nbytes != N_DEEP * (D * 2 + 5)
            or not torch.equal(st.data.view(torch.int16), rows.view(torch.int16))):
        raise AssertionError("the DEEP store is not its bf16 rows alone")
    oracle = DeviceOracle(rows, qd)
    near = sorted({next(iter(s)) for s in oracle.sets("cosine", B, k=1)})
    others = rng.choice(np.setdiff1d(np.arange(N_DEEP), near), 1000 - len(near), replace=False)
    dead = np.asarray(sorted(near + others.tolist()))

    searches = (("cosine", B, K), ("l2", B, K), ("ip", 16, K), ("cosine", B, K100))
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    served, dead_ids = {}, set()
    for when, dead_rows in (("before delete", None), ("after delete", dead)):
        if dead_rows is not None:
            dead_ids = _deleted(qp, "deep", ids, dead_rows)
        for metric, nq, k in searches:
            res, tier, xfer = _served(qp, "deep", qd, metric, nq, k)
            served[f"{metric} B={nq} k={k} {when}"] = (tier, xfer)
            if (xfer[0] != 1 or len(tier) != 1 or tier[0].startswith("light_")
                    or (tier == ["fast"] and xfer != (1, 1))):
                raise AssertionError(f"DEEP {metric} k={k} {when}: {tier} {xfer}")
            if any(r["id"] in dead_ids for rs in res for r in rs):
                raise AssertionError(f"DEEP {metric}: a deleted id was returned")
            _check_recall(res, oracle.sets(metric, nq, dead_rows, k=k), ids,
                          f"DEEP {metric} B={nq} {when} (bf16-row oracle)", k=k)
    counts = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts([o + c for o, c in zip(outer, counts.values())])
    print(f"  DEEP (tier, transfers) per batch: {served}")
    print(f"  DEEP launches: {counts} (query columns computed: {counts['cols']}, the live "
          f"2 x ({B} + {B} + 16 + {B}) of the buckets' 2 x (512 + 512 + 64 + 512))")
    if counts["cols"] != 2 * (3 * B + 16):
        raise AssertionError(f"DEEP: {counts['cols']} query columns computed")
    if (counts["sweep"] != 2 * len(searches) or counts["sweep_heavy"] or counts["int8"]
            or counts["f32"] or counts["gather_bf16"] < 1
            or counts["gather_bf16"] != counts["gather"]):
        raise AssertionError(f"the same-dtype kernels did not serve every search: {counts}")
    q_fold = torch.from_numpy(-qd)
    qres = torch.linalg.vector_norm(q_fold - q_fold.to(torch.bfloat16).float(), dim=1)
    rel = (qres / torch.linalg.vector_norm(q_fold, dim=1)).numpy()
    print(f"  rounding: max |‖row‖ - ‖bf16(row)‖| / ‖row‖ over the corpus {gap:.3e}; the "
          f"query's |qres| / |q| (the certificate's term) max {rel.max():.3e}, median "
          f"{float(np.median(rel)):.3e}")

    # the kernels at the operands of the engine's B=128 searches (bucket 512), tombstoned
    st = ns.device_state()
    q_pad = torch.zeros((512, D), device=dev)
    q_pad[:B] = torch.from_numpy(qd).to(dev)

    def search(metric, k, n_live=B, defer=False):
        return fused_knn_t.exact_knn_t(q_pad, st.mirror, st.data, st.valid, st.sq_norms, k=k,
                                       metric=metric, live_prefix=None,
                                       prep_cache=st.prep_cache, report_tier=True,
                                       n_live=n_live, defer=defer)

    worst, operands = check_same_dtype_kernels(st, q_pad, search)
    times = {}
    for name, key in (("sweep_same_dtype", "cosine_k16"), ("sweep_same_dtype_l2", "l2_k16"),
                      ("sweep_same_dtype_k128", "cosine_k128")):
        times.update(_time_b1(name, *operands[key]))
    a, _ = operands["cosine_k16"]
    times["matmul_deep"] = _time_ms(lambda: torch.matmul(a[2], a[0][:B].T))
    t, gather_bounds, gather_rows, gworst = time_gather("gather_bf16", *operands["gather_k16"])
    times.update(t)
    t, b, _, _ = time_gather("gather_bf16_k128", *operands["gather_k128"])
    times.update(t)
    gather_bounds.update(b)
    for metric, k in (("cosine", 16), ("l2", 16), ("ip", 16), ("cosine", 128)):
        _check_result_live(lambda n: search(metric, k, n, defer=True),
                           f"DEEP {metric} k bucket {k}")
    times["exact_knn_t_deep"] = _time_ms(lambda: search("cosine", 16))
    times["exact_knn_t_deep_k128"] = _time_ms(lambda: search("cosine", 128))
    wall = _engine_wall(qp, qd, namespace="deep", metric="cosine")
    split = _engine_split(qp, qd, namespace="deep", metric="cosine")
    times["engine_wall_deep_median"] = statistics.median(wall)
    bounds = {}
    for name, key in (("sweep_same_dtype", "cosine_k16"), ("sweep_same_dtype_l2", "l2_k16"),
                      ("sweep_same_dtype_k128", "cosine_k128")):
        a, kw = operands[key]
        outs = fused_knn_t._window_mins_t(*a, **kw)
        bounds[name] = _b3_bound(a, kw, outs)
        bounds[name + "_full_batch"] = _b3_bound(a, kw, outs, full_batch=True)
        del outs
    bounds.update(gather_bounds)
    flop = 2.0 * N_DEEP * 512 * D
    for name, ms in times.items():
        extra = ""
        if name == "gather_bf16":
            extra = f", {gather_rows * D * 2 / ms / 1e6:.1f} GB/s of the computed rows"
        elif name.startswith("sweep") and name + "_full_batch" in bounds:
            extra = (f", {flop / 4 / ms / 1e9:.1f} TFLOP/s on the {B} live queries, bound "
                     f"{bounds[name][0]:.4f} ms ({bounds[name + '_full_batch'][0]:.4f} at all "
                     f"512)")
        print(f"  {name}: {ms:.4f} ms{extra}")
    print(f"  engine wall runs (ms), B={B} cosine k={K}, tombstoned DEEP store: {wall}")
    print(f"  engine split, median ms (host clock): {split}")
    # what phase 19 shards: the same rows, ids, queries, deletes and oracle
    ctx = {"qp": qp, "ids": ids, "db": db, "qd": qd, "dead": dead, "oracle": oracle}
    return counts, worst, gworst, times, bounds, st.data, ctx


def run_out_layout(rows, rng):
    """Phase 13: probe B6 over the phase-12 rows (B = 128, zero bias, qh = bf16(-q)) at
    its own shape (r1 = 32, g = 1) and at the k=1000 program's (r1 = 4, g = 8, where the
    JAX package writes [B, P]): the [B, P] and tile-major outputs, each within the phase-1
    budget of its plain version and equal to each other bit for bit; launch counts of the probe
    run (r1 = 32), times, GB/s (the TPU probe's count) and bounds.  Returns the kernels'
    records."""
    from mlvectordb_tpu_torch.probes import out_layout

    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((128, D), dtype=np.float32)).to(dev)
    ops = out_layout.operands(rows, q)
    n, out = rows.shape[0], {"2d": {}, "3d": {}}
    fn = fused_knn_t._window_mins_t
    for r1 in (fused_knn_t.R1MAX, 4):
        outer = (fn.launches, fn.launches_bp)
        fn.launches = fn.launches_bp = 0
        a, c = out_layout.out_2d(*ops, r1), out_layout.out_3d(*ops, r1)
        launches = {"2d": fn.launches_bp, "3d": fn.launches - fn.launches_bp}
        fn.launches, fn.launches_bp = outer[0] + fn.launches, outer[1] + fn.launches_bp
        torch.cuda.synchronize()
        same = torch.equal(out_layout.as_tile_major(a, r1), c)
        errs = {}
        for name, got, plain, tr in (("2d", a, out_layout.out_2d_ref, False),
                                     ("3d", c, out_layout.out_3d_ref, True)):
            budget = fused_knn_t._phase1_budget(ops[0], None, ops[1], None, None, None,
                                                ops[2], r1=r1, transposed=tr)
            errs[name] = _check_budget(got, plain(*ops, r1), budget, f"B6 {name} r1={r1}")[0]
            del budget
        print(f"  B6 over {n:,} x {D} bf16 rows, B=128, r1={r1}: [B, P] equal to tile-major "
              f"bit for bit: {same}; max |kernel - plain| 2d {errs['2d']}, 3d {errs['3d']} "
              f"(within the phase-1 budget); launches {launches}")
        if not same or launches != {"2d": 1, "3d": 1}:
            raise AssertionError(f"B6 r1={r1}: layouts differ ({same}) or launches {launches}")
        for name, kernel, plain, res in (("2d", out_layout.out_2d, out_layout.out_2d_ref, a),
                                         ("3d", out_layout.out_3d, out_layout.out_3d_ref, c)):
            ms, plain_ms = _time_ms(lambda: kernel(*ops, r1)), _time_ms(lambda: plain(*ops, r1))
            bound = _bound(_nbytes(*ops, res), 2.0 * n * D * 128, BF16_FLOPS)
            if r1 == fused_knn_t.R1MAX:   # the probe's shape: the kernel's record
                out[name].update(launches=launches[name], ms=ms, plain_ms=plain_ms,
                                 bound=bound, err=errs[name])
            else:                         # the k=1000 program's shape, beside it
                out[name].update({f"r1_{r1}_ms": ms, f"r1_{r1}_plain_ms": plain_ms,
                                  f"r1_{r1}_bound_ms": bound[0],
                                  f"r1_{r1}_max_abs_err": errs[name]})
            print(f"  B6 {name} r1={r1}: {ms:.4f} ms ({out_layout.gbs(n, D, 128, ms, r1):.0f} "
                  f"GB/s as the TPU probe counts), plain {plain_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of it")
        del a, c
    return out

def check_tc_error(rows, db_np, rng):
    """Phase 14: the tensor-core body's dots against float64 (probes/tc_error), as
    max |dot - exact| / (|qh| |x|) over every row and query: the DEEP rows with B = 128
    gaussian queries, 2^20 hard rows (exponents 2^-20 .. 2^10 within a row, cancelling
    signs) and 2^20 rows of int8 codes +-127 against hard queries; an f32 mirror (the six
    passes of the split) over the phase-3 gaussian corpus with f32 gaussian queries and over
    2^20 hard f32 rows (full significands) with hard f32 queries.  Each must be at most
    Dp * 2^-23.  Returns ({case: max}, the bar)."""
    from mlvectordb_tpu_torch.probes import tc_error

    dev = torch.device("cuda")
    bar = D * 2.0 ** -23
    q = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).to(dev)
    hq = tc_error.hard_queries(rng, B, D).to(dev)
    frng = np.random.default_rng(SEED + 14)   # the f32 cases' own: ``rng`` goes on to B4's
    cases = {"deep_rows": lambda: (q.to(torch.bfloat16), rows),
             "hard_rows": lambda: (hq, tc_error.hard_rows(rng, 1 << 20, D).to(dev)),
             "int8_extremes": lambda: (hq, tc_error.int8_extremes(rng, 1 << 20, D).to(dev)),
             "f32_gaussian": lambda: (q, torch.from_numpy(db_np).to(dev)),
             "f32_hard": lambda: (tc_error.hard_queries_f32(frng, B, D).to(dev),
                                  tc_error.hard_rows_f32(frng, 1 << 20, D).to(dev))}
    errs = {}
    for name, make in cases.items():
        qh, m = make()
        errs[name] = tc_error.max_rel_err(qh, m)
        print(f"  {name}: {m.shape[0]:,} x {D} {m.dtype}, B={B}: max |dot - float64 dot| / "
              f"(|qh||x|) = {errs[name]:.4e}, {errs[name] / bar:.4f} of the bar Dp*2^-23 = "
              f"{bar:.4e}")
        del qh, m
    if any(e > bar for e in errs.values()):
        raise AssertionError(f"the tensor-core dots exceed Dp*2^-23: {errs}")
    return errs, bar


def check_b4_tc_error(db_np, deep_rows, rng):
    """Phase 14: kernel B4's dots against float64 (probes/tc_error.b4_max_rel_err), as
    max |dot - exact| / (|q| |x|) over every row and query at B = 128: f32 rows (the
    three-way split's six products) over the phase-3 gaussian corpus and 2^20 hard f32 rows
    (exponents 2^-20 .. 2^10 within a row, full significands, cancelling signs); bf16 rows
    (one pass) over the DEEP rows.  Each must be at most Dp * 2^-23: the bar under which f32
    rows take the split body.  Returns {case: max}."""
    from mlvectordb_tpu_torch.probes import tc_error

    dev = torch.device("cuda")
    bar = D * 2.0 ** -23
    q = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).to(dev)
    cases = {"f32_gaussian": lambda: (q, torch.from_numpy(db_np).to(dev)),
             "f32_hard": lambda: (tc_error.hard_queries_f32(rng, B, D).to(dev),
                                  tc_error.hard_rows_f32(rng, 1 << 20, D).to(dev)),
             "bf16_deep_rows": lambda: (q, deep_rows)}
    errs = {}
    for name, make in cases.items():
        qq, m = make()
        errs[name] = tc_error.b4_max_rel_err(qq, m)
        print(f"  B4 {name}: {m.shape[0]:,} x {D} {m.dtype}, B={B}: max |dot - float64 dot| / "
              f"(|q||x|) = {errs[name]:.4e}, {errs[name] / bar:.4f} of the bar Dp*2^-23")
        del qq, m
    if any(e > bar for e in errs.values()):
        raise AssertionError(f"B4's tensor-core dots exceed Dp*2^-23: {errs}")
    return errs


# ---- phase 15: filtered (hybrid) search at the GloVe-1.2M shape ---------------------------

# ann-benchmarks' glove-100-angular train set (BASELINE.json config #3), made from a seed:
# 100-d rows padded to 128 by the store, cosine
N_GLOVE, D_GLOVE = 1_183_514, 100
N_ROW_FILTER = 1 << 18          # B5's filtered search: the first 2^18 rows (B5 at 2^20: phase 3)
LANGS = ("en", "de", "fr", "ja")
PICK = (3, 77_777, 500_001, 900_000, N_GLOVE - 1)   # the rows of the 5-row filter
HYBRID_FILTERS = (("half", {"parity": 0}), ("1%", {"bucket": {"$lt": 1}}),
                  ("quarter", {"$and": [{"parity": 0}, {"lang": {"$in": ["en", "de"]}}]}),
                  ("5 rows", {"pick": 1}))


def _glove_metas(n):
    """The rows' metadata: parity, bucket (i % 100) and language of row i, and on the five
    PICK rows a "pick" field (the 5-row filter)."""
    metas = [{"parity": i % 2, "bucket": i % 100, "lang": LANGS[i % 4]} for i in range(n)]
    for i in PICK:
        if i < n:
            metas[i]["pick"] = 1
    return metas


def _glove_allowed(n, spec_name):
    """[n] bool: the rows each HYBRID_FILTERS entry matches, from the row numbers."""
    i = np.arange(n)
    return {"half": i % 2 == 0, "1%": i % 100 < 1, "quarter": i % 4 == 0,
            "5 rows": np.isin(i, PICK)}[spec_name]


def _filtered_oracle(rows, q, allowed, metric, k):
    """The float64 brute force over the f32 rows on the card among the ``allowed`` rows
    ([n] bool, on the card): per query the (ids, distances) of its min(k, allowed) nearest,
    nearest first, and the distance of the next one (inf where none)."""
    q64 = q.double()
    qn = (q64 * q64).sum(-1)[:, None]
    vals, found = [], []
    for lo in range(0, rows.shape[0], DeviceOracle.CHUNK):
        x = rows[lo:lo + DeviceOracle.CHUNK].double()
        dots, sq = q64 @ x.T, (x * x).sum(-1)[None, :]
        d = (sq - 2.0 * dots + qn if metric == "l2"
             else 1.0 - dots / torch.sqrt(torch.clamp_min(sq * qn, 1e-30)))
        d = torch.where(allowed[lo:lo + x.shape[0]][None, :], d, torch.inf)
        v, i = torch.topk(d, min(k + 1, d.shape[1]), dim=1, largest=False)
        vals.append(v)
        found.append(i + lo)
    v, p = torch.topk(torch.cat(vals, 1), k + 1, dim=1, largest=False)
    ids = torch.gather(torch.cat(found, 1), 1, p)
    n_ok = min(k, int(allowed.sum()))
    return ids[:, :n_ok].cpu().numpy(), v[:, :n_ok].cpu().numpy(), v[:, n_ok].cpu().numpy()


def _check_filtered(res, want, ids, spec, label):
    """Set-exact against the oracle's rows (recall 1.0, exactly min(k, matching) hits)
    and no hit outside the filter."""
    index_of = {u: i for i, u in enumerate(ids)}
    hits = 0
    for rs, w in zip(res, want):
        got = {index_of[r["id"]] for r in rs}
        hits += len(got & set(w.tolist()))
        if len(rs) != len(w) or any(not filters.matches_filter(r["metadata"], spec)
                                    for r in rs):
            raise AssertionError(f"{label}: {len(rs)} hits for {len(w)}, or one outside "
                                 f"the filter")
    recall = hits / max(1, sum(len(w) for w in want))
    if recall != 1.0:
        raise AssertionError(f"{label}: recall {recall}")
    return recall


def run_hybrid(gpu):
    """Phase 15: filtered (hybrid) search at the GloVe-1.2M shape (BASELINE.json config
    #3; benchmarks/suite.py:241-320): 1,183,514 x 100 f32 rows of default_rng(60),
    cosine, EngineConfig(sweep_dtype="bfloat16"), bulk-loaded with their metadata.  B=128
    k=10 under four filters (50%, 1%, 25%, 5 rows), k=100 under the 50% one, a filtered
    similarity_search, before and after 1,000 deletes: set-exact against a float64
    oracle over the matching live rows, no hit outside the filter, every mask from the
    native evaluator, one mask upload per (snapshot, filter).  Then times at the 50%
    filter: engine wall and split, exact_knn_t light and heavy, B1 over the masked bias
    row and B2 at the engine's operands (against plain), the mask build native and in
    Python; and B5 over a filter: the default config on the first 2^18 rows, l2 and
    cosine.  Launch counts are zeroed just before the searches and read just after.
    Returns (launch counts, {kernel: max |err|}, times, bounds, record extras)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(60)
    t0 = time.perf_counter()
    db = rng.standard_normal((N_GLOVE, D_GLOVE), dtype=np.float32)
    qg = rng.standard_normal((B, D_GLOVE), dtype=np.float32)
    metas = _glove_metas(N_GLOVE)
    print(f"  corpus: {N_GLOVE:,} x {D_GLOVE} gaussian f32 and its metadata made in "
          f"{time.perf_counter() - t0:.1f} s")
    qp = QueryProcessor(SWEEP, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db, "glove", metadatas=metas)
    torch.cuda.synchronize()
    ns = qp.storage.namespace("glove")
    print(f"  bulk_load with metadata: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, "
          f"capacity {ns.capacity}, dpad {ns.dpad}, device bytes {ns.nbytes:,}; native "
          f"metadata columns: {ns.meta_columns is not None}")
    if ns.meta_columns is None:
        raise AssertionError("the native metadata columns did not build")
    rows = torch.from_numpy(db).to(dev)
    q_dev = torch.from_numpy(qg).to(dev)

    # spies: the native evaluator's calls, the Python evaluator's walk (iter_slots) and
    # the mask uploads, with the (snapshot, filter) pairs the searches used
    native_calls, python_walks, uploads, pairs, states = [0], [0], [0], set(), []
    real_eval, real_walk, real_upload = ns.meta_columns.eval, ns.iter_slots, qp_mod._upload_mask

    def eval_spy(*a, **kw):
        native_calls[0] += 1
        return real_eval(*a, **kw)

    def walk_spy():
        python_walks[0] += 1
        return real_walk()

    def upload_spy(mask, device):
        uploads[0] += 1
        return real_upload(mask, device)

    ns.meta_columns.eval, ns.iter_slots, qp_mod._upload_mask = eval_spy, walk_spy, upload_spy
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    served, dead, dead_ids, alive = {}, None, set(), torch.ones(N_GLOVE, dtype=torch.bool,
                                                                 device=dev)
    for when in ("before delete", "after delete"):
        if when == "after delete":
            # 1,000 deletes, among them each query's nearest row under the 50% filter
            half = torch.from_numpy(_glove_allowed(N_GLOVE, "half")).to(dev)
            near = sorted({int(r[0]) for r in _filtered_oracle(rows, q_dev, half, "cosine",
                                                                 1)[0]})
            others = rng.choice(np.setdiff1d(np.arange(0, N_GLOVE, 2), near),
                                1000 - len(near), replace=False)
            dead = np.asarray(sorted(near + others.tolist()))
            dead_ids = _deleted(qp, "glove", ids, dead)
            alive[torch.from_numpy(dead).to(dev)] = False
        searches = [(name, spec, K) for name, spec in HYBRID_FILTERS] + [
            ("half", HYBRID_FILTERS[0][1], K100)]
        for name, spec, k in searches:
            allowed = torch.from_numpy(_glove_allowed(N_GLOVE, name)).to(dev) & alive
            x0, t_0 = _xfer_mark(qp), qp.cert_tier_counts("glove")
            res = qp.find_similar_batch([VectorDTO(v) for v in qg], k, "glove", "cosine",
                                        filter=spec)
            xfer = _xfer(qp, x0)
            tier = [t for t, c in qp.cert_tier_counts("glove").items() if c != t_0.get(t, 0)]
            states.append(ns.device_state())        # kept alive: their ids stay distinct
            pairs.add((id(states[-1]), filters.filter_cache_key(spec)))
            if any(r["id"] in dead_ids for rs in res for r in rs):
                raise AssertionError(f"hybrid {name} k={k} {when}: a deleted id was returned")
            want = _filtered_oracle(rows, q_dev, allowed, "cosine", k)[0]
            _check_filtered(res, want, ids, spec, f"hybrid {name} k={k} {when}")
            served[f"{name} k={k} {when}"] = (tier, xfer, len(res[0]))
            if xfer[0] != 1 or len(tier) != 1 or (tier[0].endswith("fast") and xfer != (1, 1)):
                raise AssertionError(f"hybrid {name} k={k} {when}: {tier} {xfer}")
            print(f"  hybrid {name} {spec} cosine B={B} k={k} {when}: set-exact against "
                  f"the oracle over {int(allowed.sum()):,} matching live rows, "
                  f"{len(res[0])} hits a query, none outside the filter; tier {tier}, "
                  f"transfers {xfer}")
        # a filtered similarity search: the threshold between the 30th and 31st matching
        # row of one query
        spec = HYBRID_FILTERS[2][1]
        allowed = torch.from_numpy(_glove_allowed(N_GLOVE, "quarter")).to(dev) & alive
        w_ids, w_d, _ = _filtered_oracle(rows, q_dev[:1], allowed, "cosine", 31)
        threshold = float(1.0 - (w_d[0, 29] + w_d[0, 30]) / 2)
        hits = qp.similarity_search(VectorDTO(qg[0]), threshold, "glove", filter=spec)
        states.append(ns.device_state())
        pairs.add((id(states[-1]), filters.filter_cache_key(spec)))
        _check_filtered([hits], w_ids[:, :30], ids, spec,
                        f"hybrid similarity_search {when}")
        print(f"  similarity_search {spec} threshold {threshold:.6f} {when}: the oracle's "
              f"30 rows, none outside the filter")
    counts = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts([o + c for o, c in zip(outer, counts.values())])
    print(f"  launches on the filtered path: {counts}; native mask evaluations "
          f"{native_calls[0]}, Python evaluator walks {python_walks[0]}; mask uploads "
          f"{uploads[0]} for {len(pairs)} (snapshot, filter) pairs")
    if python_walks[0] or not native_calls[0]:
        raise AssertionError("a filtered search's mask did not come from the native columns")
    if uploads[0] != len(pairs):
        raise AssertionError(f"{uploads[0]} mask uploads for {len(pairs)} (snapshot, filter)")
    if counts["sweep"] < 1 or counts["gather"] < 1 or counts["int8"] or counts["f32"]:
        raise AssertionError(f"B1 and B2 did not serve the filtered searches: {counts}")

    # ---- times at the 50% filter, on the tombstoned namespace
    spec = HYBRID_FILTERS[0][1]
    st = ns.device_state()
    scope = st.prep_cache[("filter", filters.filter_cache_key(spec))]
    valid_f = scope["valid"]
    q_pad = torch.zeros((512, ns.dpad), device=dev)
    q_pad[:B, :D_GLOVE] = q_dev

    def search(light, k=16, n_live=B, defer=False):
        return fused_knn_t.exact_knn_t(
            q_pad, st.mirror, st.data, valid_f, st.sq_norms, k=k, metric="cosine",
            live_prefix=None, sweep_err=st.sweep_err, resid=st.sweep_resid,
            rscale=st.sweep_rscale, err1=st.sweep_err1, light=light, prep_cache=scope,
            report_tier=True, n_live=n_live, defer=defer)

    times, bounds, worst = {}, {}, {}
    a, kw = _capture("_window_mins_t", lambda: search(True))
    if kw.get("n_live") != B or a[1] is not None or int((a[6] >= float(MASKED)).sum()) < (
            ns.capacity // 2):
        raise AssertionError("the hybrid search did not run the light program over a bias "
                             "row masking half the store")
    got = fused_knn_t._window_mins_t(*a, **kw)
    want = fused_knn_t._window_mins_t_plain(*a, **{**kw, "zero_cache": {}})
    torch.cuda.synchronize()
    budget = _budget(a, kw)
    worst["b1"] = _check_budget(got[0], want[0], budget, "hybrid B1")[0]
    if got[1] is not None:
        worst["b1"] = max(worst["b1"], _check_budget(got[1], want[1], budget.amax(-1),
                                                     "hybrid B1 block mins")[0])
    cols = _check_live_tiles(a, kw, B, "hybrid B1")
    del got, want
    times.update(_time_b1("hybrid_sweep", a, kw))
    outs = fused_knn_t._window_mins_t(*a, **kw)
    bounds["hybrid_sweep"] = _b3_bound(a, kw, outs)
    bounds["hybrid_sweep_full_batch"] = _b3_bound(a, kw, outs, full_batch=True)
    del outs
    masked_rows = int((a[6] >= float(MASKED)).sum())
    print(f"  B1 at the 50% filter: r1={kw['r1']}, block mins {kw['emit_block_mins']}, "
          f"bound rows {len(kw['eb_rows'])}, {masked_rows:,} of {ns.capacity:,} bias rows "
          f"masked; within the budget of plain, {cols} columns computed, each bit-equal to "
          f"the full launch")
    ga, gkw = _capture("_gather_score", lambda: search(True))
    t, b, _, worst["b2"] = time_gather("hybrid_gather", ga, gkw)
    times.update(t)
    bounds.update(b)
    for light in (True, False):
        times["exact_knn_t_hybrid_" + ("light" if light else "heavy")] = _time_ms(
            lambda: search(light))
        _check_result_live(lambda n: search(light, n_live=n, defer=True),
                           f"hybrid 50% {'light' if light else 'heavy'} cosine k bucket 16")
    wall = _engine_wall(qp, qg, namespace="glove", metric="cosine", filter=spec)
    split = _engine_split(qp, qg, namespace="glove", metric="cosine", filter=spec)
    times["engine_wall_hybrid_median"] = statistics.median(wall)
    wall100 = _engine_wall(qp, qg, namespace="glove", metric="cosine", filter=spec, k=K100)
    times["engine_wall_hybrid_k100_median"] = statistics.median(wall100)
    native_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        real_eval(spec, ns.capacity)
        native_ms.append((time.perf_counter() - t0) * 1e3)
    py_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        [filters.matches_filter(m, spec) for m in metas[:1 << 16]]
        py_ms.append((time.perf_counter() - t0) * 1e3)
    times["mask_native_median"] = statistics.median(native_ms)
    times["mask_python_2e16_median"] = statistics.median(py_ms)
    ns.meta_columns.eval, ns.iter_slots, qp_mod._upload_mask = real_eval, real_walk, real_upload
    hydrate_built = qp_mod._hydrate_native() is not None
    for name in ("hybrid_sweep", "exact_knn_t_hybrid_light", "exact_knn_t_hybrid_heavy",
                 "hybrid_gather", "engine_wall_hybrid_median", "engine_wall_hybrid_k100_median",
                 "mask_native_median", "mask_python_2e16_median"):
        extra = ""
        if name == "hybrid_sweep":
            extra = (f" (plain {times[name + '_plain']:.4f}, full launch "
                     f"{times[name + '_full']:.4f}); bound {bounds[name][0]:.4f} ms "
                     f"({bounds[name][1]}), the kernel at {bounds[name][0] / times[name]:.1%}")
        print(f"  {name}: {times[name]:.4f} ms{extra}")
    print(f"  engine wall runs (ms), B={B} cosine k={K} at the 50% filter: {wall}; k={K100}: "
          f"{wall100} on {gpu}")
    print(f"  engine split, median ms (host clock; mask_build: the native mask after a "
          f"write): {split}; native hydration extension (_hydrate) built: {hydrate_built}")
    print(f"  mask build: native over {ns.capacity:,} slots {native_ms} ms; Python "
          f"matches_filter over 2^16 rows {py_ms} ms (x{N_GLOVE / 65536:.1f} for the corpus)")

    # ---- B5 over a filter: the default config's row-major path on the first 2^18 rows
    qpr = QueryProcessor(EngineConfig(), device=dev)
    idr = qpr.bulk_load(db[:N_ROW_FILTER], "glove_rows", metadatas=metas[:N_ROW_FILTER])
    fm = fused_knn._window_mins_masked
    before = (fm.launches, fm.cols)
    half = torch.from_numpy(_glove_allowed(N_ROW_FILTER, "half")).to(dev)
    mark = _row_major_mark(qpr, "glove_rows")
    for metric in ("l2", "cosine"):
        res = qpr.find_similar_batch([VectorDTO(v) for v in qg], K, "glove_rows", metric,
                                     filter=spec)
        want = _filtered_oracle(rows[:N_ROW_FILTER], q_dev, half, metric, K)[0]
        _check_filtered(res, want, idr, spec, f"row-major {metric} 50% filter")
    b5 = (fm.launches - before[0], fm.cols - before[1])
    _row_major_tier0(qpr, "glove_rows", mark, "phase 15 B5 over a filter (ROADMAP C20)")
    print(f"  row-major (B5) at {N_ROW_FILTER:,} rows, 50% filter, l2 and cosine B={B}: "
          f"set-exact, none outside the filter; B5 launches {b5[0]}, query columns {b5[1]}")
    if b5 != (2, 2 * B):
        raise AssertionError(f"B5 did not serve the filtered row-major searches: {b5}")
    str_ = qpr.storage.namespace("glove_rows").device_state()
    valid_r = str_.prep_cache[("filter", filters.filter_cache_key(spec))]["valid"]
    qr_pad = torch.zeros((512, D), device=dev)
    qr_pad[:B, :D_GLOVE] = q_dev
    a5, kw5 = _capture("_window_mins_masked", lambda: fused_knn.exact_knn_fused(
        qr_pad, str_.data, valid_r, str_.sq_norms, k=16, metric="l2", live_prefix=None,
        n_live=B), module=fused_knn)
    n_c = fused_knn_t._live_columns(a5[1].shape[1], kw5["n_live"])
    plain_args = (a5[0], a5[1][:, :n_c], a5[2][:, :n_c], a5[3])
    got = fm(*a5, **kw5)
    want = fused_knn._window_mins_masked_ref(*plain_args, **_full(kw5))
    torch.cuda.synchronize()
    worst["b5"] = _check_budget(got, want, fused_knn._phase1_budget(
        *plain_args[:3], bias=a5[3], **_full(kw5)), "hybrid B5")[0]
    t, _ = _time_b4("hybrid_masked", "_window_mins_masked", a5, kw5)
    times.update(t)
    bounds["hybrid_masked"] = _b4_bound(a5, kw5)
    bounds["hybrid_masked_full_batch"] = _b4_bound(a5, kw5, full_batch=True)
    print(f"  B5 at the filtered row-major operands ({N_ROW_FILTER:,} rows, l2, r1="
          f"{kw5['r1']}): within the budget of plain, {times['hybrid_masked']:.4f} ms (plain "
          f"{times['hybrid_masked_plain']:.4f}, full launch {times['hybrid_masked_full']:.4f}); "
          f"bound {bounds['hybrid_masked'][0]:.4f} ms ({bounds['hybrid_masked'][1]})")
    counts["masked"] = b5[0]
    extras = {"served": served, "split": split, "hydrate_built": hydrate_built,
              "mask_uploads": uploads[0], "snapshot_filter_pairs": len(pairs),
              "native_mask_calls": native_calls[0]}
    del qp, qpr, rows
    return counts, worst, times, bounds, extras


# ---- phase 16: durability and operations on phase 6's namespace ---------------------------

DURABLE_DIR = Path(__file__).resolve().parent / "build" / "durability"
N_NEW, N_DEL16, N_OVER = 10_000, 1_000, 100


@contextlib.contextmanager
def _timed_method(cls, name, record):
    """Time each call of ``cls.name`` into ``record`` (seconds, and its return value)."""
    real = getattr(cls, name)

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        record.append((time.perf_counter() - t0, out))
        return out

    setattr(cls, name, timed)
    try:
        yield
    finally:
        setattr(cls, name, real)


def _served16(qp, qs, k, label):
    """One search of the phase-6 batch: (results, launch counts, tiers added, transfers),
    the counts zeroed just before it and read just after; tier 0 with transfers (1, 1)
    and B1 and B2 launched, else it raises."""
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    before, x0 = qp.cert_tier_counts("sift"), _xfer_mark(qp)
    res = qp.find_similar_batch(qs, k, "sift", "l2")
    counts = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts(outer)
    after = qp.cert_tier_counts("sift")
    tiers = {t: n - before.get(t, 0) for t, n in after.items() if n != before.get(t, 0)}
    xfer = _xfer(qp, x0)
    print(f"  {label} k={k}: tiers {tiers}, transfers {xfer}, B1 launches {counts['sweep']}, "
          f"B2 launches {counts['gather']}")
    if xfer != (1, 1) or set(tiers) - {"fast", "light_fast"} or counts["sweep"] < 1 or (
            counts["gather"] < 1):
        raise AssertionError(f"{label} k={k}: not served by B1 and B2 at tier 0 with one copy "
                             f"each way: {tiers} {xfer} {counts}")
    return res, counts


def _same_answers(got, want, label):
    """Each query's ids equal as sets, each id's score equal to f32 rounding."""
    worst = 0.0
    for a, b in zip(got, want):
        sa, sb = {r["id"]: r["score"] for r in a}, {r["id"]: r["score"] for r in b}
        if sa.keys() != sb.keys():
            raise AssertionError(f"{label}: the ids differ from the reference processor's")
        for i, v in sa.items():
            worst = max(worst, abs(v - sb[i]) / max(abs(sb[i]), 1e-30))
    print(f"  {label}: the same ids as the reference processor, scores within {worst:.3e} "
          f"relative")
    if worst > 1e-6:
        raise AssertionError(f"{label}: scores differ by {worst} relative")


def _recovered_oracle(oracle, gone, extra_rows, extra_keys, q_np, k):
    """Each query's k nearest keys over the recovered rows (float64): the original
    corpus's kept nearest rows without ``gone``, merged with ``extra_rows`` (keys
    ``extra_keys``).  Raises if a kept list ran short of the merge's k-th distance."""
    rows, dists = oracle.nearest("l2", B)
    q64, x64 = q_np.astype(np.float64), extra_rows.astype(np.float64)
    d_extra = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :] - 2 * q64 @ x64.T)
    out = []
    for i in range(B):
        keep = [(d, int(r)) for r, d in zip(rows[i], dists[i]) if int(r) not in gone]
        cand = keep + [(d, key) for d, key in zip(d_extra[i].tolist(), extra_keys)]
        cand.sort(key=lambda c: c[0])
        if cand[k - 1][0] > dists[i][-1]:
            raise AssertionError(f"oracle: query {i} needs more than the kept rows")
        out.append({key for _, key in cand[:k]})
    return out


def run_durability(qps, ids, db_np, q_np, oracle, dead, gpu):
    """Phase 16 (see the module docstring).  Returns the launch counts of its searches, the
    printed figures and the warmup's launches."""
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    DURABLE_DIR.mkdir(parents=True)
    snap, wal = str(DURABLE_DIR / "snapshot"), str(DURABLE_DIR / "wal")
    dev = torch.device("cuda")
    qs = [VectorDTO(v) for v in q_np]
    src = qps.storage.namespace("sift")
    want = {k: qps.find_similar_batch(qs, k, "sift", "l2") for k in (K, K100)}
    figs, launches = {}, {"sweep": 0, "gather": 0}

    def add(counts):
        launches["sweep"] += counts["sweep"]
        launches["gather"] += counts["gather"]

    # ---- 1. snapshot round trip
    t0 = time.perf_counter()
    qps.save(snap)
    figs["save_s"] = time.perf_counter() - t0
    disk = sum(f.stat().st_size for f in Path(snap).iterdir())
    figs["snapshot_bytes"] = disk
    print(f"  save: {figs['save_s']:.3f} s, {disk:,} B on disk ({len(qps.list_namespaces())} "
          f"namespaces), {disk / figs['save_s'] / 1e6:.1f} MB/s")
    t0 = time.perf_counter()
    qp1 = QueryProcessor.load(snap, SWEEP, device=dev)
    torch.cuda.synchronize()
    figs["load_s"] = time.perf_counter() - t0
    ns1 = qp1.storage.namespace("sift")
    print(f"  load on the card: {figs['load_s']:.3f} s; nbytes {ns1.nbytes:,} (source "
          f"{src.nbytes:,}), live {ns1.live_count:,} (source {src.live_count:,})")
    if (ns1.nbytes, ns1.live_count) != (src.nbytes, src.live_count):
        raise AssertionError("the loaded namespace differs from the source in bytes or rows")
    for k in (K, K100):
        res, counts = _served16(qp1, qs, k, "loaded")
        add(counts)
        _same_answers(res, want[k], f"loaded k={k}")
        _check_recall(res, oracle.sets("l2", B, dead, k=k), ids, f"loaded l2 B={B}", k=k)
    del qp1, ns1, res

    # ---- 2. crash recovery from the snapshot and the WAL
    live = QueryProcessor.load(snap, SWEEP, wal_path=wal, wal_fsync=True, device=dev)
    rng = np.random.default_rng(SEED + 16)
    new = rng.standard_normal((N_NEW, D), dtype=np.float32)
    new[:B] = q_np + np.float32(0.3) * rng.standard_normal((B, D), dtype=np.float32)
    added = []
    t0 = time.perf_counter()
    for b in range(N_NEW // 100):
        added += live.upsert_many(
            [VectorDTO(new[j], {"batch": b, "j": j}) for j in range(b * 100, b * 100 + 100)],
            "sift")
    # the deletes: each query's nearest surviving row first, then random surviving rows
    alive = np.setdiff1d(np.arange(N), dead)
    first = sorted({next(iter(s)) for s in oracle.sets("l2", B, dead, k=1)})
    pool = np.setdiff1d(alive, first)
    del16 = np.asarray(first + rng.choice(pool, N_DEL16 - len(first), replace=False).tolist())
    removed = live.delete([ids[i] for i in del16], "sift")
    # one batch overwriting 100 surviving ids, with values near the first 100 queries
    over_idx = rng.choice(np.setdiff1d(pool, del16), N_OVER, replace=False)
    over_vals = (q_np[:N_OVER] + np.float32(0.2) * rng.standard_normal((N_OVER, D),
                                                                     dtype=np.float32))
    live.upsert_many([VectorDTO(over_vals[i], {"over": i}, id=ids[over_idx[i]])
                      for i in range(N_OVER)], "sift")
    figs["acked_writes_s"] = time.perf_counter() - t0
    wal_bytes = sum(f.stat().st_size for f in Path(wal).iterdir() if f.is_file())
    print(f"  acknowledged with fsync: {N_NEW:,} rows in {N_NEW // 100} upsert_many batches, "
          f"{len(removed)} deletes, {N_OVER} overwrites in {figs['acked_writes_s']:.2f} s; "
          f"WAL {wal_bytes:,} B")
    if len(removed) != N_DEL16:
        raise AssertionError(f"{len(removed)} of {N_DEL16} deletes acknowledged")
    acked = {k: live.find_similar_batch(qs, k, "sift", "l2") for k in (K, K100)}
    del live   # abandoned: no save(), no close()

    replays = []
    t0 = time.perf_counter()
    with _timed_method(QueryProcessor, "replay_wal", replays):
        rec = QueryProcessor.load(snap, SWEEP, wal_path=wal, device=dev)
    torch.cuda.synchronize()
    figs["recover_s"] = time.perf_counter() - t0
    figs["replay_s"], figs["replay_records"] = replays[0]
    figs["replay_records_per_s"] = figs["replay_records"] / figs["replay_s"]
    print(f"  recovered with QueryProcessor.load(snapshot, wal_path=...): "
          f"{figs['recover_s']:.3f} s, of which the replay {figs['replay_s']:.3f} s for "
          f"{figs['replay_records']} records ({figs['replay_records_per_s']:.1f} records/s, "
          f"{(N_NEW + N_DEL16 + N_OVER) / figs['replay_s']:.0f} row operations/s)")
    n_rec = N - len(dead) + N_NEW - N_DEL16
    if rec.get_namespace_count("sift") != n_rec:
        raise AssertionError(f"recovered {rec.get_namespace_count('sift')} rows, not {n_rec}")
    for v in added:
        got = rec.storage.read(v.id, "sift")
        if got is None or not np.array_equal(got.values, v.values) or got.metadata != v.metadata:
            raise AssertionError(f"acknowledged upsert {v.id} did not read back")
    for i in range(N_OVER):
        got = rec.storage.read(ids[over_idx[i]], "sift")
        if not np.array_equal(got.values, over_vals[i]) or got.metadata != {"over": i}:
            raise AssertionError(f"overwrite of {ids[over_idx[i]]} did not read back")
    if any(rec.storage.read(ids[i], "sift") is not None for i in np.concatenate([dead, del16])):
        raise AssertionError("a deleted id is present after the recovery")
    print(f"  every acknowledged write read back: {N_NEW:,} upserts, {N_OVER} overwrites; none "
          f"of the {len(dead) + N_DEL16:,} deleted ids present")
    keys = [("new", j) for j in range(N_NEW)] + [int(i) for i in over_idx]
    uuid_of = {("new", j): added[j].id for j in range(N_NEW)}
    uuid_of.update({i: ids[i] for i in range(N)})
    gone = set(np.concatenate([dead, del16, over_idx]).tolist())
    for k in (K, K100):
        res, counts = _served16(rec, qs, k, "recovered")
        add(counts)
        _same_answers(res, acked[k], f"recovered k={k}")
        want_sets = _recovered_oracle(oracle, gone, np.concatenate([new, over_vals]), keys,
                                      q_np, k)
        hits = sum(len({r["id"] for r in rs} & {uuid_of[x] for x in w})
                   for rs, w in zip(res, want_sets))
        print(f"  recovered l2 B={B}: recall@{k} = {hits / (B * k)} against the oracle over "
              f"the recovered rows")
        if hits != B * k or any(len(rs) != k for rs in res):
            raise AssertionError(f"recovered k={k}: recall@{k} = {hits / (B * k)}")

    # ---- 3. offload and page-in
    ns = rec.storage.namespace("sift")
    nbytes = ns.nbytes
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if not rec.offload_namespace("sift"):
        raise AssertionError("offload_namespace returned False")
    figs["offload_s"] = time.perf_counter() - t0
    figs["offload_freed_bytes"] = m0 - torch.cuda.memory_allocated()
    offloaded = rec.get_storage_info()["offloaded_namespaces"]
    print(f"  offload: {figs['offload_s']:.3f} s, device memory freed "
          f"{figs['offload_freed_bytes']:,} B of nbytes {nbytes:,} "
          f"({figs['offload_freed_bytes'] / nbytes:.3f}); offloaded {offloaded}")
    if figs["offload_freed_bytes"] < 0.9 * nbytes or "sift" not in offloaded:
        raise AssertionError("offload did not free the namespace's device memory")
    rec._result_cache.clear()   # the batch's cached answers would serve without a page-in
    pageins = []
    t0 = time.perf_counter()
    with _timed_method(NamespaceStore, "ensure_resident", pageins):
        res, counts = _served16(rec, qs, K, "paged in")
    figs["first_search_after_offload_ms"] = (time.perf_counter() - t0) * 1e3
    figs["page_in_ms"] = pageins[0][0] * 1e3
    add(counts)
    print(f"  page-in {figs['page_in_ms']:.1f} ms inside the first search "
          f"({figs['first_search_after_offload_ms']:.1f} ms); nbytes {ns.nbytes:,}")
    _same_answers(res, acked[K], "paged in k=10")
    if ns.nbytes != nbytes or ns.offloaded:
        raise AssertionError("the paged-in namespace differs in bytes")

    # ---- 4. operations
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    t0 = time.perf_counter()
    n_prog, report = rec.warmup("sift", detail=True)
    torch.cuda.synchronize()
    figs["warmup_s"] = time.perf_counter() - t0
    warm = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts(outer)
    print(f"  warmup: {n_prog} programs in {figs['warmup_s']:.3f} s, B1 launches "
          f"{warm['sweep']} (heavy {warm['sweep_heavy']}, pool {warm['topm']}, zero-query "
          f"fills {warm['zero']}), B2 launches {warm['gather']}; seconds per program {report}")
    if n_prog != 24 or warm["sweep"] < n_prog:
        raise AssertionError(f"warmup ran {n_prog} programs with {warm} launches")
    plan = rec.explain_query(qs[0], K, "sift")
    stats = rec.get_statistics()
    print(f"  explain_query: {plan}")
    print(f"  get_statistics: {stats}")
    if "tiers_by_namespace" not in stats["exactness"] or plan["certificate_dispatch"] != "light":
        raise AssertionError("statistics without tiers, or a namespace not on the light program")
    health = deep_health(rec)
    print(f"  deep_health: {health}")
    if (health["status"] != "healthy" or health["device"]["platform"] != "gpu"
            or health["device"]["devices"][0] != torch.cuda.get_device_name(0)):
        raise AssertionError("deep_health did not report the card healthy")
    text = render_metrics(rec, RECORDER)
    print(f"  render_metrics: {len(text.splitlines())} lines, e.g. "
          f"{[line for line in text.splitlines() if 'device_memory' in line and '#' not in line]}")
    if "vectordb_device_memory_bytes" not in text or "vectordb_queries_total" not in text:
        raise AssertionError("render_metrics lacks the device memory or query metrics")
    cap = plan_capacity(100_000_000, 1536, EngineConfig(dtype="bfloat16", sweep_dtype="bfloat16"))
    print(f"  plan_capacity 100M x 1536 bf16 same-dtype on {gpu}: {cap}")
    if cap.hbm_per_chip != torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError("plan_capacity did not detect the card's memory")
    PROFILER.start(str(DURABLE_DIR / "profile"))
    rec.find_similar_batch([VectorDTO(v) for v in q_np + np.float32(7e-3)], K, "sift", "l2")
    trace = PROFILER.stop()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"  PROFILER: {trace} ({Path(trace).stat().st_size:,} B), {kernels} kernel events, "
          f"spans {sorted({e['name'] for e in events if e.get('name') in RECORDER.summary()})}")
    if kernels < 1 or not any(e.get("name") == "knn_kernel" for e in events):
        raise AssertionError("the profiler trace holds no kernel or no knn_kernel span")
    figs.update({"warmup_programs": n_prog, "warmup_sweep_launches": warm["sweep"],
                 "warmup_gather_launches": warm["gather"]})
    del rec, ns
    return launches, figs


# ---- phase 17: IVF at the SIFT-1M stand-in ----------------------------------------------

N_IVF, D_IVF, NQ_IVF = 1 << 20, 128, 128
NPROBES = (1, 4, 16, 64, 2048)
N_SLICE = 1 << 16
N_IVF_WRITES = 1_000
IVF_DIR = Path(__file__).resolve().parent / "build" / "ivf"


def synthesize_clustered(n, dim, n_queries, *, n_clusters, within_scale, anisotropy=4.0,
                         zipf_s=1.2, normalize=False, seed=7):
    """Anisotropic Gaussian-mixture corpus with heavy-tailed (Zipf) cluster sizes, and
    queries drawn as perturbations of held-out corpus points: a copy of
    benchmarks/datasets.py:88-131 (the JAX package's SIFT-1M stand-in), the same draws."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    scales = within_scale * (
        1.0 + (anisotropy - 1.0) * (rng.random((n_clusters, dim)) ** 4)
    ).astype(np.float32)
    w = (1.0 / np.arange(1, n_clusters + 1) ** zipf_s)
    w /= w.sum()
    counts = rng.multinomial(n + n_queries, w)
    rows = np.empty((n + n_queries, dim), np.float32)
    pos = 0
    for c, cnt in enumerate(counts):
        if cnt == 0:
            continue
        rows[pos : pos + cnt] = centers[c] + scales[c] * rng.standard_normal(
            (cnt, dim)
        ).astype(np.float32)
        pos += cnt
    rng.shuffle(rows)
    data, held = rows[:n], rows[n:]
    queries = held + 0.1 * within_scale * rng.standard_normal(held.shape).astype(np.float32)
    if normalize:
        data = data / np.maximum(np.linalg.norm(data, axis=1, keepdims=True), 1e-12)
        queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    return {"data": data, "queries": queries}


class _IvfOracle:
    """float64 l2 distances of the queries to every corpus row, on the card: the k-th
    distance per query, and a tolerance of f32 cancellation (16 ulps of qn + max sqn, as
    _check_kdists) for the rows a search returns."""

    def __init__(self, x, q):
        self.x64 = torch.from_numpy(x).cuda().double()
        q64 = torch.from_numpy(q).cuda().double()
        sq = (self.x64 * self.x64).sum(1)
        self.d = (q64 * q64).sum(1)[:, None] + sq[None, :] - 2.0 * (q64 @ self.x64.T)
        self.top = torch.topk(self.d, K, dim=1, largest=False)
        self.kth = self.top.values[:, -1]
        self.tol = 16 * 2.0 ** -24 * ((q64 * q64).sum(1) + sq.max())
        self.sets = [set(r) for r in self.top.indices.cpu().tolist()]

    def hits(self, rows):
        """[nq] returned rows within the k-th distance (ties at f32 rounding count)."""
        out = []
        for i, rs in enumerate(rows):
            d = self.d[i, torch.as_tensor(rs, dtype=torch.int64, device="cuda")]
            out.append(int((d <= self.kth[i] + self.tol[i]).sum()))
        return out

    def exact(self, rows, label):
        """Each query's rows are the oracle's k nearest: the same set, or (ties) every row
        within the k-th distance; raises otherwise.  Returns how many sets differ."""
        differ = sum(set(rs) != s for rs, s in zip(rows, self.sets))
        if any(len(rs) != K for rs in rows) or min(self.hits(rows)) < K:
            raise AssertionError(f"{label}: not the k nearest rows of the float64 oracle")
        return differ


def _ivf_rows(results, row_of):
    return [[row_of[r["id"]] for r in rs] for rs in results]


def _ivf_search_ms(qp, ns, q_np, nprobe, runs):
    """Device ms of one IVF search of the batch (the index's probe scan at the engine's
    k_fetch, ending in its copy to the host), CUDA events, mean of ``runs`` after a warm
    call."""
    ivf = ns.ivf
    q = torch.zeros((q_np.shape[0], ns.dpad), dtype=torch.float32, device="cuda")
    q[:, : ns.dim] = torch.from_numpy(q_np).cuda()
    k_fetch = min(K * ivf.spill, ivf.C * ivf.L)
    return _time_ms(lambda: fused_knn_t.fetch(*ivf.search(q, k_fetch, "l2", nprobe)[:2]),
                    iters=runs)


def _ivf_curve(qp, ns, qs, q_np, oracle, row_of, label):
    """Recall@10 per nprobe (per query never falling as nprobe grows), ms per batch,
    transfers (1, 1) per search; the full probe exact.  Returns (curve, ms, rows at C)."""
    curve, ms, prev, full = {}, {}, None, None
    for nprobe in NPROBES:
        x0 = _xfer_mark(qp)
        res = qp.find_similar_batch(qs, K, "ivf", "l2", nprobe=nprobe)
        xfer = _xfer(qp, x0)
        if xfer != (1, 1):
            raise AssertionError(f"{label} nprobe={nprobe}: transfers {xfer}")
        rows = _ivf_rows(res, row_of)
        hits = oracle.hits(rows)
        if prev is not None and any(h < p for h, p in zip(hits, prev)):
            raise AssertionError(f"{label}: a query's recall fell from nprobe "
                                 f"{NPROBES[NPROBES.index(nprobe) - 1]} to {nprobe}")
        prev = hits
        curve[nprobe] = sum(hits) / (K * len(hits))
        ms[nprobe] = _ivf_search_ms(qp, ns, q_np, nprobe, 2 if nprobe > 64 else 10)
        if nprobe == NPROBES[-1]:
            full = rows
    differ = oracle.exact(full, f"{label} nprobe={NPROBES[-1]}")
    print(f"  {label}: recall@10 {curve}; ms per batch {ms}; transfers (1, 1) each; the "
          f"full probe exact ({differ} sets differ from the oracle's by ties)")
    return curve, ms, full


def _timed_build(qp, spill, label):
    """build_ivf on the namespace, timed to the card's synchronisation, and its k-means,
    assignment, host layout and device scatter as the build's own spans record them in
    RECORDER (host spans: the scatter's device work ends in the rest)."""
    t_start = time.time()
    t0 = time.perf_counter()
    stats = qp.build_ivf("ivf", spill=spill)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    spans = {e["name"]: e["elapsed_ms"] / 1e3 for e in RECORDER.recent()
             if e["start"] >= t_start and e["name"].startswith("ivf_build.")}
    secs = {key: spans[f"ivf_build.{key}"] for key in ("kmeans", "assign", "layout", "scatter")}
    secs["rest"] = total - sum(secs.values())
    secs["build_ivf"] = total
    print(f"  {label}: build_ivf {total:.3f} s: k-means {secs['kmeans']:.3f} s, assignment "
          f"{secs['assign']:.3f} s, host layout {secs['layout']:.3f} s, device scatter "
          f"{secs['scatter']:.3f} s (its launch), the rest {secs['rest']:.3f} s; {stats}")
    return stats, secs


def run_ivf(gpu):
    """Phase 17 (see the module docstring).  Returns its record and the processor, whose
    namespace phase 18 serves."""
    t0 = time.perf_counter()
    syn = synthesize_clustered(N_IVF, D_IVF, 1000, n_clusters=2000, within_scale=0.9,
                               anisotropy=6.0, seed=7)
    x, q_np = syn["data"], syn["queries"][:NQ_IVF]
    print(f"  corpus {x.shape} clustered (n_clusters 2000, within_scale 0.9, anisotropy "
          f"6.0, seed 7) and {len(q_np)} held-out queries in {time.perf_counter() - t0:.1f} s")
    qp = QueryProcessor(EngineConfig(), device="cuda")
    t0 = time.perf_counter()
    ids = qp.bulk_load(x, "ivf")
    torch.cuda.synchronize()
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s")
    ns = qp.storage.namespace("ivf")
    row_of = {vid: i for i, vid in enumerate(ids)}
    oracle = _IvfOracle(x, q_np)
    qs = [VectorDTO(v) for v in q_np]
    rec = {"gpu": gpu, "rows": N_IVF, "dim": D_IVF, "queries": NQ_IVF, "k": K}

    # the exact path, for the full probe's comparison
    exact_rows = _ivf_rows(qp.find_similar_batch(qs, K, "ivf", "l2"), row_of)
    oracle.exact(exact_rows, "exact find_similar_batch")
    stats1, secs1 = _timed_build(qp, 1, "spill 1")
    if (stats1["clusters"], stats1["cluster_capacity"]) != (2048, 1128):
        raise AssertionError(f"C, L = {stats1['clusters']}, {stats1['cluster_capacity']}")
    curve1, ms1, full1 = _ivf_curve(qp, ns, qs, q_np, oracle, row_of, "spill 1")
    same = sum(set(a) == set(b) for a, b in zip(full1, exact_rows))
    print(f"  full probe against the exact path: {same} of {NQ_IVF} sets equal, the rest "
          f"ties within f32 rounding (both within the oracle's k-th distance)")
    t0 = time.perf_counter()
    exact_ms = statistics.median(_engine_wall(qp, q_np, namespace="ivf"))
    print(f"  exact engine wall (B4/B5 path) median of 5: {exact_ms:.4f} ms "
          f"({time.perf_counter() - t0:.1f} s)")
    stats2, secs2 = _timed_build(qp, 2, "spill 2")
    curve2, ms2, _ = _ivf_curve(qp, ns, qs, q_np, oracle, row_of, "spill 2")
    rec.update({"spill1": {"stats": stats1, "seconds": secs1, "recall": curve1, "ms": ms1},
                "spill2": {"stats": stats2, "seconds": secs2, "recall": curve2, "ms": ms2},
                "exact_engine_wall_ms": exact_ms})

    # the card's index against a CPU build of the same rows and seed
    t0 = time.perf_counter()
    built = {}
    for dev in ("cuda", "cpu"):
        sub = QueryProcessor(EngineConfig(), device=dev)
        sub.bulk_load(x[:N_SLICE], "slice", ids=ids[:N_SLICE])
        sub.build_ivf("slice", seed=0)
        res = sub.find_similar_batch(qs, K, "slice", "l2", nprobe=4)
        built[dev] = (sub.storage.namespace("slice").ivf, [[r["id"] for r in rs] for rs in res])
    (ic, rc), (ih, rh) = built["cuda"], built["cpu"]
    rel = float((ic.centroids.cpu() - ih.centroids).abs().max() / ih.centroids.abs().max())
    same_slots = ic._id_to_slot == ih._id_to_slot
    print(f"  card vs CPU build of {N_SLICE} rows (C {ih.C}, L {ih.L}): centroids within "
          f"{rel:.3e} relative, assignment equal {same_slots}, ids at nprobe 4 equal "
          f"{rc == rh} ({time.perf_counter() - t0:.1f} s)")
    if rel > 1e-5 or not same_slots or rc != rh:
        raise AssertionError("the card's IVF build differs from the CPU's")
    rec["card_vs_cpu"] = {"rows": N_SLICE, "centroid_rel": rel, "assignment_equal": same_slots,
                          "ids_nprobe4_equal": rc == rh}
    del built, ic, ih, sub

    # the index follows upserts and deletes through the engine
    rng = np.random.default_rng(71)
    new = x[rng.choice(N_IVF, N_IVF_WRITES, replace=False)] + rng.standard_normal(
        (N_IVF_WRITES, D_IVF)).astype(np.float32)
    t0 = time.perf_counter()
    vs = qp.upsert_many([VectorDTO(v, {"new": i}) for i, v in enumerate(new)], "ivf")
    up_s = time.perf_counter() - t0
    gone = [ids[i] for i in rng.choice(N_IVF, N_IVF_WRITES, replace=False)]
    t0 = time.perf_counter()
    removed = qp.delete(gone, "ivf")
    del_s = time.perf_counter() - t0
    ivf = ns.ivf
    if (len(removed) != N_IVF_WRITES or ivf.live_count != ns.live_count
            or any(v.id not in ivf._id_to_slot for v in vs)
            or any(g in ivf._id_to_slot for g in gone)):
        raise AssertionError("the index does not hold the upserted ids or still holds deleted")
    # every copy of a new id holds its row; every copy of a deleted id is invalid
    g = ivf._gen
    new_slots = [[ivf._id_to_slot[v.id]] + ivf._extra_slots.get(v.id, []) for v in vs]
    flat = torch.as_tensor([s for ss in new_slots for s in ss], device="cuda")
    want_rows = torch.from_numpy(np.repeat(new, [len(ss) for ss in new_slots], axis=0)).cuda()
    held = bool(torch.equal(g.data3.view(-1, ns.dpad)[flat, :D_IVF], want_rows)
                and g.valid3.view(-1)[flat].all())
    top = qp.find_similar_batch([VectorDTO(v) for v in new[:NQ_IVF]], 1, "ivf", "l2",
                                nprobe=ivf.C)
    found = sum(r[0]["id"] == v.id for r, v in zip(top, vs))
    at16 = qp.find_similar_batch([VectorDTO(v) for v in new], 1, "ivf", "l2", nprobe=16)
    found16 = sum(r[0]["id"] == v.id for r, v in zip(at16, vs))
    dead = set(gone)
    gone_q = [VectorDTO(x[row_of[gid]]) for gid in gone[:NQ_IVF]]
    leaked = sum(r["id"] in dead for rs in qp.find_similar_batch(gone_q, K, "ivf", "l2",
                                                                   nprobe=ivf.C) for r in rs)
    print(f"  upsert of {N_IVF_WRITES} rows {up_s:.3f} s, delete of {N_IVF_WRITES} "
          f"{del_s:.3f} s: every copy of each new row in the index {held}; the first "
          f"{NQ_IVF} new rows each their own nearest at full probe {found}/{NQ_IVF} (all "
          f"{N_IVF_WRITES} at nprobe 16: {found16}); deleted ids returned at full probe "
          f"{leaked}; index live {ivf.live_count} = store live {ns.live_count}, drift "
          f"{ivf._drift}")
    if not held or found != NQ_IVF or leaked:
        raise AssertionError("the index did not follow the upserts or the deletes")
    rec["writes"] = {"upsert_s": up_s, "delete_s": del_s, "found_nprobe16": found16,
                     "drift": ivf._drift}

    # a snapshot with the IVF entry, loaded back on the card: the same ids
    shutil.rmtree(IVF_DIR, ignore_errors=True)
    want = [[r["id"] for r in rs]
            for rs in qp.find_similar_batch(qs, K, "ivf", "l2", nprobe=16)]
    t0 = time.perf_counter()
    qp.save(str(IVF_DIR))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = QueryProcessor.load(str(IVF_DIR), EngineConfig(), device="cuda")
    load_s = time.perf_counter() - t0
    lns = loaded.storage.namespace("ivf")
    got = [[r["id"] for r in rs]
           for rs in loaded.find_similar_batch(qs, K, "ivf", "l2", nprobe=16)]
    print(f"  save with the IVF entry {save_s:.2f} s, load on the card {load_s:.2f} s: the "
          f"same layout {lns.ivf._id_to_slot == ivf._id_to_slot}, the same ids at nprobe 16 "
          f"{got == want}")
    if got != want or lns.ivf._id_to_slot != ivf._id_to_slot:
        raise AssertionError("the reloaded IVF index answers differently")
    rec["snapshot"] = {"save_s": save_s, "load_s": load_s}
    del loaded, lns, oracle
    shutil.rmtree(IVF_DIR, ignore_errors=True)
    return rec, qp, q_np


# ---- phase 19: the distributed engine ----------------------------------------------------

# the kernels a sharded search can launch, per shard: B1 and B2 over a mirror, B5 without
_MESH_COUNTERS = ((fused_knn_t._window_mins_t, "launches"), (fused_knn_t._gather_score, "launches"),
                  (fused_knn._window_mins_masked, "launches"),
                  (fused_knn._window_mins_fast, "launches"))
_MESH_NAMES = ("sweep", "gather", "masked", "fast")


def _mesh_counts():
    return [getattr(fn, a) for fn, a in _MESH_COUNTERS]


def _set_mesh_counts(values):
    for (fn, a), v in zip(_MESH_COUNTERS, values):
        setattr(fn, a, v)


def _mesh_search(qp, namespace, q_np, metric, nq, k, nprobe=None):
    """One find_similar_batch on a distributed processor: (results, its (h2d, d2h)
    transfers, the launches it added per kernel)."""
    x0, c0 = _xfer_mark(qp), _mesh_counts()
    res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], k, namespace, metric,
                                nprobe=nprobe)
    xfer = _xfer(qp, x0)
    return res, xfer, dict(zip(_MESH_NAMES, (c - b for c, b in zip(_mesh_counts(), c0))))


def _same_as(got, want, label):
    """The unsharded processor's answers: the same ids, scores within 1e-5."""
    for g, w in zip(got, want):
        if [r["id"] for r in g] != [r["id"] for r in w] and (
                {r["id"] for r in g} != {r["id"] for r in w}):
            raise AssertionError(f"{label}: not the unsharded processor's ids")
        if not np.allclose(sorted(r["score"] for r in g), sorted(r["score"] for r in w),
                           rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{label}: not the unsharded processor's scores")


def _live_replicas(nq, r):
    """Replicas of an r-way mesh holding a live query of an nq-query batch (its bucket
    split r ways)."""
    br = EngineConfig().bucket_batch(nq) // r
    return sum(1 for i in range(r) if nq > i * br)


def _mesh_checks(res, xfer, launched, s, r_live, rowmajor, label):
    """A sharded search launched its kernel once on each shard of each replica holding a
    live query, crossed once each way when every shard certified (more only through an
    escalation, whose B2 or scan launches show), and nothing else."""
    want = {"sweep": 0, "masked": s * r_live} if rowmajor else {"sweep": s * r_live,
                                                                "masked": 0}
    if ({k: launched[k] for k in want} != want or launched["fast"] or xfer[0] != 1
            or (rowmajor and launched["gather"]) or (xfer[1] != 1 and rowmajor)
            or (not rowmajor and launched["gather"] < s * r_live)
            or (not rowmajor and xfer[1] == 1 and launched["gather"] != s * r_live)):
        raise AssertionError(f"{label}: launches {launched}, transfers {xfer}")
    return xfer == (1, 1)


MESH_DIR = DURABLE_DIR.parent / "mesh"


def _oracle_scores(res, oracle, metric, nq, dead, k, label):
    """Each query's scores are the float64 oracle's k nearest distances (cosine: 1 - the
    distance), within 1e-5."""
    dead = set() if dead is None else set(np.asarray(dead).tolist())
    rows, dist = oracle.nearest(metric, nq)
    for r, d, got in zip(rows.tolist(), dist.tolist(), res):
        want = np.array([x for i, x in zip(r, d) if i not in dead][:k])
        score = np.sort([1.0 - h["score"] if metric == "cosine" else h["score"] for h in got])
        if len(score) != len(want) or not np.allclose(score, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{label}: scores are not the oracle's distances")


def _merge_span(qp, q_np, namespace, metric, k):
    """The cross-shard merge of one engine search, read from the search's own
    ``knn_sharded.merge`` span: (the host's ms in the span from RECORDER, the device ms of
    what was launched inside it from a PROFILER trace, the kernels counted).  Each launch
    that the trace places inside the span is matched to its kernel by correlation id; a
    trace without them gives (host ms, None, 0): not measured."""
    qs = [VectorDTO(v) for v in q_np + np.float32(0.5e-3)]   # no cached answer
    t_start = time.time()
    PROFILER.start(str(MESH_DIR / "profile"))
    qp.find_similar_batch(qs, k, namespace, metric)
    trace = PROFILER.stop()
    host = [e["elapsed_ms"] for e in RECORDER.recent()
            if e["start"] >= t_start and e["name"] == "knn_sharded.merge"]
    if len(host) != 1:
        raise AssertionError(f"one search recorded {len(host)} knn_sharded.merge spans")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "knn_sharded.merge" and e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(a <= e["ts"] <= b for a, b in spans)}
    device = [e["dur"] for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("args", {}).get("correlation") in launched]
    return host[0], (sum(device) / 1e3 if device else None), len(device)


def run_mesh(gpu, deep, sift):
    """Phase 19 (see the module docstring).  Returns (the {"mesh": ...} record, the launch
    counts of the two cells' counted runs, {time name: ms}, {bound name: bound},
    {kernel: max |kernel - plain|})."""
    rec, times, bounds, worst = {"card": gpu}, {}, {}, {}
    # ---- (a) DEEP on a (1, 4) mesh: the first half of phase 12's rows (its depth cut to
    # keep the run inside its time limit; the sharded ingest is the longest step)
    n_a = N_DEEP // 2
    dead_a = np.asarray([i for i in deep["dead"] if i < n_a])
    oracle_a = DeviceOracle(deep["oracle"].rows[:n_a], deep["qd"])
    devs = mesh_devices(4, "cuda")
    qpd = make_distributed_processor(1, 4, DEEP, devices=devs)
    sm = qpd.sharding_manager
    print(f"  (a) DEEP sharded: make_distributed_processor(1, 4), shard s on "
          f"{[str(d) for d in sm.mesh.devices[0]]} ({torch.cuda.device_count()} visible)")
    t0 = time.perf_counter()
    ids = qpd.bulk_load(deep["db"][:n_a], "deep", ids=deep["ids"][:n_a])
    torch.cuda.synchronize()
    nsd = qpd.storage.namespace("deep")
    st = nsd.device_state()
    per_cell = [cell.data.numel() * cell.data.element_size() for cell in st.shards[0]]
    rec["deep"] = {"ingest_s": time.perf_counter() - t0, "rows": n_a,
                   "shard_capacity": nsd.shard_capacity, "capacity": nsd.capacity,
                   "device_bytes": nsd.nbytes, "row_bytes_per_shard": per_cell,
                   "placement": [str(d) for d in sm.mesh.devices[0]]}
    print(f"  bulk_load: {n_a:,} rows in {rec['deep']['ingest_s']:.2f} s; shard capacity "
          f"{nsd.shard_capacity:,}, capacity {nsd.capacity:,} rows ({nsd.capacity / n_a:.1f}x "
          f"the rows: each shard sized for a whole batch hashing to it), device bytes "
          f"{nsd.nbytes:,} (phase 12's unsharded store {deep['qp'].storage.namespace('deep').nbytes:,})")
    if any(st_.mirror is None or st_.mirror.data_ptr() != st_.data.data_ptr()
           for st_ in st.shards[0]):
        raise AssertionError("a DEEP shard does not sweep its own bf16 rows")
    searches = (("cosine", B, K), ("cosine", B, K100), ("l2", B, K))
    outer = _mesh_counts()
    _set_mesh_counts([0] * len(outer))
    served, certified = {}, 0
    for when, dead_rows in (("before delete", None), ("after delete", dead_a)):
        if dead_rows is not None:
            qpd.delete([ids[i] for i in dead_rows], "deep")
        for metric, nq, k in searches:
            label = f"sharded DEEP {metric} B={nq} k={k} {when}"
            res, xfer, launched = _mesh_search(qpd, "deep", deep["qd"], metric, nq, k)
            certified += _mesh_checks(res, xfer, launched, 4, 1, False, label)
            served[f"{metric} k={k} {when}"] = {"transfers": xfer, "launches": launched}
            _check_recall(res, oracle_a.sets(metric, nq, dead_rows, k=k), ids,
                          label + " (bf16-row oracle)", k=k)
            _oracle_scores(res, oracle_a, metric, nq, dead_rows, k, label)
    counts_a = dict(zip(_MESH_NAMES, _mesh_counts()))
    if not certified or counts_a["sweep"] != 4 * 2 * len(searches) or counts_a["gather"] < 4:
        raise AssertionError(f"sharded DEEP: launches {counts_a}, {certified} certified")
    print(f"  DEEP sharded per batch: {served}; {certified} of {2 * len(searches)} certified "
          f"with transfers (1, 1); launches {counts_a}; recall 1.0 and the oracle's scores")
    rec["deep"]["searches"] = served
    rec["deep"]["launches"] = counts_a

    # per-shard B1 and B2 at the operands of the engine's cosine B=128 search (k bucket 16),
    # against their plain versions; the merge; the engine wall beside phase 12's
    q_pad = torch.zeros((512, D), device=devs[0])
    q_pad[:B] = torch.from_numpy(deep["qd"]).to(devs[0])
    st = nsd.device_state()

    def search():
        return sm.sharded_knn(q_pad, st.shards, k=16, metric="cosine", n_live=B)

    a, kw = _capture("_window_mins_t", search)
    got = fused_knn_t._window_mins_t(*a, **kw)
    want_ = fused_knn_t._window_mins_t_plain(*a, **{**kw, "zero_cache": {}})
    budget = _budget(a, kw)
    worst["sweep"] = 0.0
    for g, w, bd in ((got[0], want_[0], budget), (got[1], want_[1], budget.amax(-1))):
        if g is not None:
            worst["sweep"] = max(worst["sweep"],
                                 _check_budget(g, w, bd, "shard B1 cosine k=16")[0])
    del got, want_
    times.update(_time_b1("sweep_shard", a, kw))
    bounds["sweep_shard"] = _b3_bound(a, kw, fused_knn_t._window_mins_t(*a, **kw))
    bounds["sweep_shard_full_batch"] = _b3_bound(a, kw, fused_knn_t._window_mins_t(*a, **kw),
                                                 full_batch=True)
    ga, gkw = _capture("_gather_score", search)
    t, b, rows, worst["gather"] = time_gather("gather_shard", ga, gkw)
    times.update(t)
    bounds.update(b)
    times["merge_host"], times["merge"], n_merge = _merge_span(qpd, deep["qd"], "deep",
                                                               "cosine", K)
    # phase 12 timed the same queries on its processor: no answer may come from a cache
    for p_ in (qpd, deep["qp"]):
        p_._result_cache.clear()
    wall = _engine_wall(qpd, deep["qd"], namespace="deep", metric="cosine")
    wall12 = _engine_wall(deep["qp"], deep["qd"], namespace="deep", metric="cosine")
    times["engine_wall_sharded_median"] = statistics.median(wall)
    times["engine_wall_unsharded_median"] = statistics.median(wall12)
    rec["deep"].update({"shard_rows": a[2].shape[0], "engine_wall_ms": wall,
                        "engine_wall_unsharded_ms": wall12, "timed_gather_rows": rows})
    print(f"  per shard ({a[2].shape[0]:,} rows, r1={kw['r1']}): B1 {times['sweep_shard']:.4f} "
          f"ms (plain {times['sweep_shard_plain']:.4f}, bound "
          f"{bounds['sweep_shard'][0]:.4f} {bounds['sweep_shard'][1]}), B2 "
          f"{times['gather_shard']:.4f} ms; the merge of 4 [{B}, 16] lists in one engine "
          f"search: {n_merge} kernels, device "
          f"{'not measured' if times['merge'] is None else format(times['merge'], '.4f')} ms, "
          f"host {times['merge_host']:.4f} ms; max |kernel - plain| B1 {worst['sweep']}, B2 "
          f"{worst['gather']}")
    print(f"  engine wall (ms, host clock), B={B} cosine k={K}, tombstoned: sharded {wall} "
          f"({n_a:,} rows, median {times['engine_wall_sharded_median']:.3f}), phase 12's "
          f"unsharded {wall12} ({N_DEEP:,} rows, median "
          f"{times['engine_wall_unsharded_median']:.3f}), on {gpu}")
    del qpd, nsd, st, a, kw, ga, gkw
    torch.cuda.empty_cache()

    # ---- (b) the SIFT-1M shape on a (2, 2) mesh: row-major (B5) and the bf16 mirror
    dead, oracle, db_np = sift["dead"], sift["oracle"], sift["db"]
    # B = 384 fills both replicas' halves of the 512 bucket: the 128 queries thrice
    q_np = np.tile(sift["q"], (3, 1))
    counts_b = {}
    rec["replicated"] = {}
    for label, cfg, base, base_ids in (("row_major", EngineConfig(), sift["row_qp"],
                                        sift["row_ids"]),
                                       ("bf16_mirror", SWEEP, sift["sweep_qp"],
                                        sift["sweep_ids"])):
        rowmajor = cfg.sweep_dtype is None
        qpr = make_distributed_processor(2, 2, cfg, devices=devs)
        t0 = time.perf_counter()
        qpr.bulk_load(db_np, "sift", ids=base_ids)
        torch.cuda.synchronize()
        ns = qpr.storage.namespace("sift")
        r_rec = {"ingest_s": time.perf_counter() - t0, "shard_capacity": ns.shard_capacity,
                 "device_bytes": ns.nbytes}
        want = {nq: base.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], K, "sift",
                                            "l2") for nq in (B, 3 * B)}
        outer_b = _mesh_counts()
        _set_mesh_counts([0] * len(outer_b))
        served = {}
        proofs = []
        real_proven = fused_knn._Proof.proven

        def counted(self, kth, thresh):
            proofs.append(kth.shape[0])
            return real_proven(self, kth, thresh)

        for when, dead_rows in (("before delete", None), ("after delete", dead)):
            if dead_rows is not None:
                qpr.delete([base_ids[i] for i in dead_rows], "sift")
            for nq in (B, 3 * B):
                tag = f"(2, 2) {label} l2 B={nq} k={K} {when}"
                n_proofs = len(proofs)
                fused_knn._Proof.proven = counted
                try:
                    res, xfer, launched = _mesh_search(qpr, "sift", q_np, "l2", nq, K)
                finally:
                    fused_knn._Proof.proven = real_proven
                _mesh_checks(res, xfer, launched, 2, _live_replicas(nq, 2), rowmajor, tag)
                # row-major: every shard's B5 search proved its queries once, and (1, 1)
                # copies (``_mesh_checks``) mean no shard escalated: tier 0 (ROADMAP C20)
                if rowmajor and len(proofs) - n_proofs != launched["masked"]:
                    raise AssertionError(f"{tag}: {len(proofs) - n_proofs} proofs for "
                                         f"{launched['masked']} B5 searches")
                served[f"B={nq} {when}"] = {"transfers": xfer, "launches": launched}
                _check_recall(res, (oracle.sets("l2", B, dead_rows) * 3)[:nq], base_ids, tag)
                if dead_rows is not None:
                    _same_as(res, want[nq], tag)
        counts_b[label] = dict(zip(_MESH_NAMES, _mesh_counts()))
        _set_mesh_counts([o + c for o, c in zip(outer_b, counts_b[label].values())])
        r_rec.update({"searches": served, "launches": counts_b[label], "proofs": len(proofs)})
        print(f"  (b) {label} on (2, 2): shard capacity {ns.shard_capacity:,}, device bytes "
              f"{ns.nbytes:,} (both replicas); per batch {served}; recall 1.0 and the "
              f"unsharded answers")
        if rowmajor:
            # B5 at a shard's operands of the engine's B=128 search
            q_pad = torch.zeros((512, D), device=devs[0])
            q_pad[:B] = torch.from_numpy(q_np[:B]).to(devs[0])
            st = ns.device_state()
            a, kw = _capture("_window_mins_masked", lambda: qpr.sharding_manager.sharded_knn(
                q_pad, st.shards, k=16, metric="l2", n_live=B), module=fused_knn)
            n_c = fused_knn_t._live_columns(a[1].shape[1], kw["n_live"])
            plain_args = (a[0], a[1][:, :n_c], a[2][:, :n_c], a[3])
            got = fused_knn._window_mins_masked(*a, **kw)
            want5 = fused_knn._window_mins_masked_ref(*plain_args, **_full(kw))
            budget = fused_knn._phase1_budget(*plain_args[:3], bias=a[3], **_full(kw))
            worst["masked"] = _check_budget(got, want5, budget, "shard B5 l2")[0]
            t, _cols = _time_b4("masked_shard", "_window_mins_masked", a, kw)
            times.update(t)
            bounds["masked_shard"] = _b4_bound(a, kw)
            bounds["masked_shard_full_batch"] = _b4_bound(a, kw, full_batch=True)
            del got, want5, budget
            print(f"  B5 per shard ({a[0].shape[0]:,} f32 rows): {times['masked_shard']:.4f} ms "
                  f"(plain {times['masked_shard_plain']:.4f}, bound "
                  f"{bounds['masked_shard'][0]:.4f}); max |kernel - plain| {worst['masked']}")
            # reconcile, a corrupted row, repair, then the cluster-sharded IVF
            rm = qpr.replication_manager
            after = res
            st = ns.device_state()
            rep0 = rm.reconcile(st.data, st.valid)
            slot = ns._id_to_slot[base_ids[int(np.setdiff1d(np.arange(N), dead)[0])]]
            sh, loc = divmod(slot, ns.shard_capacity)
            cell = ns._cells[1][sh]
            cell.data = cell.data.clone()
            cell.data[loc, 0] += 1.0
            ns._publish()
            st = ns.device_state()
            rep1 = rm.reconcile(st.data, st.valid)
            t0 = time.perf_counter()
            rep2 = ns.reconcile_and_repair(rm)
            repair_s = time.perf_counter() - t0
            res, _x, _l = _mesh_search(qpr, "sift", q_np, "l2", 3 * B, K)
            if (not rep0["consistent"] or rep1["divergent_replicas"] != [1]
                    or not rep2["repaired"] or rep2["source"] != 0
                    or not rep2["consistent_after"]):
                raise AssertionError(f"reconcile/repair: {rep0} {rep1} {rep2}")
            _same_as(res, after, "(2, 2) after the repair")
            t0 = time.perf_counter()
            stats = qpr.build_ivf("sift", n_clusters=2048)
            build_s = time.perf_counter() - t0
            if not stats["sharded"] or stats["shards"] != 2 or stats["clusters"] != 2048:
                raise AssertionError(f"the IVF index is not cluster-sharded: {stats}")
            t0 = time.perf_counter()
            res, _x, _l = _mesh_search(qpr, "sift", q_np, "l2", B, K, nprobe=2048)
            probe_s = time.perf_counter() - t0
            _check_recall(res, oracle.sets("l2", B, dead), base_ids,
                          "(2, 2) IVF full probe l2 B=128")
            r_rec.update({"reconcile": rep0["fingerprints"], "divergent": rep1[
                "divergent_replicas"], "repair_s": repair_s, "ivf_build_s": build_s,
                "ivf_full_probe_s": probe_s, "ivf": stats})
            print(f"  reconcile consistent {rep0['fingerprints']}; one row of replica 1 "
                  f"corrupted: divergent {rep1['divergent_replicas']}; repaired from replica "
                  f"{rep2['source']} in {repair_s:.3f} s, consistent after, answers restored; "
                  f"IVF C=2048 cluster-sharded over 2 shards built in {build_s:.1f} s, full "
                  f"probe B={B} recall@10 1.0 in {probe_s:.2f} s")
        rec["replicated"][label] = r_rec
        del qpr, ns
        torch.cuda.empty_cache()
    _set_mesh_counts([o + sum(c) for o, c in zip(outer, zip(
        counts_a.values(), *(cb.values() for cb in counts_b.values())))])
    return rec, counts_a, counts_b, times, bounds, worst


# ---- phase 20: a bf16 store with an int8 or f32 mirror -----------------------------------

BF16_MIRRORS = (("int8", EngineConfig(dtype="bfloat16", sweep_dtype="int8")),
                ("f32", EngineConfig(dtype="bfloat16", sweep_dtype="float32")))


def _near_tie_rows():
    """ROADMAP C17's construction (tests/test_torch_bf16_mirrors.py, l2): 8,192 rows of
    128, row 100 written half an ulp minus a little off 1.5 (its bf16 row is 1.5, the
    all-ones query's nearest; its written value ranks 0.49 worse), 40 decoys one per
    window between the two, the rest far.  Returns (rows, query, the exact top 10 over the
    stored rows)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8192, D)) + 8).astype(np.float32)
    x[100] = np.float32(1.5) + np.float32(2.0 ** -8 - 2.0 ** -14)
    for i, r in enumerate(range(1000, 1000 + 40 * 64, 64)):
        x[r] = 1.5
        x[r, i % D] = np.float32(1.5 + (7 + i if i < 16 else 30) / 128)
    q = np.ones((1, D), np.float32)
    b = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    return x, q, set(np.argsort(((b - 1.0) ** 2).sum(1), kind="stable")[:K].tolist())


# the tier of C17's near tie (l2) that tests/test_torch_bf16_mirrors.py pins for the port
# and its JAX twin: the one-stream int8 band fails the proof, the others certify
NEAR_TIE_TIERS = {"int8": {"fast": 1}, "int8_one_stream": {"exact_scan": 1},
                  "f32": {"fast": 1}}


def check_near_tie():
    """Phase 20: C17's construction for each mirror (int8 with one and two streams, f32)
    on the card and on the CPU: the exact set over the stored rows, row 100 first, at the
    tier the CPU tests pin.  Returns {mirror: tier}."""
    x, q, want = _near_tie_rows()
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    tiers = {}
    for name, cfg in (("int8", dict(sweep_dtype="int8")),
                      ("int8_one_stream", dict(sweep_dtype="int8", sweep_resid=False)),
                      ("f32", dict(sweep_dtype="float32"))):
        seen = []
        for device in ("cpu", "cuda"):
            qp = QueryProcessor(EngineConfig(dtype="bfloat16", **cfg), device=device)
            qp.bulk_load(x, "tie", ids=ids)
            res = qp.find_similar_batch([VectorDTO(q[0])], K, "tie", "l2")[0]
            seen.append(({r["id"].int - 1 for r in res}, res[0]["id"].int - 1,
                         qp.cert_tier_counts("tie")))
        if (seen[0] != seen[1] or seen[1][0] != want or seen[1][1] != 100
                or seen[1][2] != NEAR_TIE_TIERS[name]):
            raise AssertionError(f"C17 {name}: CPU {seen[0]}, card {seen[1]}, exact {want}, "
                                 f"pinned tier {NEAR_TIE_TIERS[name]}")
        tiers[name] = seen[1][2]
    print(f"  C17 near tie (l2): the exact set over the stored rows, row 100 first, on the "
          f"card at the CPU's tier, the tier the CPU tests pin: {tiers}")
    return tiers


def _check_b3(a, kw, label):
    """B1/B3 at the engine's operands against its plain version on the same call (the
    phase-1 budget; block mins too; a pool the plain pool of the kernel's own window mins,
    which are within the budget), and its launch of the live columns (``kw["n_live"]``)
    bit-equal to the full one.  Returns max |err|."""
    got = fused_knn_t._window_mins_t(*a, **kw)
    want = fused_knn_t._window_mins_t_plain(*a, **{**kw, "zero_cache": {}})
    torch.cuda.synchronize()
    budget = _budget(a, kw)
    worst = 0.0
    for g, w, bd in ((got[0], want[0], budget), (got[1], want[1], budget.amax(-1))):
        if g is not None:
            worst = max(worst, _check_budget(g, w, bd, label)[0])
    if got[2] is not None:
        own = fused_knn_t._window_mins_t(*a, **{**kw, "emit_topm": 0, "skip_wm": False})[0]
        if not _bits_equal(got[2], fused_knn_t._topm_pool_ref(own, kw["emit_topm"])):
            raise AssertionError(f"{label}: the pool is not the plain pool of its own mins")
        plain = fused_knn_t._window_mins_t_plain(
            *a, **{**kw, "zero_cache": {}, "emit_topm": 0, "skip_wm": False})[0]
        worst = max(worst, _check_budget(own, plain, budget, label)[0])
    n_live = kw["n_live"]
    cols = _check_live_tiles(a, kw, n_live, label)
    print(f"  {label}: {a[2].dtype} mirror over {a[2].shape[0]:,} rows, r1={kw['r1']}, qres "
          f"{a[1] is not None}, second stream {a[3] is not None}, bound rows "
          f"{len(kw['eb_rows'])}: max |kernel - plain| {worst} (within the budget); {cols} of "
          f"{a[0].shape[0]} columns computed, every column bit-equal to the full launch")
    if cols != fused_knn_t._live_columns(a[0].shape[0], n_live):
        raise AssertionError(f"{label}: {cols} columns computed")
    return worst


def _check_rows_derived(st, label, when, compacted=False):
    """ROADMAP C17 on the card: the store's mirror is the stored rows' codes (int8, two
    streams) or widening (f32), bit for bit, and its norms the rows' f32 sums (within
    sqrt(Dp) ulps of the float64 sums; equal to them after a compaction)."""
    if label == "int8":
        z1, s1, z2, s2, e2, e1 = fused_knn_t.quantize_int8_resid_rows(st.data)
        same = all(torch.equal(a, b) for a, b in (
            (st.mirror, z1), (st.sweep_rscale, s1), (st.sweep_resid, z2),
            (st.sweep_rscale2, s2), (st.sweep_err, e2), (st.sweep_err1, e1)))
        del z1, z2
    else:
        same = torch.equal(st.mirror, st.data.float())
    rebuild = fused_knn_t.row_sq_norms(st.data)
    gap = float(((st.sq_norms - rebuild).abs() / rebuild.clamp_min(1e-30)).max())
    kind = "codes" if label == "int8" else "widening"
    print(f"  {label} {when}: mirror == the stored rows' {kind} {same}; max "
          f"|sq_norms - float64 norms| / norm {gap:.3e} (sqrt(Dp) ulps "
          f"{D ** 0.5 * 2.0 ** -23:.3e})")
    if not same or gap > D ** 0.5 * 2.0 ** -23 or (compacted and gap != 0.0):
        raise AssertionError(f"{label} {when}: the store's arrays are not its rows'")


def run_bf16_mirrors(db_np, q_np, dead, gpu):
    """Phase 20 (see the module docstring).  Returns (launch counts per mirror, {kernel:
    max |err|}, {time name: ms}, {bound name: bound}, the phase's record)."""
    dev = torch.device("cuda")
    rows = torch.from_numpy(db_np).to(dev).to(torch.bfloat16)
    oracle = DeviceOracle(rows, q_np)
    q_pad = torch.zeros((512, D), device=dev)
    q_pad[:B] = torch.from_numpy(q_np).to(dev)
    counts, worst, times, bounds, rec = {}, {}, {}, {}, {"card": gpu}
    for label, cfg in BF16_MIRRORS:
        qp = QueryProcessor(cfg, device=dev)
        t0 = time.perf_counter()
        ids = qp.bulk_load(db_np, "sift")
        torch.cuda.synchronize()
        ns = qp.storage.namespace("sift")
        st = ns.device_state()
        cap = ns.capacity
        per_row = 16 if label == "int8" else 0           # s1, s2, err, err1 (f32 each)
        mirror_bytes = cap * D * (2 if label == "int8" else 4)
        want_bytes = cap * (D * 2 + 5) + mirror_bytes + cap * per_row
        plan = plan_capacity(N, D, cfg)
        rec[label] = {"ingest_s": time.perf_counter() - t0, "capacity": cap,
                      "device_bytes": ns.nbytes, "rows_bytes": cap * D * 2,
                      "mirror_bytes": mirror_bytes, "plan_data_bytes": plan.data_bytes}
        print(f"  {label}: bulk_load {len(ids)} rows in {rec[label]['ingest_s']:.2f} s, "
              f"capacity {cap}, device bytes {ns.nbytes:,} (rows {cap * D * 2:,}, mirror "
              f"{st.mirror.dtype} {mirror_bytes:,}, a tensor of its own: "
              f"{st.mirror is not st.data}; plan_capacity rows + mirror {plan.data_bytes:,})")
        if (st.data.dtype != torch.bfloat16 or st.mirror is st.data
                or st.mirror.dtype != (torch.int8 if label == "int8" else torch.float32)
                or ns.nbytes != want_bytes
                or ns.nbytes != plan.data_bytes + cap * (5 + per_row)
                or not torch.equal(st.data[:N].view(torch.int16), rows.view(torch.int16))):
            raise AssertionError(f"{label}: the bf16 store or its mirror is not as planned")
        _check_rows_derived(st, label, "after the bulk load (write upkeep)")
        outer = _sweep_counts()
        _set_sweep_counts([0] * len(outer))
        served, dead_ids = {}, set()
        for when, dead_rows in (("before delete", None), ("after delete", dead)):
            if dead_rows is not None:
                dead_ids = _deleted(qp, "sift", ids, dead_rows)
            for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
                for k in (K, K100):
                    res, tier, xfer = _served(qp, "sift", q_np, metric, nq, k)
                    served[f"{metric} B={nq} k={k} {when}"] = (tier, xfer)
                    if (xfer[0] != 1 or len(tier) != 1 or tier[0].startswith("light_")
                            or (tier == ["fast"] and xfer != (1, 1))):
                        raise AssertionError(f"{label} {metric} k={k} {when}: {tier} {xfer}")
                    if any(r["id"] in dead_ids for rs in res for r in rs):
                        raise AssertionError(f"{label} {metric}: a deleted id was returned")
                    _check_recall(res, oracle.sets(metric, nq, dead_rows, k=k), ids,
                                  f"bf16 store, {label} mirror, {metric} B={nq} {when} "
                                  f"(bf16-row oracle)", k=k)
        c = dict(zip(_COUNT_NAMES, _sweep_counts()))
        _set_sweep_counts([o + v for o, v in zip(outer, c.values())])
        counts[label] = c
        print(f"  {label}: (tier, transfers) per batch {served}")
        print(f"  {label}: launches {c} (query columns computed {c['cols']}, the live "
              f"2 x 2 x ({B} + 16 + 16) of the buckets' 2 x 2 x (512 + 64 + 64))")
        own = c["int8"] if label == "int8" else c["f32"]
        if (own != 12 or c["sweep"] != 12 or c["sweep_heavy"] != (12 if label == "int8" else 0)
                or c["gather"] < 12 or c["gather_bf16"] != c["gather"]
                or c["cols"] != 4 * (B + 32)):
            raise AssertionError(f"{label}: B3 over the {label} mirror and B2 over the bf16 rows "
                                 f"did not serve every search on its live columns: {c}")
        rec[label]["searches"] = served
        rec[label]["launches"] = c

        # B3 and B2 at the operands of the engine's l2 B=128 k=10 search (bucket 512, k
        # bucket 16), on the tombstoned namespace, before its compaction
        st = ns.device_state()

        def search(n_live=B, defer=False):
            return fused_knn_t.exact_knn_t(
                q_pad, st.mirror, st.data, st.valid, st.sq_norms, k=16, metric="l2",
                live_prefix=None, sweep_err=st.sweep_err, resid=st.sweep_resid,
                rscale=st.sweep_rscale, err1=st.sweep_err1, rscale2=st.sweep_rscale2,
                prep_cache=st.prep_cache, report_tier=True, n_live=n_live, defer=defer)

        name = f"b3_{label}_bf16_store"
        a, kw = _capture("_window_mins_t", search)
        worst[name] = _check_b3(a, kw, f"B3 {label} over a bf16 store")
        times.update(_time_b1(name, a, kw))
        outs = fused_knn_t._window_mins_t(*a, **kw)
        bounds[name] = _b3_bound(a, kw, outs)
        bounds[name + "_full_batch"] = _b3_bound(a, kw, outs, full_batch=True)
        del outs
        if label == "f32":
            t16, o16 = time_b3_f32(st, q_np, name)
            times.update(t16)
            route = print_f32_route(times, {name: (a, kw), **o16}, (name, *o16), own,
                                    "phase 20")
            bounds.update({key: bound for key, (bound, _) in route.items()})
            rec[label]["bound_fma_ms"] = {key: fma for key, (_, fma) in route.items()}
        ga, gkw = _capture("_gather_score", search)
        if ga[1].dtype != torch.bfloat16:
            raise AssertionError(f"{label}: the rescan did not read the bf16 rows")
        t, b, _, worst[f"gather_{label}_bf16_store"] = time_gather(
            f"gather_{label}_bf16_store", ga, gkw)
        times.update(t)
        bounds.update(b)
        times[f"exact_knn_t_{label}_bf16_store"] = _time_ms(search)
        # the query-independent prep a snapshot's first search pays: JAX's plan over the
        # stored rows (an earlier version measured its bound rows against the rows and
        # summed their norms a snapshot: 7.009 ms int8, 4.200 ms f32 on an NVIDIA H100
        # 80GB HBM3 at 700.00 W, PERF.md)
        times[f"prep_first_search_{label}"] = _time_ms(lambda: fused_knn_t.search_prep(
            st.mirror, st.valid, st.sq_norms, metric="l2", live_prefix=None,
            sweep_err=st.sweep_err, resid=st.sweep_resid, rscale=st.sweep_rscale,
            err1=st.sweep_err1, rscale2=st.sweep_rscale2, rescan_dtype=st.data.dtype))
        print(f"  {label}: prep of a snapshot's first l2 search "
              f"{times[f'prep_first_search_{label}']:.4f} ms on {gpu} (with C13's bound "
              f"rows and rank norms it was 7.009 ms int8 / 4.200 ms f32, PERF.md)")
        _check_result_live(lambda n: search(n, defer=True), f"bf16 store, {label} mirror, l2")
        times[f"engine_wall_{label}_bf16_store_median"] = statistics.median(
            _engine_wall(qp, q_np))
        # a compaction rebuilds the mirror from the stored rows; one l2 batch on it
        ns.compact()
        st = ns.device_state()
        _check_rows_derived(st, label, "after compact()", compacted=True)
        c0 = _sweep_counts()
        res, tier, xfer = _served(qp, "sift", q_np, "l2", B, K)
        moved = dict(zip(_COUNT_NAMES, (v - o for v, o in zip(_sweep_counts(), c0))))
        print(f"  {label}: after compact() (capacity {ns.capacity}, the mirror the rows' "
              f"{'codes' if label == 'int8' else 'widening'}): l2 B={B} k={K} tier {tier}, "
              f"transfers {xfer}, launches {label} {moved[label]}, B2 over bf16 "
              f"{moved['gather_bf16']}")
        _check_recall(res, oracle.sets("l2", B, dead), ids,
                      f"bf16 store, {label} mirror, l2 B={B} after compaction")
        if moved[label] != 1 or moved["gather_bf16"] < 1 or xfer[0] != 1:
            raise AssertionError(f"{label}: the rebuilt mirror did not serve: {moved}")
        rec[label]["compacted"] = {"tier": tier, "transfers": xfer}

    # one int8 stream (sweep_resid=False): one l2 batch
    qp1 = QueryProcessor(EngineConfig(dtype="bfloat16", sweep_dtype="int8", sweep_resid=False),
                         device=dev)
    ids1 = qp1.bulk_load(db_np, "sift")
    c0 = _sweep_counts()
    res, tier, xfer = _served(qp1, "sift", q_np, "l2", B, K)
    moved = dict(zip(_COUNT_NAMES, (v - o for v, o in zip(_sweep_counts(), c0))))
    print(f"  int8, one stream: l2 B={B} k={K} tier {tier}, transfers {xfer}, launches "
          f"int8 {moved['int8']} (heavy {moved['sweep_heavy']}), B2 over bf16 "
          f"{moved['gather_bf16']}")
    _check_recall(res, oracle.sets("l2", B), ids1, "bf16 store, one int8 stream, l2 B=128")
    if moved["int8"] != 1 or xfer[0] != 1 or moved["gather_bf16"] < 1:
        raise AssertionError(f"the one-stream int8 search did not run B3 and B2: {moved}")
    counts["int8_one_stream"] = moved
    rec["int8_one_stream"] = {"tier": tier, "transfers": xfer}
    del qp1, ids1, res

    rec["near_tie_tiers"] = check_near_tie()
    return counts, worst, times, bounds, rec


# ---- phase 21: wide embeddings through the engine ----------------------------------------

# (a) BASELINE.json config #5's width (MSMARCO / OpenAI 1536-d, bf16): a bf16 store with
# the same-dtype sweep; (b) OpenAI text-embedding-3-large's width: an f32 store served
# with an int8 mirror (two streams) and with a bf16 mirror; (c) phase 5's clustered
# namespace at that width.  Each cell: (label, config, rows, dimensions, seed, searches)
WIDE_CELLS = (
    ("bf16_store_1536", EngineConfig(dtype="bfloat16", sweep_dtype="bfloat16"), 1 << 20, 1536,
     SEED + 21, (("cosine", B, K), ("ip", 16, K), ("cosine", B, K100))),
    ("int8_3072", EngineConfig(sweep_dtype="int8"), 1 << 19, 3072, SEED + 22,
     (("l2", B, K), ("cosine", 16, K), ("l2", B, K100))),
    ("bf16_mirror_3072", EngineConfig(sweep_dtype="bfloat16"), 1 << 19, 3072, SEED + 22,
     (("l2", B, K), ("cosine", 16, K), ("l2", B, K100))))
N_WIDE_CLUSTERED = 131072


class WideOracle(DeviceOracle):
    """DeviceOracle over wide rows: chunks of 2^27 elements (a GiB of float64)."""

    def __init__(self, rows, q_np):
        super().__init__(rows, q_np)
        self.CHUNK = max(fused_knn_t.SWEEP_TILE, (1 << 27) // rows.shape[1])


def _wide_tier_ok(label, qp, metric, masked, tier, was_light):
    """A wide batch's tier: one tier; on a bf16 store or an int8 mirror never a light_
    one; on a bf16 mirror a light_ tier exactly where the light program served (its
    variant in light mode), and a light batch escalated to the exact scan flips its
    variant to heavy, as the JAX engine does.  Which tier serves is the certificate's: on
    gaussian rows this wide its band may not close at tier 0 (PERF.md §6)."""
    if len(tier) != 1:
        return False
    light = tier[0].startswith("light_")
    if not label.startswith("bf16_mirror"):
        return not light
    flipped = qp._cert_mode.get(("wide", metric, masked)) == "heavy"
    return light == was_light and (tier[0] != "light_exact_scan" or flipped)


def _wide_corpus(seed, n, dim):
    """n x dim gaussian f32 rows and B queries of default_rng(seed), the rows made in 8
    threads (numpy's generators release the GIL), each from its own spawned stream."""
    rng = np.random.default_rng(seed)
    db = np.empty((n, dim), dtype=np.float32)
    step = n // 8

    def fill(i, g):
        g.standard_normal(dtype=np.float32, out=db[i * step:(i + 1) * step])

    threads = [threading.Thread(target=fill, args=(i, g)) for i, g in enumerate(rng.spawn(8))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return rng, db, rng.standard_normal((B, dim), dtype=np.float32)


def _wide_kernels(name, search, times, bounds, worst, routes):
    """B1/B3 at the operands of ``search()`` (the engine's, captured): against plain, timed
    (kernel, plain, every column), its bound, its route and the bf16 torch.matmul yardstick
    of its one-pass product."""
    a, kw = _capture("_window_mins_t", search)
    worst[name] = _check_b3(a, kw, name)
    times.update(_time_b1(name, a, kw))
    outs = fused_knn_t._window_mins_t(*a, **kw)
    bounds[name] = _b3_bound(a, kw, outs)
    bounds[name + "_full_batch"] = _b3_bound(a, kw, outs, full_batch=True)
    del outs
    live = fused_knn_t._live_columns(a[0].shape[0], kw["n_live"])
    m16 = a[2] if a[2].dtype == torch.bfloat16 else a[2].to(torch.bfloat16)
    times[name + "_matmul"] = _time_ms(lambda: torch.matmul(m16, a[0][:live].T))
    del m16
    routes[name] = fused_knn_t.sweep_route(a[2].dtype, a[2].shape[1], kw["n_live"],
                                           a[0].shape[0], two_pass=a[1] is not None,
                                           resid=a[3] is not None)
    ms, bd = times[name], bounds[name]
    print(f"  B1/B3 {name}: {a[2].dtype} mirror {tuple(a[2].shape)}, qres {a[1] is not None}, "
          f"second stream {a[3] is not None}, r1={kw['r1']}, {live} of {a[0].shape[0]} columns, "
          f"route {routes[name]}: {ms:.4f} ms (every column {times[name + '_full']:.4f}, plain "
          f"{times[name + '_plain']:.4f}, bf16 torch.matmul of one pass "
          f"{times[name + '_matmul']:.4f}); bound {bd[0]:.4f} ms ({bd[1]}), share "
          f"{bd[0] / ms:.1%}; max |kernel - plain| {worst[name]} (within the budget)")


def _wide_cell(label, cfg, db, q_np, oracle, dead, searches):
    """One cell of phase 21: bulk_load, the searches before and after the deletes, then
    B1/B3 and B2 at the engine's operands.  Returns (launch counts, record, times, bounds,
    max |err| by kernel, routes)."""
    dev = torch.device("cuda")
    n, dim = db.shape
    qp = QueryProcessor(cfg, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db, "wide")
    torch.cuda.synchronize()
    rec = {"ingest_s": time.perf_counter() - t0}
    ns = qp.storage.namespace("wide")
    st = ns.device_state()
    want = {"bf16_store": (torch.bfloat16, torch.bfloat16), "int8": (torch.float32, torch.int8),
            "bf16_mirror": (torch.float32, torch.bfloat16)}[label.rsplit("_", 1)[0]]
    print(f"  {label}: bulk_load {n:,} x {dim} in {rec['ingest_s']:.2f} s, capacity "
          f"{ns.capacity}, device bytes {ns.nbytes:,}; rows {st.data.dtype}, mirror "
          f"{st.mirror.dtype}")
    if (st.data.dtype, st.mirror.dtype) != want or ns.capacity != n:
        raise AssertionError(f"{label}: the store is not {want} at capacity {n}")
    if st.data.dtype == torch.bfloat16 and not torch.equal(
            st.data.view(torch.int16), oracle.rows.view(torch.int16)):
        raise AssertionError(f"{label}: the store's rows are not the corpus rounded to bf16")
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    served, dead_ids = {}, set()
    # the device memory a search takes beyond the store, at its peak: no path may hold a
    # [batch, candidates, Dp] block (the tier-2 scan works in [batch, 8 tiles] blocks);
    # each search within fused_knn_t.search_bytes_bound (ROADMAP C16)
    peak, peak_bound, over = 0, 0, []
    for when, dead_rows in (("before delete", None), ("after delete", dead)):
        if dead_rows is not None:
            dead_ids = _deleted(qp, "wide", ids, dead_rows)
        for metric, nq, k in searches:
            masked = dead_rows is not None
            was_light = qp._cert_mode.get(("wide", metric, masked), "light") == "light"
            heavy0 = fused_knn_t._window_mins_t.launches_heavy
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res, tier, xfer = _served(qp, "wide", q_np, metric, nq, k)
            took = torch.cuda.max_memory_allocated() - base
            bound = fused_knn_t.search_bytes_bound(ns.capacity, ns.dpad,
                                                   qp.config.bucket_batch(nq),
                                                   qp.config.bucket_k(k))
            if took > bound:
                over.append((metric, nq, k, when, took, bound))
            if took >= peak:
                peak, peak_bound = took, bound
            program = "heavy" if fused_knn_t._window_mins_t.launches_heavy > heavy0 else "one pass"
            served[f"{metric} B={nq} k={k} {when}"] = (tier, xfer, program)
            if (xfer[0] != 1 or (tier in (["fast"], ["light_fast"])) != (xfer == (1, 1))
                    or not _wide_tier_ok(label, qp, metric, masked, tier, was_light)):
                raise AssertionError(f"{label} {metric} k={k} {when}: {tier} {xfer}")
            if any(r["id"] in dead_ids for rs in res for r in rs):
                raise AssertionError(f"{label} {metric}: a deleted id was returned")
            _check_recall(res, oracle.sets(metric, nq, dead_rows, k=k), ids,
                          f"{label} {metric} B={nq} k={k} {when}", k=k)
    c = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts([o + v for o, v in zip(outer, c.values())])
    rec.update(searches=served, launches=c, modes={str(k_): v for k_, v in qp._cert_mode.items()},
               search_peak_bytes=peak, search_peak_bound_bytes=peak_bound)
    print(f"  {label}: (tier, transfers, program) per batch {served}; device memory a "
          f"search took beyond the store at its peak {rec['search_peak_bytes']:,} B, its "
          f"bound {peak_bound:,} B (a [512, 2560, {dim}] f32 block alone would be "
          f"{512 * 2560 * dim * 4:,})")
    if over:
        raise AssertionError(f"{label}: searches beyond fused_knn_t.search_bytes_bound "
                             f"(metric, B, k, when, bytes, bound): {over}")
    print(f"  {label}: launches {c}; modes {qp._cert_mode}")
    if (c["sweep"] != 2 * len(searches) or c["gather"] < 2 * len(searches)
            or c["cols"] != 2 * sum(nq for _, nq, _ in searches)
            or (label.startswith("int8") and c["int8"] != c["sweep"])):
        raise AssertionError(f"{label}: B1/B3 and B2 did not serve every search on its live "
                             f"columns: {c}")

    # the kernels at the operands of the engine's searches on the tombstoned snapshot
    st = ns.device_state()

    def search(metric, nq, k, light=None, n_live=None, defer=False):
        q_pad = torch.zeros((qp.config.bucket_batch(nq), dim), device=dev)
        q_pad[:nq] = torch.from_numpy(q_np[:nq]).to(dev)
        return fused_knn_t.exact_knn_t(
            q_pad, st.mirror, st.data, st.valid, st.sq_norms, k=k, metric=metric,
            live_prefix=None, sweep_err=st.sweep_err, resid=st.sweep_resid,
            rscale=st.sweep_rscale, err1=st.sweep_err1, rscale2=st.sweep_rscale2,
            prep_cache=st.prep_cache, report_tier=True, light=bool(light),
            n_live=nq if n_live is None else n_live, defer=defer)

    times, bounds, worst, routes = {}, {}, {}, {}
    lights = (True, False) if label.startswith("bf16_mirror") else (False,)
    for metric, nq, k in searches:
        for light in lights:
            name = f"wide_{label}_{metric}_b{nq}_k{k}" + ("_light" if light else "")
            _wide_kernels(name, lambda: search(metric, nq, 16 if k == K else 128, light),
                          times, bounds, worst, routes)
    metric0 = searches[0][0]
    for kb in (16, 128):
        gname = f"wide_gather_{label}_k{kb}"
        ga, gkw = _capture("_gather_score", lambda: search(metric0, B, kb))
        t, b, _, worst[gname] = time_gather(gname, ga, gkw)
        times.update(t)
        bounds.update(b)
        times[f"exact_knn_t_{label}_k{kb}"] = _time_ms(lambda: search(metric0, B, kb))
        _check_result_live(lambda n_: search(metric0, B, kb, n_live=n_, defer=True),
                           f"{label} {metric0} k bucket {kb}")
    wall = _engine_wall(qp, q_np, namespace="wide", metric=metric0)
    rec["engine_wall_ms"] = wall
    rec["engine_split_ms"] = _engine_split(qp, q_np, namespace="wide", metric=metric0)
    times[f"engine_wall_{label}_median"] = statistics.median(wall)
    print(f"  {label}: exact_knn_t {metric0} B={B} k bucket 16 / 128 "
          f"{times[f'exact_knn_t_{label}_k16']:.4f} / {times[f'exact_knn_t_{label}_k128']:.4f} "
          f"ms; engine wall runs (ms) {wall}; split (median ms, host clock) "
          f"{rec['engine_split_ms']}")
    return c, rec, times, bounds, worst, routes


def run_wide(gpu):
    """Phase 21 (see the module docstring).  Returns (launch counts by cell, {kernel: max
    |err|}, {time name: ms}, {bound name: bound}, {kernel: route}, the phase's record)."""
    dev = torch.device("cuda")
    counts, worst, times, bounds, routes, rec = {}, {}, {}, {}, {}, {"card": gpu}
    corpus = {}
    for label, cfg, n, dim, seed, searches in WIDE_CELLS:
        t0 = time.perf_counter()
        if seed not in corpus:
            corpus.clear()
            torch.cuda.empty_cache()
            rng, db, q_np = _wide_corpus(seed, n, dim)
            rows = torch.from_numpy(db).to(dev)
            if cfg.dtype == "bfloat16":
                rows = rows.to(torch.bfloat16)
            oracle = WideOracle(rows, q_np)
            near = sorted({next(iter(s)) for s in oracle.sets(searches[0][0], B, k=1)})
            others = rng.choice(np.setdiff1d(np.arange(n), near), 1000 - len(near),
                                replace=False)
            dead = np.asarray(sorted(near + others.tolist()))
            corpus[seed] = (db, q_np, oracle, dead)
        db, q_np, oracle, dead = corpus[seed]
        print(f"  {label}: corpus {n:,} x {dim} gaussian f32 of default_rng({seed}) and its "
              f"oracle in {time.perf_counter() - t0:.1f} s")
        c, r, t, b, w, ro = _wide_cell(label, cfg, db, q_np, oracle, dead, searches)
        counts[label], rec[label] = c, r
        times.update(t)
        bounds.update(b)
        worst.update(w)
        routes.update(ro)
        torch.cuda.empty_cache()
    corpus.clear()
    torch.cuda.empty_cache()

    # (c) phase 5's clustered namespace at Dp = 3072: the light program escalates and
    # flips, the heavy program serves the next batch
    dim = 3072
    rng = np.random.default_rng(SEED + 23)
    centres = rng.standard_normal((8, dim)).astype(np.float32) * 0.05
    xc = (centres[rng.integers(0, 8, N_WIDE_CLUSTERED)]
          + rng.standard_normal((N_WIDE_CLUSTERED, dim)).astype(np.float32) * 1e-3
          ).astype(np.float32)
    qc = (centres[rng.integers(0, 8, 2 * B)]
          + rng.standard_normal((2 * B, dim)).astype(np.float32) * 1e-3).astype(np.float32)
    xc64 = xc.astype(np.float64)
    qp = QueryProcessor(SWEEP, device=dev)
    qp.bulk_load(xc, "clustered")
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    served = {}
    for i, when in enumerate(("first batch (light)", "second batch (after the flip)")):
        qb = qc[i * B:(i + 1) * B]
        heavy0 = fused_knn_t._window_mins_t.launches_heavy
        res, tier, xfer = _served(qp, "clustered", qb, "l2", B, K)
        heavy = fused_knn_t._window_mins_t.launches_heavy - heavy0
        served[when] = (tier, xfer, heavy)
        print(f"  clustered {N_WIDE_CLUSTERED:,} x {dim} {when}: tier {tier}, transfers {xfer}, "
              f"heavy launches {heavy}, mode {qp._cert_mode.get(('clustered', 'l2', False))}")
        _check_kdists(res, xc64, qb, f"clustered x {dim} {when}")
        if i == 0 and (tier != ["light_exact_scan"]
                       or qp._cert_mode.get(("clustered", "l2", False)) != "heavy"):
            raise AssertionError("the light program did not escalate and flip to heavy")
        if i == 1 and (heavy != 1 or any(t.startswith("light_") for t in tier)):
            raise AssertionError("the second clustered batch did not run the heavy program")
    c = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts([o + v for o, v in zip(outer, c.values())])
    counts["clustered_3072"] = c
    rec["clustered_3072"] = {"searches": served, "launches": c}
    st = qp.storage.namespace("clustered").device_state()
    q_pad = torch.zeros((512, dim), device=dev)
    q_pad[:B] = torch.from_numpy(qc[B:]).to(dev)
    _wide_kernels("wide_clustered_3072_heavy", lambda: fused_knn_t.exact_knn_t(
        q_pad, st.mirror, st.data, st.valid, st.sq_norms, k=16, metric="l2",
        live_prefix=st.high_water, sweep_err=st.sweep_err, resid=st.sweep_resid,
        rscale=st.sweep_rscale, err1=st.sweep_err1, rscale2=st.sweep_rscale2,
        prep_cache=st.prep_cache, report_tier=True, n_live=B), times, bounds, worst, routes)
    del qp, st, q_pad, xc, xc64
    torch.cuda.empty_cache()
    rec["routes"] = routes
    return counts, worst, times, bounds, routes, rec


# ---- phase 18: the server over phase 17's processor --------------------------------------


def _server_missing():
    """The first of aiohttp and pydantic that does not import, or None."""
    import importlib

    for name in ("aiohttp", "pydantic"):
        try:
            importlib.import_module(name)
        except ImportError:
            return name
    return None


def run_server(qp, q_np, gpu):
    """Phase 18 (see the module docstring).  Returns its record."""
    import asyncio

    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    from mlvectordb_tpu_torch.api.rest_api import RestAPI

    def direct_ids(res):
        return [[str(r["id"]) for r in rs] for rs in res]

    def http_ids(body):
        return [[r["id"] for r in rs] for rs in body]

    rec = {}

    async def drive():
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        batched = RestAPI(qp, enable_file_logging=False, log_level="WARNING",
                          batch_queries=True)
        timeout = aiohttp.ClientTimeout(total=600)
        client = TestClient(TestServer(api.app), timeout=timeout)
        bclient = TestClient(TestServer(batched.app), timeout=timeout)
        await client.start_server()
        await bclient.start_server()
        try:
            resp = await client.get("/health?deep=1")
            health = await resp.json()
            print(f"  GET /health?deep=1: {resp.status} {health['status']}, device "
                  f"{health['device']}")
            if (resp.status != 200 or health["device"]["platform"] != "gpu"
                    or health["device"]["devices"][0] != torch.cuda.get_device_name(0)):
                raise AssertionError("/health does not report the card")
            row = (q_np[0] * 0.5).tolist()
            resp = await client.post("/vectors?namespace=ivf", json={"values": row})
            vid = (await resp.json())["id"]
            resp2 = await client.delete("/vectors?namespace=ivf", json={"ids": [vid]})
            body2 = await resp2.json()
            print(f"  POST /vectors {resp.status}, DELETE /vectors {resp2.status} "
                  f"{body2['message']}")
            if resp.status != 201 or resp2.status != 200 or body2["ids"] != [vid]:
                raise AssertionError("insert or delete over HTTP failed")

            payload = {"queries": q_np.tolist(), "top_k": K, "metric": "l2"}
            outer = [fn.launches for fn in (fused_knn._window_mins_fast,
                                            fused_knn._window_mins_masked)]
            fused_knn._window_mins_fast.launches = fused_knn._window_mins_masked.launches = 0
            resp = await client.post("/search/batch?namespace=ivf", json=payload)
            body = await resp.json()
            b45 = fused_knn._window_mins_fast.launches + fused_knn._window_mins_masked.launches
            fused_knn._window_mins_fast.launches, fused_knn._window_mins_masked.launches = outer
            want = direct_ids(qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "ivf",
                                                    "l2"))
            print(f"  POST /search/batch B={len(q_np)} k={K}: {resp.status}, ids equal to the "
                  f"direct call {http_ids(body) == want}, B4/B5 launches {b45}")
            if resp.status != 200 or http_ids(body) != want or b45 < 1:
                raise AssertionError("/search/batch differs from the direct call")

            http_ms, direct_ms = [], []
            for i in range(5):
                qi = q_np + np.float32(i + 21) * np.float32(1e-3)
                t0 = time.perf_counter()
                resp = await client.post("/search/batch?namespace=ivf",
                                         json={**payload, "queries": qi.tolist()})
                await resp.json()
                http_ms.append((time.perf_counter() - t0) * 1e3)
                qi = qi + np.float32(5e-4)
                t0 = time.perf_counter()
                qp.find_similar_batch([VectorDTO(v) for v in qi], K, "ivf", "l2")
                direct_ms.append((time.perf_counter() - t0) * 1e3)
            rec["http_batch_ms"] = statistics.median(http_ms)
            rec["direct_batch_ms"] = statistics.median(direct_ms)
            print(f"  round trip of /search/batch (B={len(q_np)}, k={K}, JSON with the rows' "
                  f"values) median of 5 {rec['http_batch_ms']:.3f} ms against the direct "
                  f"call {rec['direct_batch_ms']:.3f} ms")

            t0 = time.perf_counter()
            resp = await client.post("/ivf/build", json={"namespace": "ivf"})
            built = await resp.json()
            rec["ivf_build_s"] = time.perf_counter() - t0
            resp = await client.post("/search/batch?namespace=ivf",
                                     json={**payload, "nprobe": 16})
            body = await resp.json()
            want = direct_ids(qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "ivf",
                                                    "l2", nprobe=16))
            print(f"  POST /ivf/build {built.get('status')} ({built.get('clusters')} clusters, "
                  f"{rec['ivf_build_s']:.2f} s); /search/batch nprobe=16: ids equal to the "
                  f"direct call {http_ids(body) == want}")
            if resp.status != 200 or http_ids(body) != want:
                raise AssertionError("/search/batch with nprobe differs from the direct call")

            singles = q_np[:32]
            resps = await asyncio.gather(*[
                bclient.post("/search?namespace=ivf",
                             json={"query": v.tolist(), "top_k": K, "metric": "l2"})
                for v in singles])
            bodies = [await r.json() for r in resps]
            want = [direct_ids([qp.find_similar(VectorDTO(v), K, "ivf", "l2")])[0]
                    for v in singles]
            stats = batched.micro_batcher.stats()
            ok = http_ids(bodies) == want
            print(f"  --auto-batch: 32 concurrent /search equal to the direct calls {ok}; "
                  f"micro-batcher {stats}")
            if not ok or any(r.status != 200 for r in resps):
                raise AssertionError("auto-batched searches differ from the direct calls")
            rec["auto_batch"] = stats
        finally:
            await client.close()
            await bclient.close()
            batched.micro_batcher.close()

    asyncio.run(drive())

    try:
        import grpc
    except ImportError:
        print("  gRPC: grpc does not import here; skipped")
        rec["grpc"] = "grpc not installed"
        return rec
    from mlvectordb_tpu_torch.api import vectordb_pb2 as pb
    from mlvectordb_tpu_torch.api.grpc_server import create_server, make_stub

    server, port = create_server(qp, port=0)
    server.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            stub = make_stub(channel)
            one = stub.Search(pb.SearchRequest(namespace="ivf", query=q_np[0].tolist(),
                                               top_k=K, metric="l2"))
            many = stub.BatchSearch(pb.BatchSearchRequest(namespace="ivf", requests=[
                pb.SearchRequest(query=v.tolist(), top_k=K, metric="l2") for v in q_np[:8]]))
    finally:
        server.stop(0)
    want = direct_ids(qp.find_similar_batch([VectorDTO(v) for v in q_np[:8]], K, "ivf", "l2"))
    got_one = [h.id for h in one.hits]
    got_many = [[h.id for h in r.hits] for r in many.responses]
    print(f"  gRPC Search and BatchSearch (8): ids equal to the direct call "
          f"{got_one == want[0] and got_many == want}")
    if got_one != want[0] or got_many != want:
        raise AssertionError("gRPC answers differ from the direct call")
    rec["grpc"] = "ok"
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU",
              file=sys.stderr)
        return 2

    # ---- 1. device ------------------------------------------------------------------
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    gpu = _gpu_line()
    _c18_phase("phase 1")
    print(f"phase 1 device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}"
          " | nvidia-smi name, power.limit:")
    print(gpu)
    t0 = time.perf_counter()
    ptxas = _start_ptxas_report()
    # the native host runtime (metadata filter, hydration) builds beside the kernels
    host = {}
    host_build = threading.Thread(target=lambda: host.update(
        metafilter=native.available(), hydrate=native.hydrate_module() is not None,
        seconds=time.perf_counter() - t0))
    host_build.start()
    lib = _kernels.build()
    print(f"  kernels built: {lib.name} in {time.perf_counter() - t0:.1f} s")
    host_build.join()
    print(f"  native host runtime in {native.BUILD_DIR}: metafilter {host['metafilter']}, "
          f"_hydrate {host['hydrate']} ({host['seconds']:.1f} s)")
    if not host["metafilter"]:
        raise AssertionError("native/metafilter.cpp did not build")
    for name, regs, st, ld, smem in _ptxas_report(ptxas):
        print(f"  ptxas: {_short(name)}: {regs} registers, spill stores {st} B, loads {ld} B, "
              f"{smem} B shared")
    mma, kernel_names = _mma_counts(lib)
    print(f"  mma.sync (HMMA) instructions per tensor-core kernel: "
          f"{ {_short(k): v for k, v in mma.items()} }")
    # B3 over an f32 mirror: four instantiations (the 64- and the 16-query tile, each with
    # its query in shared memory and streamed), each at least the six split products of
    # one n-tile (12 HMMA); the FMA body is gone
    f32_mma = [v for k, v in mma.items() if "sweep_mma_kernelIf" in k]
    if (not mma or min(mma.values()) == 0
            or sum("window_mma_kernel" in k for k in mma) != 6
            or len(f32_mma) != 4 or min(f32_mma) < 12
            or any("fma_kernel" in k for k in kernel_names)):
        raise AssertionError(f"a tensor-core kernel holds no mma.sync, B4/B5 lacks one of its "
                             f"six instantiations (2 row types x 3 query tiles), B3's f32 body "
                             f"one of its four, or the FMA body is still built: {mma}")

    check_streamed_tiles(mma)
    print_routes()

    rng = np.random.default_rng(SEED)
    db_np = rng.standard_normal((N, D), dtype=np.float32)
    q_np = rng.standard_normal((B, D), dtype=np.float32)
    db64 = db_np.astype(np.float64)
    oracle = Oracle(db64, q_np)

    # ---- 2. row-major kernels against their plain versions ---------------------------
    _c18_phase("phase 2")
    print("phase 2 row-major kernels vs plain on the card")
    worst, b4_ratio = check_kernels(db_np)
    check_window_min_nan(db_np)
    wide = check_wide_dims()

    # ---- 3. the row-major main path at SIFT-1M shape ---------------------------------
    _c18_phase("phase 3")
    print(f"phase 3 row-major path: QueryProcessor at {N:,} x {D} f32")
    dev = torch.device("cuda")
    for fn in (fused_knn._window_mins_fast, fused_knn._window_mins_masked):
        fn.launches = fn.cols = 0

    qp = QueryProcessor(EngineConfig(), device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db_np, "sift")
    torch.cuda.synchronize()
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, capacity "
          f"{qp.storage.namespace('sift').capacity}")
    mark3 = _row_major_mark(qp, "sift")
    x0 = _xfer_mark(qp)
    res = qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "sift", "l2")
    xfer = _xfer(qp, x0)
    print(f"  transfers per search (h2d, d2h): {xfer}")
    if xfer != (1, 1):
        raise AssertionError(f"transfer rule broken: {xfer}")
    _check_recall(res, oracle.sets("l2", B), ids, "l2 B=128")
    for metric in ("ip", "cosine"):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:16]], K, "sift", metric)
        _check_recall(res, oracle.sets(metric, 16), ids, f"{metric} B=16")
    wall_fast = _engine_wall(qp, q_np)
    split_fast = _engine_split(qp, q_np)
    fast_after_search = fused_knn._window_mins_fast.launches

    # delete 1,000 rows, among them each query's current nearest neighbour (under the
    # 0.2 compaction threshold, so the namespace keeps its tombstones: masked kernel)
    dead = sorted({next(iter(s)) for s in oracle.sets("l2", B, k=1)})
    others = rng.choice(np.setdiff1d(np.arange(N), dead), 1000 - len(dead), replace=False)
    dead = np.asarray(sorted(dead + others.tolist()))
    self_row = int(np.setdiff1d(np.arange(1234, 2234), dead)[0])
    removed = qp.delete([ids[i] for i in dead], "sift")
    ns = qp.storage.namespace("sift")
    print(f"  deleted {len(removed)} ids; tombstones {ns._tombstones}, capacity {ns.capacity}")
    if len(removed) != 1000 or ns.device_state().live_count == ns.device_state().high_water:
        raise AssertionError("delete did not leave tombstones")
    dead_ids = {ids[i] for i in dead}
    for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], K, "sift", metric)
        if any(r["id"] in dead_ids for rs in res for r in rs):
            raise AssertionError(f"{metric}: a deleted id was returned")
        _check_recall(res, oracle.sets(metric, nq, dead), ids, f"{metric} B={nq} after delete")
    self_hit = qp.find_similar(VectorDTO(db_np[self_row]), 1, "sift", "l2")
    print(f"  self query (row {self_row}): score {self_hit[0]['score']}")
    if self_hit[0]["id"] != ids[self_row] or not self_hit[0]["score"] < 1e-3:
        raise AssertionError(f"stored row {self_row} queried as itself returned {self_hit[:1]}")
    row_proof = {"phase 3": _row_major_tier0(qp, "sift", mark3, "phase 3 (ROADMAP C20)")}

    launches = {"fast": fused_knn._window_mins_fast.launches,
                "masked": fused_knn._window_mins_masked.launches}
    row_cols = {"fast": fused_knn._window_mins_fast.cols,
                "masked": fused_knn._window_mins_masked.cols}
    # the live columns of every search: B=128, 16, 16 and the 5 + 5 timed B=128 batches
    # before the deletes (fast), B=128, 16, 16 and the self query (8) after them (masked)
    want_cols = {"fast": 11 * B + 32, "masked": B + 32 + 8}
    print(f"  kernel launches on the row-major path: fast_launches={launches['fast']} "
          f"masked_launches={launches['masked']} (fast before delete: {fast_after_search}); "
          f"query columns computed {row_cols} (the buckets': 11 x 512 + 2 x 64 = 5760 and "
          f"512 + 2 x 64 + 8 = 648)")
    if launches["fast"] < 1 or launches["masked"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if row_cols != want_cols:
        raise AssertionError(f"the row-major path computed {row_cols} query columns, not the "
                             f"live {want_cols}")
    row_proof["near_duplicates_f32"] = check_near_duplicates(qp, db_np, dead, "f32 rows")

    # ---- 4. sweep kernels against their plain versions ---------------------------------
    _c18_phase("phase 4")
    print("phase 4 certified sweep kernels vs plain on the card")
    worst.update(check_sweep_kernels(db_np))
    gather_wide = check_gather_wide()

    # ---- 5. the certified sweep path ----------------------------------------------------
    _c18_phase("phase 5 (and phase 7 before the deletes)")
    print(f"phase 5 certified sweep path: QueryProcessor(sweep_dtype='bfloat16') at {N:,} x {D}")
    fused_knn_t._window_mins_t.launches = 0
    fused_knn_t._window_mins_t.launches_heavy = 0
    fused_knn_t._gather_score.launches = fused_knn_t._gather_score.rows = 0
    k100 = {}

    def before_delete(qp_, ids_):
        print("phase 7 (on the phase-5 namespace, before its deletes) k=100 searches")
        tiers, k100["before"] = run_k100_searches(qp_, ids_, q_np, oracle, None, "before delete")
        return tiers

    qps, sweep_ids = run_sweep_path(db_np, q_np, oracle, dead, self_row, before_delete)
    launches["sweep"] = fused_knn_t._window_mins_t.launches
    launches["sweep_heavy"] = fused_knn_t._window_mins_t.launches_heavy
    launches["gather"] = fused_knn_t._gather_score.launches
    launches["gather_rows"] = fused_knn_t._gather_score.rows
    print(f"  kernel launches on the sweep path: sweep_min={launches['sweep']} (heavy "
          f"{launches['sweep_heavy']}, light {launches['sweep'] - launches['sweep_heavy']}) "
          f"gather_score={launches['gather']}, computing {launches['gather_rows']} candidate "
          f"rows (the live queries' and one padded row's)")
    if (launches["sweep_heavy"] < 1 or launches["sweep"] - launches["sweep_heavy"] < 1
            or launches["gather"] < 1):
        raise AssertionError(f"a kernel of the sweep path never launched: {launches}")

    # ---- 6. times (informative) -------------------------------------------------------
    _c18_phase("phase 6")
    print(f"phase 6 times on {gpu} (CUDA events, mean of 10 after a warm call)")
    state = ns.device_state()
    data = state.data
    rng.standard_normal((512, D), dtype=np.float32)   # (keeps the later phases' draws)
    # B4/B5 at the operands the engine's l2 B=128 search gives them (bucket 512, k bucket
    # 16: r1 = 8, the 128 live columns), on the tombstoned namespace (the fast kernel as if
    # it had none); the plain version on the same columns, the full 512-column launch and
    # the f32 product alone (TF32 off) as a yardstick
    q_pad = torch.zeros((512, D), device=dev)
    q_pad[:B] = torch.from_numpy(q_np).to(dev)
    row_ops, times, b4_cols = {}, {}, {}
    for key, masked in (("fast", False), ("masked", True)):
        name, a, k_ = _capture_b4(data, state.valid, state.sq_norms, q_pad, masked)
        row_ops[key] = (a, k_)
        t, b4_cols[key] = _time_b4(key, name, a, k_)
        times.update(t)
    times["matmul_f32"] = _matmul_ms(data, q_pad[:B])
    # one search at B=128 padded to the 512 bucket, as the engine runs it (k bucket 16)
    times["exact_knn_fused_masked"] = _time_ms(lambda: fused_knn.exact_knn_fused(
        q_pad, data, state.valid, state.sq_norms, k=16, metric="l2", live_prefix=None,
        n_live=B))
    times["exact_knn_fused_fast"] = _time_ms(lambda: fused_knn.exact_knn_fused(
        q_pad, data, state.valid, state.sq_norms, k=16, metric="l2", live_prefix=N,
        n_live=B))
    mark6 = _row_major_mark(qp, "sift")
    wall_masked = _engine_wall(qp, q_np)
    split_masked = _engine_split(qp, q_np)
    row_proof["phase 6"] = _row_major_tier0(qp, "sift", mark6, "phase 6 (ROADMAP C20)")
    times["engine_wall_fast_median"] = statistics.median(wall_fast)
    times["engine_wall_masked_median"] = statistics.median(wall_masked)

    # the sweep kernels at the operands the engine's l2 B=128 search gives them (bucket
    # 512, k bucket 16: r1 = 32, block mins, two bound rows), on the tombstoned namespace
    sst = qps.storage.namespace("sift").device_state()

    def sweep_search(light, n_live=B, defer=False):
        return fused_knn_t.exact_knn_t(
            q_pad, sst.mirror, sst.data, sst.valid, sst.sq_norms, k=16, metric="l2",
            live_prefix=None, sweep_err=sst.sweep_err, resid=sst.sweep_resid,
            rscale=sst.sweep_rscale, err1=sst.sweep_err1, light=light,
            prep_cache=sst.prep_cache, report_tier=True, n_live=n_live, defer=defer)

    operands = {}
    for light in (True, False):
        name = "sweep_light" if light else "sweep_heavy"
        a, k_ = operands[name] = _capture("_window_mins_t", lambda: sweep_search(light))
        times.update(_time_b1(name, a, k_))
        times["exact_knn_t_" + ("light" if light else "heavy")] = _time_ms(
            lambda: sweep_search(light))
    # the bf16 product alone as one library call, at the live shape: an informative
    # yardstick (the port never calls it)
    a, _ = operands["sweep_light"]
    times["matmul_light"] = _time_ms(lambda: torch.matmul(a[2], a[0][:B].T))
    a, k_ = operands["gather_score"] = _capture("_gather_score", lambda: sweep_search(True))
    t, gather_bounds, gather_rows, _ = time_gather("gather_score", a, k_)
    times.update(t)
    for light in (True, False):
        _check_result_live(lambda n: sweep_search(light, n, defer=True),
                           f"phase 5's namespace, bf16 {'light' if light else 'heavy'} l2, "
                           f"k bucket 16")
    wall_sweep = _engine_wall(qps, q_np)
    split_sweep = _engine_split(qps, q_np)
    times["engine_wall_sweep_masked_median"] = statistics.median(wall_sweep)

    flop = 2.0 * N * 512 * D
    for name, ms in times.items():
        extra = ""
        if name in ("fast_full", "masked_full", "sweep_light_full"):
            extra = f", {flop / ms / 1e9:.1f} TFLOP/s"
        elif name in ("fast", "masked"):
            extra = f", {flop / 4 / ms / 1e9:.1f} TFLOP/s of f32 products on the {B} live queries"
        elif name == "sweep_light":
            extra = f", {flop / 4 / ms / 1e9:.1f} TFLOP/s on the {B} live queries"
        elif name == "sweep_heavy":
            extra = f", {3 * flop / 4 / ms / 1e9:.1f} TFLOP/s on the {B} live queries"
        elif name == "gather_score":
            extra = f", {gather_rows * D * 4 / ms / 1e6:.1f} GB/s of the computed rows"
        print(f"  {name}: {ms:.4f} ms{extra}")
    print(f"  query columns of the timed live B4/B5 launches: {b4_cols}")
    if any(c != B for c in b4_cols.values()):
        raise AssertionError(f"a timed B4/B5 launch computed other than {B} columns: {b4_cols}")
    print(f"  engine wall runs (ms), B={B} l2: fast path {wall_fast}, masked path "
          f"{wall_masked}, sweep path (tombstoned) {wall_sweep} on {gpu}")
    print(f"  engine split, median ms (host clock): fast path {split_fast}, masked path "
          f"{split_masked}, sweep path {split_sweep}")

    # ---- 7. the k-bucket-128 certified sweep program -----------------------------------
    _c18_phase("phase 7")
    print(f"phase 7 k-bucket-128 sweep program: pool kernel, k=100 engine, range search, NaN "
          f"query, on {gpu}")
    worst["pool"] = check_pool_kernel(db_np)
    _, k100["after"] = run_k100_searches(qps, sweep_ids, q_np, oracle, dead, "after delete")
    range_wall = check_range_search(qps, sweep_ids, q_np, oracle, dead)
    check_nan_query(db_np)

    def k128_search(light, tuning=fused_knn_t.DEFAULT_TUNING, n_live=B, defer=False):
        """The engine's k=100 l2 B=128 search: bucket 512, k bucket 128, pool only."""
        return fused_knn_t.exact_knn_t(
            q_pad, sst.mirror, sst.data, sst.valid, sst.sq_norms, k=128, metric="l2",
            live_prefix=None, sweep_err=sst.sweep_err, resid=sst.sweep_resid,
            rscale=sst.sweep_rscale, err1=sst.sweep_err1, light=light,
            prep_cache=sst.prep_cache, report_tier=True, tuning=tuning, n_live=n_live,
            defer=defer)

    t7 = {}
    for light in (True, False):
        name = "topm" if light else "topm_heavy"
        a, k_ = operands[name] = _capture("_window_mins_t", lambda: k128_search(light))
        if not (k_["skip_wm"] and k_["emit_topm"] and k_["r1"] == 16):
            raise AssertionError(f"the k=128 search did not take the pool-only program: {k_}")
        t7.update(_time_b1(name, a, k_))
        t7["exact_knn_t_k128_" + ("light" if light else "heavy")] = _time_ms(
            lambda: k128_search(light))
        if light:
            # the same launch with the window mins only, and with both outputs: the cost
            # of the epilogue and of the write skip_wm drops
            only = dict(k_, emit_topm=0, skip_wm=False)
            both = dict(k_, skip_wm=False)
            t7["topm_r16_window_mins_only"] = _time_ms(
                lambda: fused_knn_t._window_mins_t(*a, **only))
            t7["topm_with_window_mins"] = _time_ms(
                lambda: fused_knn_t._window_mins_t(*a, **both))
            # the same search in the JAX package's MLVDB_TOPM=0 program, which the port ran
            # at this k bucket before it had the pool: two-level selection on the window mins
            off = fused_knn_t.Tuning(topm_enable=False)
            if _capture("_window_mins_t", lambda: k128_search(True, off))[1]["emit_topm"]:
                raise AssertionError("Tuning(topm_enable=False) still ran the pool")
            t7["exact_knn_t_k128_light_pool_off"] = _time_ms(lambda: k128_search(True, off))
    a, k_ = operands["gather_k128"] = _capture("_gather_score", lambda: k128_search(True))
    t, b, _, _ = time_gather("gather_k128", a, k_)
    t7.update(t)
    gather_bounds.update(b)
    for light in (True, False):
        _check_result_live(lambda n: k128_search(light, n_live=n, defer=True),
                           f"phase 7, bf16 {'light' if light else 'heavy'} l2, k bucket 128")
    wall_k100 = _engine_wall(qps, q_np, k=K100)
    split_k100 = _engine_split(qps, q_np, k=K100)
    t7["engine_wall_k100_median"] = statistics.median(wall_k100)
    t7["range_search_limit100_median"] = statistics.median(range_wall)
    for name, ms in t7.items():
        extra = ""
        if name in ("topm", "topm_heavy"):
            extra = (f", {flop / 4 * (3 if name == 'topm_heavy' else 1) / ms / 1e9:.1f} "
                     f"TFLOP/s on the {B} live queries")
        print(f"  {name}: {ms:.4f} ms{extra}")
    print(f"  engine wall runs (ms), B={B} l2 k=100, sweep path (tombstoned): {wall_k100}")
    print(f"  engine split k=100, median ms (host clock): {split_k100}")
    print(f"  range_search limit=100 runs (ms, host clock): {range_wall}")
    times.update(t7)

    # ---- 8. the int8 mirror -------------------------------------------------------------
    _c18_phase("phase 8")
    print(f"phase 8 int8 mirror (sweep_dtype='int8', two int8 streams): kernel B3 vs plain, "
          f"QueryProcessor at {N:,} x {D}, on {gpu}")
    worst["b3"] = check_b3_kernels(db_np, B3_PROGRAMS[:3])
    qp8, _, c8, _ = run_mirror_path(EngineConfig(sweep_dtype="int8"), "int8", db_np, q_np,
                                    oracle, dead)
    if c8["int8"] != 12 or c8["sweep_heavy"] != 12 or c8["gather"] < 1:
        raise AssertionError(f"the heavy int8 kernel did not serve every search: {c8}")
    t8, operands8 = time_mirror_kernels(qp8, q_pad, "b3_int8", light_variants=True)
    t8["engine_wall_int8_median"] = statistics.median(wall_int8 := _engine_wall(qp8, q_np))
    split_int8 = _engine_split(qp8, q_np)
    # one int8 stream (sweep_resid=False): one l2 batch, its tier reported
    qp1 = QueryProcessor(EngineConfig(sweep_dtype="int8", sweep_resid=False), device=dev)
    ids1 = qp1.bulk_load(db_np, "sift")
    outer = _sweep_counts()
    _set_sweep_counts([0] * len(outer))
    x0 = _xfer_mark(qp1)
    res = qp1.find_similar_batch([VectorDTO(v) for v in q_np], K, "sift", "l2")
    c1 = dict(zip(_COUNT_NAMES, _sweep_counts()))
    _set_sweep_counts(outer)
    xfer = _xfer(qp1, x0)
    print(f"  int8, one stream: l2 B={B} k={K} served by {qp1.cert_tier_counts('sift')}, "
          f"transfers {xfer}, launches {c1}")
    _check_recall(res, oracle.sets("l2", B), ids1, "int8 one stream l2 B=128")
    if c1["int8"] != 1 or c1["sweep_heavy"] != 1 or xfer[0] != 1:
        raise AssertionError(f"the one-stream int8 search did not run B3: {c1} {xfer}")
    del qp1, ids1, res

    # ---- 9. the f32 mirror ---------------------------------------------------------------
    _c18_phase("phase 9")
    print(f"phase 9 f32 mirror (sweep_dtype='float32'): kernel B3 vs plain, QueryProcessor "
          f"at {N:,} x {D}, on {gpu}")
    worst["b3"].update(check_b3_kernels(db_np, B3_PROGRAMS[3:]))
    check_b3_f32_wide()
    qpf, _, cf, _ = run_mirror_path(EngineConfig(sweep_dtype="float32"), "f32", db_np, q_np,
                                    oracle, dead)
    nsf = qpf.storage.namespace("sift")
    if nsf.device_state().mirror is not nsf.device_state().data or (
            nsf.nbytes != nsf.capacity * (D * 4 + 5)):
        raise AssertionError(f"the f32 mirror is not the row store: {nsf.nbytes}")
    if cf["f32"] != 12 or cf["sweep_heavy"] != 0 or cf["gather"] < 1:
        raise AssertionError(f"the f32 kernel did not serve every search: {cf}")
    tf, operandsf = time_mirror_kernels(qpf, q_pad, "b3_f32", light_variants=False)
    t16, o16 = time_b3_f32(nsf.device_state(), q_np, "b3_f32")
    tf.update(t16)
    operandsf.update(o16)
    f32_route = print_f32_route(tf, operandsf, ("b3_f32", "b3_f32_k128", "b3_f32_b16_ip",
                                                "b3_f32_b16_cosine"), cf["f32"], "phase 9")
    tf["engine_wall_f32_median"] = statistics.median(wall_f32 := _engine_wall(qpf, q_np))
    split_f32 = _engine_split(qpf, q_np)
    for name, ms in {**t8, **tf}.items():
        print(f"  {name}: {ms:.4f} ms")
    print(f"  engine wall runs (ms), B={B} l2 k={K}, tombstoned, on {gpu}: int8 {wall_int8}, "
          f"f32 {wall_f32}, bf16 sweep (phase 6) {wall_sweep}")
    print(f"  engine split, median ms (host clock): int8 {split_int8}, f32 {split_f32}")
    times.update(t8)
    times.update(tf)
    operands.update(operands8)
    operands.update(operandsf)

    # ---- 10. probe B7 -------------------------------------------------------------------
    _c18_phase("phase 10")
    print(f"phase 10 int8 probe (B7): B3's int8 pass (bf16 mma.sync) vs int8 mma.sync vs the "
          f"stream floor, "
          f"{N:,} x {D} codes, B=128, on {gpu}")
    probe = run_int8_probe(qp8.storage.namespace("sift").device_state().mirror, rng)

    # ---- 11. a bf16 store, row-major -------------------------------------------------------
    _c18_phase("phase 11")
    print(f"phase 11 bf16 store, row-major (dtype='bfloat16'): kernels B4/B5 over bf16 rows vs "
          f"plain, QueryProcessor at {N:,} x {D}, on {gpu}")
    errs, ratios = check_kernels(db_np, torch.bfloat16)
    for name, err in errs.items():
        worst[name + "_bf16"] = err
        b4_ratio[name + "_bf16"] = ratios[name]
    check_window_min_nan(db_np, torch.bfloat16)
    c11, t11, b11, k11, proof11 = run_bf16_row_major(db_np, q_np, dead, self_row, q_pad)
    row_proof.update(proof11)
    times.update(t11)
    b4_cols.update(k11)
    c3 = check_c3(db_np)
    c18 = check_c18(db_np)

    # ---- 12. DEEP: the same-dtype certified sweep ----------------------------------------
    _c18_phase("phase 12")
    print(f"phase 12 DEEP: QueryProcessor(dtype='bfloat16', sweep_dtype='bfloat16') at "
          f"{N_DEEP:,} x {D}, on {gpu}")
    c12, worst["same_dtype"], worst["gather_bf16"], t12, b12, deep_rows, deep = run_deep()
    times.update(t12)

    # ---- 13. probe B6 ----------------------------------------------------------------------
    _c18_phase("phase 13")
    print(f"phase 13 output-layout probe (B6): [B, P] vs tile-major over the phase-12 rows, "
          f"on {gpu}")
    b6 = run_out_layout(deep_rows, rng)

    # ---- 14. live columns at the engine's operands; the tensor cores' error --------------
    _c18_phase("phase 14")
    print(f"phase 14 B1/B3 at the engine's operands of phases 6-9: the live-column launch "
          f"against the full one; the tensor-core dots against float64, on {gpu}")
    b1_names = ("sweep_light", "sweep_heavy", "topm", "topm_heavy", "b3_int8", "b3_int8_k128",
                "b3_int8_two_pass", "b3_int8_light", "b3_f32", "b3_f32_k128")
    live_cols = {name: _check_live_tiles(*operands[name], B, name) for name in b1_names}
    print(f"  query columns computed at B={B} in the 512 bucket, every column of every output "
          f"bit-equal to the full launch: {live_cols}")
    if any(c != B for c in live_cols.values()):
        raise AssertionError(f"a launch computed other than the live columns: {live_cols}")
    tc_err, tc_bar = check_tc_error(deep_rows, db_np, rng)
    b4_err = check_b4_tc_error(db_np, deep_rows, rng)
    del deep_rows

    # ---- 15. filtered (hybrid) search at the GloVe-1.2M shape -----------------------------
    _c18_phase("phase 15")
    print(f"phase 15 hybrid: QueryProcessor(sweep_dtype='bfloat16') at {N_GLOVE:,} x "
          f"{D_GLOVE} with metadata filters (B1 over a masked bias row, B2; B5 over a "
          f"filter), on {gpu}")
    c15, w15, t15, b15, x15 = run_hybrid(gpu)
    times.update(t15)
    print(f"  B1 light at the 50% filter {times['hybrid_sweep']:.4f} ms over "
          f"{b15['hybrid_sweep'][2] / 1e6:.0f} MB beside phase 6's {times['sweep_light']:.4f} "
          f"ms (2^20 rows, 0.1% tombstones)")

    # ---- 16. durability and operations on phase 6's namespace ----------------------------
    _c18_phase("phase 16")
    print(f"phase 16 durability and operations: snapshot, WAL crash recovery, offload, "
          f"warmup and the operations surface on phase 6's namespace ({N:,} x {D}, bf16 "
          f"mirror, after its deletes), on {gpu}")
    c16, f16 = run_durability(qps, sweep_ids, db_np, q_np, oracle, dead, gpu)

    # ---- 17. IVF at the SIFT-1M stand-in; 18. the server over it ----------------------
    _c18_phase("phases 17-18")
    print(f"phase 17 IVF: QueryProcessor(EngineConfig()) at the SIFT-1M stand-in "
          f"({N_IVF:,} x {D_IVF} clustered rows), build_ivf with the defaults (spill 1 and "
          f"2), {NQ_IVF} queries, l2, k={K}, nprobe {NPROBES}")
    t17 = time.perf_counter()
    ivf_rec, ivf_qp, ivf_q = run_ivf(gpu)
    ivf_rec["seconds"] = time.perf_counter() - t17
    print(f"  phase 17 took {ivf_rec['seconds']:.1f} s")
    missing = _server_missing()
    if missing:
        print(f"phase 18 server: not run, {missing} does not import on this machine")
        server_rec = {"not_run": f"{missing} does not import"}
    else:
        print("phase 18 server: RestAPI over phase 17's processor in aiohttp's in-process "
              "test server: /health, insert and delete, /search/batch, /ivf/build and "
              "nprobe, --auto-batch, gRPC where grpc imports")
        t18 = time.perf_counter()
        server_rec = run_server(ivf_qp, ivf_q, gpu)
        server_rec["seconds"] = time.perf_counter() - t18
        print(f"  phase 18 took {server_rec['seconds']:.1f} s")
    del ivf_qp

    # ---- 19. the distributed engine ------------------------------------------------------
    _c18_phase("phase 19")
    print(f"phase 19 distributed engine: make_distributed_processor, DEEP ({N_DEEP:,} x {D} "
          f"bf16) on a (1, 4) mesh and the SIFT-1M shape on (2, 2), on {gpu}")
    t19 = time.perf_counter()
    mesh_rec, c19a, c19b, t19_, b19, w19 = run_mesh(gpu, deep, {
        "dead": dead, "oracle": oracle, "db": db_np, "q": q_np, "row_qp": qp, "row_ids": ids,
        "sweep_qp": qps, "sweep_ids": sweep_ids})
    mesh_rec["seconds"] = time.perf_counter() - t19
    times.update(t19_)
    print(f"  phase 19 took {mesh_rec['seconds']:.1f} s")
    del deep

    # ---- 20. a bf16 store with an int8 or f32 mirror --------------------------------------
    _c18_phase("phase 20")
    print(f"phase 20 bf16 store with an int8 or f32 mirror: QueryProcessor(dtype='bfloat16', "
          f"sweep_dtype='int8' | 'float32') at {N:,} x {D}: B3 over the mirror, B2 over the "
          f"bf16 rows, C17's near tie, on {gpu}")
    t20 = time.perf_counter()
    c20, w20, t20_, b20, rec20 = run_bf16_mirrors(db_np, q_np, dead, gpu)
    rec20["seconds"] = time.perf_counter() - t20
    times.update(t20_)
    print(f"  phase 20 took {rec20['seconds']:.1f} s")

    # ---- 21. wide embeddings through the engine ------------------------------------------
    _c18_phase("phase 21")
    print(f"phase 21 wide embeddings: QueryProcessor at Dp = 1536 (bf16 store, {1 << 20:,} rows) "
          f"and 3072 (f32 store, {1 << 19:,} rows, int8 and bf16 mirrors; a clustered "
          f"{N_WIDE_CLUSTERED:,} x 3072 namespace): B1/B3 with its query tile streamed, B2, "
          f"on {gpu}")
    t21 = time.perf_counter()
    c21, w21, t21_, b21, routes21, rec21 = run_wide(gpu)
    rec21["seconds"] = time.perf_counter() - t21
    times.update(t21_)
    print(f"  phase 21 took {rec21['seconds']:.1f} s")
    c18_counts = _c18_phase(None)

    # each kernel's bound at the operands timed above: every input read once, every
    # output written once; the products over the peak for their type (B1/B3 and B4/B5:
    # of the live queries, and of the whole padded batch beside it; B4/B5 over f32 rows
    # by the split's six bf16 passes, with the f32 FMA route's beside it)
    bounds = {}
    for key, (a, k_) in row_ops.items():
        bounds[key] = _b4_bound(a, k_)
        bounds[key + "_full_batch"] = _b4_bound(a, k_, full_batch=True)
    fma_bounds = {key: _b4_bound(a, k_, route="fma")[0] for key, (a, k_) in row_ops.items()}
    print(f"  B4/B5 f32 rows on the f32 FMA route instead: bound {fma_bounds} ms")
    for name in b1_names:
        a, k_ = operands[name]
        outs = fused_knn_t._window_mins_t(*a, **k_)
        bounds[name] = _b3_bound(a, k_, outs)
        bounds[name + "_full_batch"] = _b3_bound(a, k_, outs, full_batch=True)
        del outs
    # the f32 mirror's launches at B = 16 (phase 9), on the split's route
    bounds.update({name: bound for name, (bound, _) in f32_route.items()})
    bounds.update(gather_bounds)
    bounds.update(b11)
    bounds.update(b12)
    bounds.update(b15)
    bounds.update(b19)
    bounds.update(b20)
    bounds.update(b21)
    for name, (ms, by, nbytes, ops) in bounds.items():
        base = name.removesuffix("_full_batch")
        timed = times[name] if base == name else times[base + "_full"]
        print(f"  bound {name}: {ms:.4f} ms ({by}; {nbytes / 1e6:.0f} MB, {ops / 1e9:.1f} "
              f"G operations); the kernel{'' if base == name else ' launched on every column'} "
              f"at {ms / timed:.1%} of it")

    def entry(name, source, replaces, launches_, err, key):
        e = {"name": name, "route": "cuda", "source": CSRC + source,
             "replaces": replaces, "launches": launches_, "max_abs_err": err,
             "ms": times[key], "plain_ms": times[key + "_plain"],
             "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
             # no single PyTorch call computes a windowed min of ranks, a tile's top-m
             # window mins or a window gather with two reductions
             "library_ms": None}
        if key + "_full_batch" in bounds:
            # B1/B3 and B4/B5: the bound at the engine's padded batch, and the kernel's
            # time when it computes every column of it
            e.update({"bound_full_batch_ms": bounds[key + "_full_batch"][0],
                      "full_launch_ms": times[key + "_full"]})
        return e

    def f32_entry(e, key, fma_bounds_):
        """B3 over an f32 mirror: the route its bound assumes and the FMA route's bound,
        the dots' error against float64, the engine's B = 16 launches (ip, cosine)."""
        e.update({"bound_route": F32_ROUTE, "bound_fma_ms": fma_bounds_[key],
                  "tc_error_max": tc_err["f32_gaussian"],
                  "tc_error_max_hard_rows": tc_err["f32_hard"], "tc_error_bar": tc_bar})
        for m in ("ip", "cosine"):
            k_ = f"{key}_b16_{m}"
            e.update({f"b16_{m}_ms": times[k_], f"b16_{m}_plain_ms": times[k_ + "_plain"],
                      f"b16_{m}_full_launch_ms": times[k_ + "_full"],
                      f"b16_{m}_bound_ms": bounds[k_][0],
                      f"b16_{m}_bound_fma_ms": fma_bounds_[k_]})
        return e

    def gather_entry(e, key, main_rows, k128=None):
        """B2: the candidate rows its main-path launches and its timed live launch
        computed, the gather alone (index_select, a yardstick the port never calls), the
        k-bucket-128 operands and Dp = 1536."""
        e.update({"rows": main_rows, "timed_launch_rows": TIMED_ROWS[key],
                  "index_select_ms": times[key + "_index_select"],
                  "hot_ms": times[key + "_hot"]})
        if key in gather_wide:
            e["wide_dp"] = gather_wide[key]
        if k128:
            e.update({f"k128_{f}": times[k128 + s] for f, s in (
                ("ms", ""), ("plain_ms", "_plain"), ("full_launch_ms", "_full"),
                ("index_select_ms", "_index_select"))})
            e.update({"k128_bound_ms": bounds[k128][0],
                      "k128_bound_full_batch_ms": bounds[k128 + "_full_batch"][0],
                      "k128_max_abs_err": GATHER_ERR[k128]})
        return e

    def row_entry(name, replaces, launches_, key, rows):
        """B4/B5: the budget ratio, the route its bound assumes, the product alone as one
        PyTorch call (a yardstick the port never calls), the live columns."""
        e = entry(name, "window_min.cu", replaces, launches_, worst[key], key)
        e.update({"max_err_over_budget": b4_ratio[key],
                  "bound_route": ("bf16 tensor cores, 6 passes of the 3-way split"
                                  if rows == "f32" else "bf16 tensor cores, one pass"),
                  "matmul_ms": times["matmul_" + rows], "live_columns": b4_cols[key],
                  "wide_dp": wide[key],
                  "tc_error_max": b4_err["f32_gaussian" if rows == "f32" else "bf16_deep_rows"]})
        if rows == "f32":
            e.update({"bound_fma_ms": fma_bounds[key],
                      "tc_error_max_hard_rows": b4_err["f32_hard"], "tc_error_bar": tc_bar})
        return e

    sweep = entry("sweep_min", "sweep_min.cu", "mlvectordb_tpu/ops/pallas_knn_t.py:221",
                  launches["sweep"], max(worst["light"], worst["heavy"]), "sweep_light")
    sweep.update({
        "launches_heavy": launches["sweep_heavy"], "heavy_ms": times["sweep_heavy"],
        "heavy_plain_ms": times["sweep_heavy_plain"], "heavy_bound_ms": bounds["sweep_heavy"][0],
        "launches_topm": k100["before"]["topm"] + k100["after"]["topm"],
        "topm_ms": times["topm"], "topm_plain_ms": times["topm_plain"],
        "topm_bound_ms": bounds["topm"][0], "topm_heavy_ms": times["topm_heavy"],
        "topm_heavy_plain_ms": times["topm_heavy_plain"],
        "topm_max_abs_err": worst["pool"]["value"],
        "heavy_full_launch_ms": times["sweep_heavy_full"],
        "heavy_bound_full_batch_ms": bounds["sweep_heavy_full_batch"][0],
        "topm_full_launch_ms": times["topm_full"],
        "topm_bound_full_batch_ms": bounds["topm_full_batch"][0],
        "topm_heavy_full_launch_ms": times["topm_heavy_full"],
        "topm_heavy_bound_full_batch_ms": bounds["topm_heavy_full_batch"][0],
        "matmul_ms": times["matmul_light"], "live_columns": live_cols,
        "tc_error_max": tc_err, "tc_error_bar": tc_bar,
        # phase 16: the loaded, recovered and paged-in namespaces' searches, and warmup
        "launches_durability": c16["sweep"], "launches_warmup": f16["warmup_sweep_launches"],
        "durability": f16})
    gather = gather_entry(entry("gather_score", "gather_score.cu",
                                "mlvectordb_tpu/ops/pallas_gather.py:33", launches["gather"],
                                worst["gather"], "gather_score"), "gather_score",
                          launches["gather_rows"], "gather_k128")
    gather.update({"launches_durability": c16["gather"],
                   "launches_warmup": f16["warmup_gather_launches"]})
    record = {"kernels": [
        row_entry("window_min_fast", "mlvectordb_tpu/ops/pallas_knn.py:102", launches["fast"],
                  "fast", "f32"),
        row_entry("window_min_masked", "mlvectordb_tpu/ops/pallas_knn.py:131",
                  launches["masked"], "masked", "f32"),
        sweep,
        gather,
    ]}
    # kernel B3: the engine's int8 program (two_pass + the second stream) and the f32 one
    for name, key, counts, programs in (("sweep_min_int8", "b3_int8", c8["int8"],
                                         B3_PROGRAMS[:3]),
                                        ("sweep_min_f32", "b3_f32", cf["f32"], B3_PROGRAMS[3:])):
        e = entry(name, "sweep_min.cu", "mlvectordb_tpu/ops/pallas_knn_t.py:221", counts,
                  max(worst["b3"][p][0] for p in programs), key)
        e.update({"differing_elements": sum(worst["b3"][p][1] for p in programs),
                  "k128_ms": times[key + "_k128"], "k128_plain_ms": times[key + "_k128_plain"],
                  "k128_bound_ms": bounds[key + "_k128"][0],
                  "k128_full_launch_ms": times[key + "_k128_full"],
                  "k128_bound_full_batch_ms": bounds[key + "_k128_full_batch"][0]})
        if key == "b3_int8":
            e.update({f"{v}_{f}": times["b3_int8_" + v + ("_plain" if f == "plain_ms" else "")]
                      for v in ("two_pass", "light") for f in ("ms", "plain_ms")})
            e.update({"launches_one_stream": c1["int8"]})
        else:
            e = f32_entry(e, key, {k_: fma for k_, (_, fma) in f32_route.items()})
        record["kernels"].append(e)
    for name, line in (("int8_probe_convert_mma", 57), ("int8_probe_mma", 67),
                       ("int8_probe_stream", 76)):
        r = probe[name]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": CSRC + ("sweep_min.cu" if name == "int8_probe_convert_mma"
                              else "int8_probe.cu"),
            "replaces": f"benchmarks/probe_int8_mxu.py:{line}", "launches": r["launches"],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            # torch._int_mm gives the int8 product alone, no window min: no single call
            "library_ms": None})
    # bf16 storage: B4/B5 and B2 over bf16 rows, B1 over a bf16 store's own rows
    for name, replaces, launches_, key in (
            ("window_min_fast_bf16", "mlvectordb_tpu/ops/pallas_knn.py:102", c11["fast_bf16"],
             "fast_bf16"),
            ("window_min_masked_bf16", "mlvectordb_tpu/ops/pallas_knn.py:131",
             c11["masked_bf16"], "masked_bf16")):
        record["kernels"].append(row_entry(name, replaces, launches_, key, "bf16"))
    for name, source, replaces, launches_, key in (
            ("gather_score_bf16", "gather_score.cu", "mlvectordb_tpu/ops/pallas_gather.py:33",
             c12["gather_bf16"], "gather_bf16"),
            ("sweep_min_same_dtype", "sweep_min.cu", "mlvectordb_tpu/ops/pallas_knn_t.py:221",
             c12["sweep"], "sweep_same_dtype")):
        err = worst["same_dtype" if key == "sweep_same_dtype" else key]
        e = entry(name, source, replaces, launches_, err, key)
        if key == "gather_bf16":
            e = gather_entry(e, key, c12["gather_rows"], "gather_bf16_k128")
        if key == "sweep_same_dtype":
            e.update({f"{v}_{f}": times[f"sweep_same_dtype_{v}" + ("_plain" if f == "plain_ms"
                                                                   else "")]
                      for v in ("l2", "k128") for f in ("ms", "plain_ms")})
            e.update({"launches_topm": c12["topm"], "matmul_ms": times["matmul_deep"],
                      "live_columns": c12["cols"]})
        record["kernels"].append(e)
    # phase 15: B1 over the 50% filter's masked bias row, B2 on its rescan, B5 over a filter
    for name, source, replaces, launches_, key, err in (
            ("sweep_min_hybrid", "sweep_min.cu", "mlvectordb_tpu/ops/pallas_knn_t.py:221",
             c15["sweep"], "hybrid_sweep", w15["b1"]),
            ("gather_score_hybrid", "gather_score.cu", "mlvectordb_tpu/ops/pallas_gather.py:33",
             c15["gather"], "hybrid_gather", w15["b2"]),
            ("window_min_masked_hybrid", "window_min.cu", "mlvectordb_tpu/ops/pallas_knn.py:131",
             c15["masked"], "hybrid_masked", w15["b5"])):
        e = entry(name, source, replaces, launches_, err, key)
        if key == "hybrid_sweep":
            e.update({"exact_knn_t_light_ms": times["exact_knn_t_hybrid_light"],
                      "exact_knn_t_heavy_ms": times["exact_knn_t_hybrid_heavy"],
                      "engine_wall_ms": times["engine_wall_hybrid_median"],
                      "engine_wall_k100_ms": times["engine_wall_hybrid_k100_median"],
                      "engine_split_ms": x15["split"], "mask_native_ms":
                      times["mask_native_median"], "mask_python_2e16_ms":
                      times["mask_python_2e16_median"], "mask_uploads": x15["mask_uploads"],
                      "snapshot_filter_pairs": x15["snapshot_filter_pairs"],
                      "native_mask_calls": x15["native_mask_calls"],
                      "hydrate_native": x15["hydrate_built"], "launches_topm": c15["topm"]})
        record["kernels"].append(e)
    for name, line in (("out_layout_2d", 54), ("out_layout_3d", 75)):
        r = b6[name[-2:]]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": CSRC + "sweep_min.cu",
            "replaces": f"benchmarks/probe_out3d.py:{line}", "launches": r["launches"],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None,
            **{k: v for k, v in r.items() if k.startswith("r1_4_")}})
    # phase 19: B1 and B2 at a DEEP shard's operands, B5 at a SIFT-shape shard's, each with
    # the launches of its cell's counted run (one per shard of each replica holding a live
    # query, per search)
    for name, source, replaces, launches_, key, err in (
            ("sweep_min_shard", "sweep_min.cu", "mlvectordb_tpu/ops/pallas_knn_t.py:221",
             c19a["sweep"] + c19b["bf16_mirror"]["sweep"], "sweep_shard", w19["sweep"]),
            ("gather_score_shard", "gather_score.cu", "mlvectordb_tpu/ops/pallas_gather.py:33",
             c19a["gather"] + c19b["bf16_mirror"]["gather"], "gather_shard", w19["gather"]),
            ("window_min_masked_shard", "window_min.cu", "mlvectordb_tpu/ops/pallas_knn.py:131",
             c19b["row_major"]["masked"], "masked_shard", w19["masked"])):
        e = entry(name, source, replaces, launches_, err, key)
        if key != "masked_shard":
            kind_ = "sweep" if key == "sweep_shard" else "gather"
            e.update({"launches_deep": c19a[kind_],
                      "launches_sift_bf16_mirror": c19b["bf16_mirror"][kind_]})
        if key == "sweep_shard":
            e.update({"merge_ms": times["merge"], "merge_host_ms": times["merge_host"],
                      "engine_wall_sharded_ms": times["engine_wall_sharded_median"],
                      "engine_wall_unsharded_ms": times["engine_wall_unsharded_median"]})
        if key == "gather_shard":
            e.update({"timed_launch_rows": TIMED_ROWS[key],
                      "index_select_ms": times[key + "_index_select"]})
        record["kernels"].append(e)
    # phase 20: B3 over the int8 codes and the f32 mirror of a bf16 store, B2 over its rows
    for name, source, replaces, launches_, key in (
            ("sweep_min_int8_bf16_store", "sweep_min.cu",
             "mlvectordb_tpu/ops/pallas_knn_t.py:221", c20["int8"]["int8"], "b3_int8_bf16_store"),
            ("sweep_min_f32_bf16_store", "sweep_min.cu",
             "mlvectordb_tpu/ops/pallas_knn_t.py:221", c20["f32"]["f32"], "b3_f32_bf16_store"),
            ("gather_score_bf16_store", "gather_score.cu",
             "mlvectordb_tpu/ops/pallas_gather.py:33",
             c20["int8"]["gather_bf16"] + c20["f32"]["gather_bf16"],
             "gather_f32_bf16_store")):
        e = entry(name, source, replaces, launches_, w20[key], key)
        if key.startswith("gather"):
            e.update({"timed_launch_rows": TIMED_ROWS[key],
                      "index_select_ms": times[key + "_index_select"],
                      "int8_store_ms": times["gather_int8_bf16_store"],
                      "int8_store_plain_ms": times["gather_int8_bf16_store_plain"],
                      "int8_store_max_abs_err": w20["gather_int8_bf16_store"]})
        else:
            mirror = key.split("_")[1]
            e.update({"exact_knn_t_ms": times[f"exact_knn_t_{mirror}_bf16_store"],
                      "engine_wall_ms": times[f"engine_wall_{mirror}_bf16_store_median"],
                      "prep_first_search_ms": times[f"prep_first_search_{mirror}"]})
            if mirror == "int8":
                e["launches_one_stream"] = c20["int8_one_stream"]["int8"]
            else:
                e = f32_entry(e, key, rec20["f32"]["bound_fma_ms"])
        record["kernels"].append(e)
    # phase 21: B1/B3 and B2 at wide Dp, each program at the engine's B=128 k=10 operands,
    # with its B=16 and k-bucket-128 launches beside; launches per program in its cell
    cells = {"bf16_store_1536": ("cosine", "ip"), "int8_3072": ("l2", "cosine"),
             "bf16_mirror_3072": ("l2", "cosine")}
    wide_b1 = (("sweep_min_wide_same_dtype_1536", "bf16_store_1536", "",
                c21["bf16_store_1536"]["sweep"]),
               ("sweep_min_wide_int8_3072", "int8_3072", "", c21["int8_3072"]["int8"]),
               ("sweep_min_wide_light_3072", "bf16_mirror_3072", "_light",
                c21["bf16_mirror_3072"]["sweep"] - c21["bf16_mirror_3072"]["sweep_heavy"]),
               ("sweep_min_wide_heavy_3072", "bf16_mirror_3072", "",
                c21["bf16_mirror_3072"]["sweep_heavy"]))
    for name, cell, suffix, launches_ in wide_b1:
        m128, m16 = cells[cell]
        key = f"wide_{cell}_{m128}_b{B}_k{K}{suffix}"
        e = entry(name, "sweep_min.cu", "mlvectordb_tpu/ops/pallas_knn_t.py:221", launches_,
                  w21[key], key)
        e.update({"share": bounds[key][0] / times[key], "route": routes21[key],
                  "matmul_ms": times[key + "_matmul"]})
        for extra, k_ in ((f"b16_{m16}", f"wide_{cell}_{m16}_b16_k{K}{suffix}"),
                          ("k128", f"wide_{cell}_{m128}_b{B}_k{K100}{suffix}")):
            e.update({f"{extra}_ms": times[k_], f"{extra}_plain_ms": times[k_ + "_plain"],
                      f"{extra}_bound_ms": bounds[k_][0], f"{extra}_route": routes21[k_],
                      f"{extra}_max_abs_err": w21[k_]})
        record["kernels"].append(e)
    key = "wide_clustered_3072_heavy"
    e = entry("sweep_min_wide_heavy_clustered_3072", "sweep_min.cu",
              "mlvectordb_tpu/ops/pallas_knn_t.py:221", c21["clustered_3072"]["sweep_heavy"],
              w21[key], key)
    e.update({"share": bounds[key][0] / times[key], "route": routes21[key],
              "matmul_ms": times[key + "_matmul"]})
    record["kernels"].append(e)
    for cell in cells:
        key = f"wide_gather_{cell}_k16"
        e = gather_entry(entry(f"gather_score_wide_{cell}", "gather_score.cu",
                               "mlvectordb_tpu/ops/pallas_gather.py:33", c21[cell]["gather"],
                               w21[key], key), key, c21[cell]["gather_rows"],
                         f"wide_gather_{cell}_k128")
        e.update({"share": bounds[key][0] / times[key],
                  "exact_knn_t_ms": times[f"exact_knn_t_{cell}_k16"],
                  "exact_knn_t_k128_ms": times[f"exact_knn_t_{cell}_k128"],
                  "engine_wall_ms": times[f"engine_wall_{cell}_median"]})
        record["kernels"].append(e)
    # the IVF and server phases run no hand-written kernel of their own: their record
    print(json.dumps({"ivf": ivf_rec, "server": server_rec}, default=str))
    print(json.dumps({"c18": {"paths": c18, "settle_counts": c18_counts}}, default=str))
    print(json.dumps({"c20": row_proof}, default=str))
    print(json.dumps({"mesh": mesh_rec}, default=str))
    print(json.dumps({"bf16_mirrors": rec20}, default=str))
    print(json.dumps({"wide": rec21}, default=str))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s on {gpu}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

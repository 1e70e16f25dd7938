"""The control of the comparison: the reference put in the program's place, computed
in the nearest precision below the configuration's, has to come out as not correct.

    python3 perfbench/control.py --workload <cell> --seed <n> [--precision tf32]

The configuration states float32 rows ranked at full float32 precision (TF32 off) and
settled in float64, so the control is TF32: rows and queries rounded to TF32's 10-bit
mantissa, products summed in float32.  It answers as many queries of the cell's pool as
a run checks (``check_calls`` batches), at the cell's own rows, and prints the same
numbers beside the same limits.  The benchmark's runs do not run it.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "perfbench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import data, harness, judge, reference, spec  # noqa: E402

MANTISSA = {"tf32": 10, "bf16": 7}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at ``bits`` mantissa bits."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    bias = ((i >> drop) & 1) + ((1 << (drop - 1)) - 1)
    return ((i + bias) & ~((1 << drop) - 1)).view(torch.float32)


def control_topk(chunks, queries: torch.Tensor, k: int, metric: str, keep, bits: int):
    """Top k by the metric computed on operands rounded to ``bits`` mantissa bits,
    summed in float32: (rows [m, k'], float32 distances [m, k'])."""
    q = round_mantissa(queries, bits)
    cand_d, cand_i = [], []
    for lo, x in chunks:
        idx = torch.arange(lo, lo + x.shape[0], device=q.device)
        if keep is not None:
            sel = torch.from_numpy(np.ascontiguousarray(keep[lo:lo + x.shape[0]])).to(q.device)
            x, idx = x[sel], idx[sel]
            if x.shape[0] == 0:
                continue
        x = round_mantissa(x, bits)
        xx = (x * x).sum(1)[None, :]
        ds, ids = [], []
        for b in range(0, q.shape[0], 512):
            qb = q[b:b + 512]
            dots = qb @ x.T
            if metric == "l2":
                d = (qb * qb).sum(1)[:, None] + xx - 2 * dots
            elif metric == "ip":
                d = 1 - dots
            else:
                d = 1 - dots / torch.sqrt((qb * qb).sum(1)[:, None] * xx)
            v, p = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
            ds.append(v)
            ids.append(idx[p])
        cand_d.append(torch.cat(ds))
        cand_i.append(torch.cat(ids))
    d, i = torch.cat(cand_d, 1), torch.cat(cand_i, 1)
    v, p = torch.sort(d, dim=1, stable=True)
    kk = min(k, d.shape[1])
    return torch.gather(i, 1, p[:, :kk]).cpu().numpy(), v[:, :kk].cpu().numpy()


def run_control(cell: dict, seed: int, precision: str, device) -> dict:
    """The control's numbers on the cell's first ``check_calls`` batches of queries."""
    dev = torch.device(device)
    cfg, trf = cell["config"], cell["traffic"]
    n, dim, metric = int(cfg["rows"]), int(cfg["dim"]), cfg["metric"]
    k, m = int(trf["k"]), int(trf["check_calls"]) * int(trf["batch"])
    rows = data.host_array(seed, "rows", n, dim, dev)
    _, columns = data.metadata(cfg.get("metadata"), n)
    fspec = harness.filter_spec(trf, n)
    keep = reference.filter_mask(columns, fspec, n) if fspec else None
    qs = data.host_array(seed, "queries", m, dim, dev)
    qd = torch.from_numpy(qs).to(dev)
    got_rows, got_d = control_topk(data.device_chunks(seed, "rows", n, dim, dev), qd, k,
                                   metric, keep, MANTISSA[precision])
    answers = []
    for i in range(m):
        ans = []
        for r, d in zip(got_rows[i].tolist(), got_d[i].tolist()):
            score = np.float32(1.0) - np.float32(d) if metric == "cosine" else np.float32(d)
            ans.append({"id": r, "values": rows[r],
                        "metadata": {f: int(c[r]) for f, c in columns.items()},
                        "score": float(score)})
        answers.append(ans)
    ref_rows, ref_dist = reference.exact_topk(data.device_chunks(seed, "rows", n, dim, dev),
                                              qd, k, metric, keep)
    id_to_row = {r: r for r in range(n)}
    checks = judge.judge(answers, qs, id_to_row, rows, columns, keep, ref_rows, ref_dist, k,
                         metric, cfg["limits"])
    return {"control": precision, "correct": judge.passed(checks), "queries": m,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--precision", choices=sorted(MANTISSA), default="tf32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_control(spec.cell(args.workload), args.seed, args.precision, "cuda:0")
    out["seconds"] = time.time() - T_START
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

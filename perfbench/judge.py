"""The comparison that decides ``correct``: the program's answers to a sample of the
window's queries against the float64 reference.

Numbers compared, each against the limit that the configuration's file gives:

``missing``      queries of the sample answered with fewer than min(k, rows the filter
                 admits) results, or not answered (their call raised); exact, limit 0.
``foreign``      results that name no row the query may return: an id that the load did
                 not return, a row that the filter does not admit, or one row twice in
                 one answer; exact, limit 0.
``hydrate_bad``  results whose metadata or values are not those of the row their id
                 names; exact, limit 0.
``rank_gap``     the widest gap by which the row an answer puts at rank r lies beyond the
                 reference's r-th nearest, relative to that distance; 0 where each
                 answer is the exact top-k in order.
``dist_err``     the largest relative gap between a result's distance (from its score)
                 and the float64 distance of its row.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference import pair_distance64

CHECKS = ("missing", "foreign", "hydrate_bad", "rank_gap", "dist_err")
_TINY = 1e-6


def distance_of_score(score: float, metric: str) -> float:
    """The engine's distance from a user score: cosine scores are 1 - distance."""
    return 1.0 - score if metric == "cosine" else score


def judge(answers: Sequence[Optional[List[dict]]], queries: np.ndarray, id_to_row: dict,
          rows: np.ndarray, columns: Dict[str, np.ndarray], keep: Optional[np.ndarray],
          ref_rows: np.ndarray, ref_dist: np.ndarray, k: int, metric: str,
          limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value": v, "limit": l}} for each of ``CHECKS``, in that order.

    ``answers[i]``: the result dicts of query ``queries[i]`` (None: not answered);
    ``rows``/``columns``: the generated rows and metadata columns; ``keep``: the rows the filter
    admits (None: all); ``ref_rows``/``ref_dist``: the reference's top k."""
    m = len(answers)
    n_admit = int(keep.sum()) if keep is not None else rows.shape[0]
    expect = min(k, n_admit)
    missing = foreign = hydrate_bad = 0
    got_rows = np.full((m, expect), -1, np.int64)
    got_dist = np.full((m, expect), np.nan, np.float64)
    for i, ans in enumerate(answers):
        if ans is None:
            missing += 1
            continue
        seen = set()
        good = 0
        for r in ans:
            row = id_to_row.get(r.get("id"))
            if row is None or row in seen or (keep is not None and not keep[row]):
                foreign += 1
                continue
            seen.add(row)
            meta_want = {f: int(c[row]) for f, c in columns.items()}
            vals = np.asarray(r.get("values"), np.float32).reshape(-1)
            if r.get("metadata") != meta_want or not np.array_equal(vals, rows[row]):
                hydrate_bad += 1
            if good < expect:
                got_rows[i, good] = row
                got_dist[i, good] = distance_of_score(float(r["score"]), metric)
            good += 1
        if good < expect:
            missing += 1
    rank_gap = dist_err = 0.0
    have = got_rows >= 0
    if have.any():
        sel = np.where(have, got_rows, 0)
        d64 = pair_distance64(torch.from_numpy(rows[sel]), torch.from_numpy(queries),
                              metric).numpy()
        scale_ref = np.maximum(np.abs(ref_dist[:, :expect]), _TINY)
        gaps = np.where(have, (d64 - ref_dist[:, :expect]) / scale_ref, 0.0)
        rank_gap = float(max(0.0, gaps.max()))
        errs = np.where(have, np.abs(got_dist - d64) / np.maximum(np.abs(d64), _TINY), 0.0)
        dist_err = float(np.nan_to_num(errs, nan=np.inf).max())
    values = {"missing": missing, "foreign": foreign, "hydrate_bad": hydrate_bad,
              "rank_gap": rank_gap, "dist_err": dist_err}
    return {name: {"value": values[name], "limit": float(limits[name])} for name in CHECKS}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())

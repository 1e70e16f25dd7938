"""The float64 settle of the port's f32 top-k lists (ROADMAP C18).

Every exact path ends in a top-k over f32 distances: the certified rescan (kernel B2's
dots and norms, then ``qn + sqn - 2 q.x``), the row-major rescan, the tiled scan and the
sharded merge.  The l2 expansion cancels: its f32 error scales with |q|^2 + |x|^2, not
with the distance, so two rows whose float64 distances lie closer than that error can come
back in the wrong order, and at the k-th place a wrong order is a wrong set.  The JAX
package returns the f32 order; the port settles it:

  * ``f32_band`` bounds |f32 value - float64 value| of each formula (the band, epsilon);
  * ``settled_topk`` takes the ``kk + spare`` smallest f32 candidates, orders them by
    their float64 distances (``value64``, rows tied there by position) and returns the
    first kk with fl32 of those distances (non-decreasing, within half an ulp of float64),
    and per query the candidate width that covers the band where a candidate it left out
    could still beat the k-th (0: none could);
  * ``Settled`` keeps what settling a flagged query again at that width needs, and
    ``widen_host`` does so for a result already on the host, in one more copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .distances import MASKED

U = 2.0 ** -24        # f32 unit roundoff
EPS = 1e-30           # the f32 formulas' clamp of qn * sqn (cosine)
SPARE = 4             # candidates settled beyond the k
_LIVE = float(MASKED) / 2
# None, or a list that each settle appends (queries settled, those whose set or order the
# float64 settle changed against the f32 order, those flagged for a wider settle) to, the
# last two as device counts: a caller that watches (chip_smoke.py) sets it
TALLY = None


def f32_band(metric: str, qn, sqn, dp: int, qs=None):
    """Bound (broadcast of ``qn`` and ``sqn``, in their type) on |f32 value - float64
    value| of the metric's formula over f32 operands, each Dp-term sum in any order, with
    FMAs or without (B2's order, cuBLAS's in the scan, the CPU's):

      l2      qn + sqn - 2 q.x, clamped at 0     g (1 + g) (|q| + |x|)^2
      ip      1 - q.x                            g (1 + g) (1 + |q| |x|)
      cosine  1 - q.x rsqrt(max(qn sqn, EPS))    2 g (1 + g) max(1, |q_s| / |q|)

    with g = (Dp + 4) u / (1 - (Dp + 4) u), u = 2^-24, and 0 for ip and cosine where q = 0
    (every product is 0 and the value exactly 1).  A Dp-term sum errs by at most gamma_Dp
    = Dp u / (1 - Dp u) times the sum of its absolute terms (|q.x| <= |q| |x|), and g leaves
    4 u beyond it for the formula's own roundings: l2's two additions; cosine's product of
    norms, rsqrt (within 2 ulps on the card), product and subtraction, where the product
    and the norm terms each err by gamma_Dp.  The (1 + g) covers |q| and |x| read from
    f32 norms, and 2^-20 more the roundings of this bound in f32.  No error attains it.
    ``qn``: the f32 query norm the formula adds; ``sqn``: the row's; ``qs``: the squared
    norm of the query the product scores where that is a rounded copy (the bf16 row-major
    scan, ROADMAP C15), else None.  Holds for operands in f32's normal range and, for
    cosine, above the clamp."""
    qn = torch.as_tensor(qn)
    g = (dp + 4) * U / (1 - (dp + 4) * U)
    c = g * (1 + g) * (1 + 2.0 ** -20)
    a = torch.sqrt(qn if qs is None else torch.maximum(qn, qs))
    if metric == "l2":
        return c * (a + torch.sqrt(torch.as_tensor(sqn, device=qn.device))) ** 2
    if metric == "ip":
        return c * (a > 0) * (1 + a * torch.sqrt(torch.as_tensor(sqn, device=qn.device)))
    if metric != "cosine":
        raise ValueError(f"unknown metric {metric!r}")
    ratio = 1.0
    if qs is not None:
        ratio = torch.sqrt(qs / torch.clamp_min(qn, EPS)).clamp_min(1.0)
    return (2 * c) * (a > 0) * ratio * torch.ones_like(torch.as_tensor(sqn, device=qn.device))


def value64(q, x, qq, metric: str):
    """The metric's distance in float64: ``q`` [m, 1, Dp] the query the path scores,
    ``x`` [m, c, Dp] rows.  ``qq`` [m, 1]: None for l2 and ip where ``q`` is the query;
    else the squared norm of the query whose norm the formula adds (cosine: |q|^2; where
    ``q`` is a rounded copy, the unrounded query's, which JAX's scan of bf16 rows adds,
    ROADMAP C15; l2 then qq - |q|^2 + |x - q|^2, which cancels nothing).  [m, c]."""
    if metric == "l2":
        d = ((x - q) ** 2).sum(-1)
        return d if qq is None else torch.clamp_min(d + (qq - (q * q).sum(-1)), 0.0)
    dots = torch.matmul(x, q.transpose(1, 2))[..., 0]
    if metric == "ip":
        return 1.0 - dots
    return 1.0 - dots / torch.sqrt(torch.clamp_min(qq * (x * x).sum(-1), EPS))


def settled_topk(dist, rows, q, data, qn, sqn, *, kk: int, metric: str, spare: int = SPARE,
                 n_live=None, rest=None, q_full=None):
    """The ``kk`` nearest of the candidates ``dist`` [B, W] (f32 distances; ``rows`` [B, W]
    their rows of ``data``) in float64 order (ROADMAP C18).

    The first w = kk + ``spare`` candidates by f32 (ties by position) are widened to
    float64 (in pieces of 2^22 elements; a row past the store, a NaN pool entry's, read
    clamped as the rescan reads it) and ordered by ``value64`` to the query ``q`` [B, Dp]
    the path scores (``q_full``: the unrounded query where ``q`` is a rounded copy), rows
    tied in float64 by position; masked and NaN candidates keep their f32 values as keys,
    so they stay behind the live ones in their positions' order.  ``qn`` [B] or [B, 1]
    and ``sqn`` (the candidates' squared norms, broadcast to [B, W]): the f32 norms the
    band reads.  ``n_live``: rows past it hold row ``n_live``'s candidates
    (``_rescan_windows``), so they take its float64 distances, and none of them is
    flagged (they are the caller's padding, returned to no one).  ``rest``: (f32 floor
    [B], band [B]) of candidates outside ``dist`` (the scan's fold): each is >= the floor
    in f32.

    Returns ``(values [B, kk] f32, positions [B, kk], key [B, kk] float64, need [B]
    int32)``: values are fl32 of the keys; ``need`` is 0 where no candidate left out could
    beat the k-th (its f32 value minus its band not below the k-th float64 distance: the
    band is never attained, and where it is 0 the values are exact and a tie goes by
    position, which the f32 order kept), else a width of the f32 order that holds every
    one that could (W + 1 where ``rest`` could)."""
    B, W = dist.shape
    dp = data.shape[1]
    sv, order = torch.sort(dist, dim=1, stable=True)
    w = min(kk + spare, W)
    pos_w = order[:, :w]
    m = B if n_live is None else min(B, n_live + 1)
    idx = torch.clamp(torch.gather(rows[:m], 1, pos_w[:m]).long(), 0, data.shape[0] - 1)
    q64 = q[:m, None, :].double()
    qq = None
    if q_full is not None or metric == "cosine":
        qq = (((q if q_full is None else q_full)[:m, None, :].double()) ** 2).sum(-1)
    step = max(1, (1 << 22) // (m * dp))
    d64 = torch.cat([value64(q64, data[idx[:, c:c + step]].double(), qq, metric)
                     for c in range(0, w, step)], dim=1) if w > step else value64(
        q64, data[idx].double(), qq, metric)
    if m < B:
        d64 = torch.cat([d64, d64[m - 1:].expand(B - m, w)])
    svw = sv[:, :w]
    key = torch.where(svw < _LIVE, d64, svw.double())
    pos_sorted, perm = torch.sort(pos_w, dim=1)            # by position, then stably by key
    key_p = torch.gather(key, 1, perm)
    by = torch.sort(key_p, dim=1, stable=True).indices[:, :kk]
    key_k = torch.gather(key_p, 1, by)
    pos_k = torch.gather(pos_sorted, 1, by)
    need = torch.zeros(B, dtype=torch.int32, device=dist.device)
    if w < W or rest is not None:
        kth = key_k[:, kk - 1]
        kth = kth.masked_fill(kth >= _LIVE, -float("inf"))   # masked or NaN: none can beat it
        qs = None if q_full is None else (q.float() ** 2).sum(-1, keepdim=True)
        if w < W:                  # a masked or NaN candidate's lower bound is never below
            sq_out = torch.gather(torch.as_tensor(sqn, device=dist.device).expand(B, W), 1,
                                  order[:, w:])
            lower = sv[:, w:].double() - f32_band(metric, qn.reshape(B, 1), sq_out, dp, qs)
            span = torch.arange(w + 1, W + 1, dtype=torch.int32, device=dist.device)
            need = torch.where(lower < kth[:, None], span, 0).amax(1)
        if rest is not None:
            floor, band = rest
            need = torch.where(floor.double() - band < kth, W + 1, need)
        if n_live is not None:
            need[n_live:] = 0
    if TALLY is not None:
        n = B if n_live is None else min(B, n_live)
        TALLY.append((n, (pos_k[:n] != order[:n, :kk]).any(1).sum(), (need[:n] > 0).sum()))
    return key_k.float(), pos_k, key_k, need


def pad_k(dist, idx, key, k: int):
    """A [B, kk] result padded to k columns with masked slots (idx 0), key included."""
    pad = k - dist.shape[1]
    if pad <= 0:
        return dist, idx, key
    B = dist.shape[0]
    return (torch.cat([dist, dist.new_full((B, pad), float(MASKED))], dim=1),
            torch.cat([idx, idx.new_zeros((B, pad))], dim=1),
            torch.cat([key, key.new_full((B, pad), float(MASKED))], dim=1))


class Settled:
    """A settled top-k (``settled_topk``) padded to k columns: ``dist``, ``idx`` (the
    candidates' rows) and ``key`` (float64) [B, k], ``need`` [B], and what settling its
    flagged queries again at a wider width needs (the candidates stay referenced)."""

    def __init__(self, dist, rows, q, data, qn, sqn, *, kk: int, k: int, metric: str,
                 n_live=None):
        self._src = (dist, rows, q, data, qn.reshape(-1, 1), sqn)
        self.kk, self.k, self.metric = kk, k, metric
        v, p, key, self.need = settled_topk(dist, rows, q, data, qn, sqn, kk=kk,
                                            metric=metric, n_live=n_live)
        self.dist, self.idx, self.key = pad_k(v, torch.gather(rows, 1, p), key, k)

    def widen(self, sel, width: int):
        """Device (dist, idx, key) of the queries ``sel`` (host row numbers) settled over
        their first ``width`` candidates in f32 order: a width their ``need`` covers, so
        none of them is flagged after it."""
        dist, rows, q, data, qn, sqn = self._src
        s = torch.as_tensor(np.asarray(sel), dtype=torch.long, device=dist.device)
        v, p, key, _ = settled_topk(dist[s], rows[s], q[s], data, qn[s], sqn[s], kk=self.kk,
                                    metric=self.metric, spare=max(width - self.kk, 0))
        return pad_k(v, torch.gather(rows[s], 1, p), key, self.k)

    def resolve(self):
        """Device (dist, idx, key) with every flagged query settled again at its width:
        reads ``need`` on the host (a caller without a packed download of its own)."""
        need = self.need.cpu().numpy()
        if not need.any():
            return self.dist, self.idx, self.key
        sel = np.flatnonzero(need)
        d, i, key = self.widen(sel, int(need[sel].max()))
        s = torch.as_tensor(sel, dtype=torch.long, device=self.dist.device)
        return (self.dist.index_copy(0, s, d), self.idx.index_copy(0, s, i),
                self.key.index_copy(0, s, key))


def widen_host(host, need, groups, fetch_):
    """Settle the flagged queries of a result already on the host again, in ONE more copy
    through ``fetch_``: ``host`` the fetched [dist, idx] or [dist, idx, key] numpy arrays
    (written in place and returned), ``need`` their fetched widths, ``groups`` a list of
    (``Settled``, result rows, its own rows) naming which ``Settled`` holds each row."""
    parts, spots = [], []
    for st, rows_g, local in groups:
        flagged = need[rows_g] > 0
        if not flagged.any():
            continue
        width = int(need[rows_g][flagged].max())
        d, i, key = st.widen(local[flagged], width)
        parts += [d, i] + ([key] if len(host) > 2 else [])
        spots.append(rows_g[flagged])
    if not parts:
        return host
    got = fetch_(*parts)
    n = len(host)
    for j, at in enumerate(spots):
        for a in range(n):
            host[a][at] = got[n * j + a]
    return host

"""Peaks of the card and the work that a phase-1 operation needs.

The counts are of the operation, never of an implementation: the operand read once at
its stored type, the queries read once, the top k written once (an index and a
distance, 4 bytes each), and 2 * rows * D * queries products, over only the rows a query
may return.  A redesign that makes fewer passes over the data therefore moves the
share, not its yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), the data sheet's dense rates at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
TENSOR_PEAK = {
    "float32": 989e12,   # f32 operands: the bf16 tensor-core rate, as HIGHEST's passes run
    "bfloat16": 989e12,
    "int8": 1979e12,
}
ITEM_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
# a top-k entry: an int32 index beside a float32 distance
TOPK_ENTRY_BYTES = 8


def phase1_work(rows: int, dim: int, queries: int, k: int, operand: str):
    """(products as operations, bytes) of one phase-1 pass: ``rows`` stored rows of
    ``dim`` elements of type ``operand`` against ``queries`` float32 queries."""
    ops = 2.0 * rows * dim * queries
    nbytes = (rows * dim * ITEM_BYTES[operand] + queries * dim * 4
              + queries * k * TOPK_ENTRY_BYTES)
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, operand: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / TENSOR_PEAK[operand], nbytes / HBM_BYTES_PER_S)


def share_pct(ops: float, nbytes: float, operand: str, seconds: float) -> float:
    """The bound's share of a measured time, in per cent."""
    return 100.0 * bound_seconds(ops, nbytes, operand) / seconds


def kernel_share(ctx, patterns, operand: str):
    """A kernel's share of its roofline in a traced run, in per cent: its device time per
    launch (kernels whose name holds one of ``patterns``) against the bound of one call's
    phase-1 work, over the rows a query may return (``ctx.rows_admitted``) and the call's
    queries; None where the trace holds no such launch."""
    t = ctx.trace
    if t is None:
        return None
    seconds = launches = 0
    for name, (s, n) in t["kernels"].items():
        if any(p in name for p in patterns):
            seconds += s
            launches += n
    if not launches or seconds <= 0:
        return None
    ops, nbytes = phase1_work(ctx.rows_admitted, int(ctx.config["dim"]),
                              int(ctx.traffic["batch"]), int(ctx.traffic["k"]), operand)
    return share_pct(ops, nbytes, operand, seconds / launches)

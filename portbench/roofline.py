"""Peaks of the card and the least work of the kernels the benchmark rates.

Every count here is the benchmark's own, from shapes alone: items,
branches, states, branch groups, patterns, the children of each node, the
classes folded together, the item size.  Nothing is read from the program
(no Taylor term count, no padding, no launch plan).  A roofline share is
the least time the card could take for that work, the larger of its
operations over the peak rate and its bytes over the peak bandwidth,
divided by the time measured, in percent.  Being a least count, it can only
read low: a share above 100% means the count or the time is wrong.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}   # fp32 non-tensor; fp64 tensor core
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, dtype: str = "float32") -> Tuple[float, str]:
    """(the least time, what bounds it: "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def level_products(children: Sequence[int], patterns: int, states: int, classes: int = 1,
                   itemsize: int = 4) -> Dict[str, float]:
    """K1, the level products of one gene pruning: for each internal node
    with ``c`` children and each of the ``classes`` folded together, ``c``
    products of a ``states x states`` propagator with a ``states x
    patterns`` block of child vectors (``2 c patterns states^2``
    operations), each child vector and propagator read once and the node's
    vector written once."""
    edges = sum(children)
    flops = 2.0 * classes * edges * patterns * states * states
    nbytes = itemsize * classes * (edges * patterns * states          # child vectors in
                                   + len(children) * patterns * states  # node vectors out
                                   + edges * states * states)          # propagators in
    return {"flops": flops, "bytes": nbytes}


def site_objective(items: int, branches: int, groups: int, states: int, taxa: int,
                   itemsize: int = 4) -> Dict[str, float]:
    """One batched per-site evaluation (K4): for each item, every branch's
    propagator applied once to the vector below it (one ``states x states``
    matrix-vector product, ``2 states^2`` operations, whatever way the
    propagator is formed) and, per branch group, the one ``states^3``
    matrix product that any function of the item's generator costs at
    least (``2 states^3``).  Bytes: each item's leaf states read once as
    2-byte codes, its lnL written once."""
    flops = items * (2.0 * branches * states * states + 2.0 * groups * states ** 3)
    nbytes = items * (2 * taxa + itemsize)
    return {"flops": flops, "bytes": nbytes}


def share(count: Dict[str, float], seconds: float, dtype: str = "float32") -> float:
    """Percent of the roofline that ``seconds`` reach for ``count``."""
    least, _ = least_seconds(count["flops"], count["bytes"], dtype)
    return 100.0 * least / seconds

"""Do the host Eq.-7 rows change bits with the width they are padded to?

    PYTHONPATH=src python tools/touched_probs_width.py [--n 100000] [--m 3]

``transition.mh_importance_rows_ragged`` builds every row at the graph's
max degree, and its float64 row sums are numpy's pairwise sums, whose
association depends on the row's length.  After a churn that moves the
max degree, ``WalkEngine.apply_churn`` keeps the untouched rows' CDF
segments, built from rows at the old width, beside touched rows built at
the new one; ``ragged_edge_cdf(new_graph)`` from a fresh
``mh_importance_rows_ragged(new_graph)`` equals that patch only where the
float32 rows do not depend on the width.  This builds BA(n, m) (seed 0)
with Lipschitz ``exp(N(0,1))`` from seed 5 (the churn sweep's), computes
every row at the max degree and at wider widths (and the rows that fit at
narrower ones), and prints one JSON line: the entries that differ from the
max-degree build at each width.  Host numpy only, about a minute at n=100k.
"""
import argparse
import json
import time

import numpy as np

from repro_torch.core.graphs import (
    _pad_neighbor_lists,
    barabasi_albert,
    flat_edge_values,
)
from repro_torch.core.transition import _mh_rows_block


def rows_at(g, lips, ids, width) -> np.ndarray:
    """The flat Eq.-7 rows of ``ids`` padded to ``width`` before the block
    math, pads dropped."""
    deg = np.asarray(g.degrees, np.int64)
    nbrs = _pad_neighbor_lists(g.indptr, g.indices, deg, node_ids=ids,
                               width=width)
    block = _mh_rows_block(nbrs, ids, deg[ids], deg, lips)
    return flat_edge_values(g.indptr, deg, block, node_ids=ids)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=10_000)
    args = ap.parse_args()
    t0 = time.perf_counter()
    g = barabasi_albert(args.n, args.m, seed=0, layout="ragged")
    lips = np.exp(np.random.default_rng(5).normal(0.0, 1.0, g.n))
    deg = np.asarray(g.degrees, np.int64)
    top = g.max_degree
    widths = [top - 100, top - 1, top + 1, top + 8, top + 100, 2 * top]
    differ = {w: 0 for w in widths}
    compared = {w: 0 for w in widths}
    for a in range(0, g.n, args.chunk):
        ids = np.arange(a, min(g.n, a + args.chunk), dtype=np.int64)
        base = rows_at(g, lips, ids, top).view(np.int32)
        for w in widths:
            fit = ids[deg[ids] <= w]  # rows a narrower width can hold
            if fit.size == 0:
                continue
            got = rows_at(g, lips, fit, w).view(np.int32)
            pos = np.isin(np.repeat(ids, deg[ids]), fit)
            differ[w] += int((got != base[pos]).sum())
            compared[w] += int(got.size)
    print(json.dumps({
        "graph": f"BA({args.n},{args.m})", "max_degree": top,
        "nnz": int(g.num_edges),
        "entries_compared": {str(w): compared[w] for w in widths},
        "entries_differing": {str(w): differ[w] for w in widths},
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()

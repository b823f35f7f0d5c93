"""Fig. 6 (``repro_torch.paper.fig6_annealing``) at a given tier on the
reference's uniform blocks, beside the reference's own run, on the CPU.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tools/fig6_on_reference_blocks.py [--quick]

Draws each training call's blocks as the reference's fleet does
(``tests/test_torch_paper.py::ReferenceBlocks``), runs the port's figure
on them, runs ``benchmarks/fig6_annealing.py`` itself, and prints both
``annealed_vs_const`` values and the tail MSEs as one JSON line.  A
one-off check that the port's Fig. 6 equals the reference's on the
reference's stream at the tier asked for; it needs both packages.
"""
import argparse
import json
import time

import torch

from benchmarks import fig6_annealing as ref_fig6
from repro_torch.paper import fig6_annealing
from test_torch_paper import ReferenceBlocks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    def pick(out):
        return {"const_pj_tail_mse": out["const_pj_tail_mse"],
                "annealed_tail_mse": out["annealed_tail_mse"],
                "annealed_vs_const": out["derived"]["annealed_vs_const"]}

    t0 = time.perf_counter()
    port = fig6_annealing.run(quick=args.quick, device="cpu",
                              blocks=ReferenceBlocks())
    t1 = time.perf_counter()
    ref = ref_fig6.run(quick=args.quick)
    t2 = time.perf_counter()
    print(json.dumps({
        "tier": "quick" if args.quick else "full",
        "port_on_reference_blocks": pick(port),
        "reference": pick(ref),
        "port_s": t1 - t0, "reference_s": t2 - t1,
    }))


if __name__ == "__main__":
    main()

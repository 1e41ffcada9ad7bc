"""A/B of the port's two high-precision solves on the step benchmark, in
pairs on one CUDA GPU.

    python -m fenapack_tpu_torch.ir_ab [--level 2] [--pairs 10]

The two modes of :func:`bench.ir_modes`: the benchmark's solver as it is
(one f64 FGMRES round per linear solve, ``krylov.hi_krylov``) and in the
JAX bench's ``BENCH_HIK=0`` mode (``bench.IR_ROUNDS``: rounds of f32 FGMRES
to 2e-6 on the f64 true residual, GCRO-DR 16, cap 120).  After one warm-up
solve of each, it times ``--pairs`` pairs of full Picard + Anderson(6)
solves, the order of the two alternating from pair to pair, each solve
between ``torch.cuda.synchronize()`` calls.  Prints the card's name and
power limit, one line per pair, and a last JSON line with both modes'
walls, medians, quartiles, counts and rounds, and the number of pairs each
mode won.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import bench


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B measures a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    solves = bench.ir_modes(args.level, device=torch.device("cuda:0"))

    walls = {m: [] for m in solves}
    runs = {}
    wins = {m: 0 for m in solves}
    for i in range(args.pairs):
        order = list(solves) if i % 2 == 0 else list(solves)[::-1]
        pair = {}
        for mode in order:
            _, full, w0 = solves[mode]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = full(w0)
            torch.cuda.synchronize()
            pair[mode] = time.perf_counter() - t0
            walls[mode].append(pair[mode])
            runs[mode] = r
            if not (r.converged and max(r.lin_rel) <= bench.RTOL_LIN):
                raise RuntimeError(f"{mode}: the solve failed its tolerances")
        wins[min(pair, key=pair.get)] += 1
        print(f"pair {i} ({order[0]} first): " + ", ".join(
            f"{m} {pair[m]} s" for m in order), flush=True)

    out = {"level": args.level, "pairs": args.pairs, "wins": wins}
    for mode, w in walls.items():
        r = runs[mode]
        q1, med, q3 = (float(v) for v in np.percentile(w, [25, 50, 75]))
        out[mode] = {"walls_s": w, "median_s": med, "quartiles_s": [q1, q3],
                     "iters": r.iters, "total": int(sum(r.iters)),
                     "rounds": r.rounds, "host_syncs": r.host_syncs,
                     "median_ms_per_iter": med * 1e3 / sum(r.iters)}
    out["median_ratio_rounds_over_hi_krylov"] = (
        out["rounds"]["median_s"] / out["hi_krylov"]["median_s"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

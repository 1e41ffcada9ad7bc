#!/usr/bin/env python3
"""Device times of the ELL products of ``fenapack_tpu_torch`` at the shapes
of the level-4 lid-driven cavity, for one checkout or for two in turns.

    python scripts/torch_ell_times.py                  # this checkout
    python scripts/torch_ell_times.py --parent DIR     # DIR, this, this, DIR

One process per turn, all on the one CUDA GPU of the machine, so two
versions of the kernels are compared on one card within one run.  Each turn
prints one JSON line; with ``--parent`` a last line holds, per product, the
times of the four turns in order.

Per turn, with the L2 flushed before every call (``measure.device_ms``) and
per call from Python over back-to-back calls (``measure.cuda_ms``):

  * the single product ``ELL.mv`` on the velocity operator A1 of level 4
    (66,049 rows, K = 19) in f64 and f32, on A1 of level 2 (4,225 rows) and
    on the pressure operator Ap of level 4 (16,641 rows, K = 7) in f64;
  * the Newton velocity matvec ``y_a = A1 x_a + sum_b R_ab x_b`` of levels
    4, 3 and 2 in f64, composed from six single products, four additions
    and a concatenation, and, where the checkout has it, as one block
    product (``ell_block_spmv``), beside the bound of the whole product and
    the time of a ``torch.sum`` that streams as many bytes.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one_turn(root: str, tag: str) -> dict:
    sys.path[0] = root                      # the checkout under test
    import torch
    from fenapack_tpu_torch import cavity, cavity_mesh, measure
    from fenapack_tpu_torch.ops import ell_spmv
    from fenapack_tpu_torch.ops.sparse import ELL
    from fenapack_tpu_torch.solvers import gmg
    if not torch.cuda.is_available():
        raise RuntimeError("the times are device measurements: no CUDA GPU")
    dev = torch.device("cuda")
    hier = gmg.build_hierarchy(cavity_mesh(0), cavity.LEVEL)
    nl = cavity.build(cavity.LEVEL, cavity.RE[0], device=dev, hier=hier)
    ops = {name: (pat, vals) for name, pat, vals in cavity.ell_operators(nl)}
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tag": tag, "root": root, "single": {}, "matvec": {}}

    for name, dt in (("A1 velocity level 4", torch.float64),
                     ("A1 velocity level 4", torch.float32),
                     ("A1 velocity level 2", torch.float64),
                     ("Ap pressure level 4", torch.float64)):
        pat, vals = ops[name]
        op = ELL(pat.cols, vals.to(dt).contiguous(), pat.n_cols)
        x = torch.randn(pat.n_cols, dtype=dt, device=dev, generator=gen)
        fn = lambda: op.mv(x)
        bound_ms, _ = measure.bound(measure.ell_bytes(op.vals, pat.n_cols),
                                    2 * op.vals.numel(), dt)
        key = f"{name} {'f64' if dt == torch.float64 else 'f32'}"
        out["single"][key] = {
            "rows": pat.n_rows, "K": pat.K,
            "device_ms": measure.device_ms(fn), "ms": measure.cuda_ms(fn),
            "bound_ms": bound_ms}

    block = getattr(ell_spmv, "ell_block_spmv", None)
    for level in (4, 3, 2):
        pat, A1 = ops[f"A1 velocity level {level}"]
        R = torch.stack([ops[f"R{a}{b} velocity level {level}"][1]
                         for a in range(2) for b in range(2)]
                        ).reshape((2, 2) + tuple(A1.shape)).contiguous()
        n = pat.n_cols
        x = torch.randn(2, n, dtype=A1.dtype, device=dev, generator=gen)
        A1m = ELL(pat.cols, A1, n)
        Rm = [[ELL(pat.cols, R[a, b], n) for b in range(2)] for a in range(2)]

        def composed():
            ys = [A1m.mv(x[a]) for a in range(2)]
            for a in range(2):
                for b in range(2):
                    ys[a] = ys[a] + Rm[a][b].mv(x[b])
            return torch.cat(ys)
        isz = A1.element_size()
        nbytes = A1.numel() * (4 + 5 * isz) + 2 * 2 * n * isz
        rec = {"rows": pat.n_rows, "K": pat.K,
               "composed_device_ms": measure.device_ms(composed),
               "composed_ms": measure.cuda_ms(composed),
               "bound_ms": measure.bound(nbytes, 2 * A1.numel() * 6,
                                         A1.dtype)[0]}
        # yardstick of the method: a reduction that streams as many bytes
        stream = torch.zeros(nbytes // 8, dtype=torch.float64, device=dev)
        rec["sum_of_same_bytes_device_ms"] = measure.device_ms(stream.sum)
        if block is not None:
            fn = lambda: block(pat.cols, A1, R, x, n)
            err = float((fn().reshape(-1) - composed()).abs().max())
            rec.update(block_device_ms=measure.device_ms(fn),
                       block_ms=measure.cuda_ms(fn),
                       block_vs_composed_max_abs=err)
        out["matvec"][f"level {level}"] = rec
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout to time in turns "
                    "with this one: parent, this, this, parent")
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.parent:
        print(json.dumps(one_turn(os.path.abspath(args.root), args.tag)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    turns = []
    for tag, root in (("parent", args.parent), ("this", args.root),
                      ("this", args.root), ("parent", args.parent)):
        turn = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root",
             os.path.abspath(root), "--tag", tag], capture_output=True,
            text=True, timeout=900)
        if turn.returncode != 0:
            sys.stderr.write(turn.stderr[-4000:])
            raise RuntimeError(f"the {tag} turn failed ({turn.returncode})")
        line = turn.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    summary = {"card": smi, "order": [t["tag"] for t in turns]}
    for group in ("single", "matvec"):
        for key in turns[1][group]:
            for field, v in turns[1][group][key].items():
                if field.endswith("ms"):
                    summary[f"{key}: {field}"] = [
                        t[group][key].get(field) for t in turns]
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

"""A/B of the BSR kernels K1/K2 (``bsr_spmv``) of this checkout against
another version of ``csrc/bsr_spmv.cu`` that takes dense 32 x 32 tiles, in
turns on one CUDA GPU, at every BSR operator the step's main path applies.

    python -m fenapack_tpu_torch.bsr_ab --parent FILE [--levels 2 4]
        [--pairs 2]

``FILE`` is the other version's ``bsr_spmv.cu`` (for example the parent
commit's, from ``git show <commit>:fenapack_tpu_torch/csrc/bsr_spmv.cu``);
it is built with this checkout's nvcc flags into ``build/ab/`` and called
through its C entry point ``bsr_spmv_<dtype>(nbr, tiles, x, y, b, m,
n_rows, n_cols, nrhs, stream)`` on the dense tiles of each operator
(``ops.bsr_spmv.dense``: the same entries).  For each level the main path
is built (``bench.build``), and for every operator of
:func:`path_operators` the two versions are first held against the plain
version (1e-12 in f64, 1e-5 in f32), then timed ``--pairs`` times in the
order other, this, this, other: device time with the L2 flushed before
each call (``measure.device_ms``) and per call from Python, back to back
(``measure.cuda_ms``: an operator under the 50 MB L2 stays there).  Beside
them, once: the plain version and cuSPARSE's BSR (of the dense tiles) and
CSR products (``library_*``), and the bounds: the packed slots' bytes
(``bound_ms``), the dense tiles' (``bound_dense_ms``) and the entries'
(``bound_entries_ms``: value + 4 B a nonzero, the benchmark's yardstick).
Prints the card's name and power limit, one JSON line per operator (with
its nonzeros, slots and their fill) and a last line of the ratios.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from . import bench, measure
from .ops import bsr_spmv, kernels

_BUILD = os.path.join(os.path.dirname(kernels._BUILD), "ab")


def path_operators(nl):
    """Every BSR operator the main path ``nl`` (``bench.build``) applies,
    ``[(name, BlockELL)]``, with the values it applies at the initial
    state."""
    from .solvers import gmg
    o, asm = nl.oseen, nl.asm
    w0 = nl.initial_state().to(torch.float64)
    wind = w0[:nl.n_u]
    A1h, _ = o._operator_values_raw(wind, hi=True)
    A1, _ = o._operator_values(wind.to(o.dtype))
    kp = asm.kp_values(wind.to(o.dtype), surface=True).to(o.dtype)
    vh, ph = o.velocity_hierarchy, o.ap_hierarchy
    lv = [v for v, _ in gmg.velocity_gmg_values(
        vh, wind.to(o.dtype), o.bc_mask_u, o.dtype,
        fine_values=(A1, None))["levels"]]
    ops = [("A1 fine (f64)", asm.pat_p2_hi.matrix(A1h)),
           ("DT fine (f64)", asm.const_hi.DT[0]),
           ("D fine (f64)", asm.const_hi.D[0]),
           ("Bt (f32)", asm.const.DT[0]), ("D (f32)", asm.const.D[0]),
           ("Mp", asm.const.Mp), ("Kp", asm.pat_p1.matrix(kp))]
    ops += [(f"A1 velocity level {l}", a.pat_p2.matrix(v))
            for l, (a, v) in enumerate(zip(vh.asms, lv))]
    ops += [(f"Ap pressure level {l}", lev.Ap)
            for l, lev in enumerate(ph.levels)]
    for name, transfers in (("P2", vh.transfers), ("P1", ph.transfers)):
        for l, t in enumerate(transfers):
            ops += [(f"{name} prolong {l}->{l + 1}", t._P),
                    (f"{name} restrict {l + 1}->{l}", t._PT)]
    return ops


def load_other(source: str):
    """``call(nbr, tiles, x, n_rows, n_cols) -> y``: the product of another
    ``bsr_spmv.cu`` on dense tiles, built into ``build/ab/``."""
    os.makedirs(_BUILD, exist_ok=True)
    lib_path = os.path.join(_BUILD, "libbsr_spmv_other.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, source, "-o",
                    lib_path], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    fns = {}
    for name in ("f32", "f64"):
        fn = getattr(lib, f"bsr_spmv_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fns[name] = fn

    def call(nbr, tiles, x, n_rows, n_cols):
        _, b, mb = tiles.shape
        y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        k = 1 if x.dim() == 1 else x.shape[1]
        rc = fns[bsr_spmv._NAMES[tiles.dtype]](
            nbr.data_ptr(), tiles.data_ptr(), x.data_ptr(), y.data_ptr(), b,
            mb // b, n_rows, n_cols, k,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other BSR product failed: CUDA error "
                               f"{rc}")
        return y
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other version's csrc/bsr_spmv.cu")
    ap.add_argument("--levels", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B measures a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    other = load_other(args.parent)
    rng = np.random.default_rng(0)
    ratios = {}
    for level in args.levels:
        nl = bench.build(level, device=dev)
        for name, op in path_operators(nl):
            name = f"l{level} {name}"
            dt = op.tiles.dtype
            nbr_d, tiles_d = bsr_spmv.dense(op.nbr, op.tiles)
            x = torch.as_tensor(rng.standard_normal(op.n_cols), dtype=dt,
                                device=dev)
            this = lambda: bsr_spmv.bsr_spmv(op.nbr, op.tiles, x, op.n_rows,
                                             op.n_cols)
            that = lambda: other(nbr_d, tiles_d, x, op.n_rows, op.n_cols)
            plain = lambda: bsr_spmv.bsr_spmv_plain(op.nbr, op.tiles, x,
                                                    op.n_rows, op.n_cols)
            ref = plain()
            tol = 1e-12 if dt == torch.float64 else 1e-5
            scale = max(float(ref.abs().max()), 1e-300)
            errs = {k: float((fn() - ref).abs().max()) / scale
                    for k, fn in (("this", this), ("other", that))}
            if max(errs.values()) > tol:
                raise RuntimeError(f"{name}: a version disagrees with plain "
                                   f"{errs} (tol {tol})")
            turns = {"device_ms": [], "ms": []}
            order = []
            for _ in range(args.pairs):
                for tag, fn in (("other", that), ("this", this),
                                ("this", this), ("other", that)):
                    order.append(tag)
                    turns["device_ms"].append(measure.device_ms(fn))
                    turns["ms"].append(measure.cuda_ms(fn))
            mean = {f"{tag} {k}": float(np.mean(
                [t for o, t in zip(order, v) if o == tag]))
                for k, v in turns.items() for tag in ("other", "this")}
            isz = op.tiles.element_size()
            vec = (op.n_rows + op.n_cols) * isz
            slots = bsr_spmv.slots(op.nbr, op.tiles.shape[1],
                                   op.tiles.shape[2])
            nnz = op.nnz if op.nnz is not None else int(
                torch.count_nonzero(op.tiles))
            lib = {}
            for key, build in (("bsr", measure.bsr_library(op)),
                               ("csr", measure.bsr_csr_library(op))):
                call, why = measure.library(build, x)
                lib[f"library_{key}_device_ms"] = (
                    measure.device_ms(call) if call else None)
                lib[f"library_{key}_ms"] = (measure.cuda_ms(call) if call
                                            else None)
                lib[f"library_{key}_why"] = why or "taken"
            rec = {"case": name, "dtype": bsr_spmv._NAMES[dt],
                   "shape": [op.n_rows, op.n_cols],
                   "packed": list(op.tiles.shape),
                   "dense": list(tiles_d.shape), "nnz": nnz,
                   "slots": slots, "fill": slots / nnz,
                   "tile_fill": tiles_d.numel() / nnz,
                   "max_rel_err": errs, "order": order, **turns, **mean,
                   "this / other device": mean["this device_ms"]
                   / mean["other device_ms"],
                   "plain_device_ms": measure.device_ms(plain),
                   "plain_ms": measure.cuda_ms(plain), **lib,
                   "bound_ms": measure.bound(measure.bsr_bytes(
                       op.nbr, op.tiles, op.n_rows, op.n_cols), 0, dt)[0],
                   "bound_dense_ms": measure.bound(
                       tiles_d.numel() * isz + nbr_d.numel() * 4 + vec, 0,
                       dt)[0],
                   "bound_entries_ms": measure.bound(
                       nnz * (isz + 4) + vec, 2 * nnz, dt)[0]}
            ratios[name] = rec["this / other device"]
            print(json.dumps(rec), flush=True)
            del nbr_d, tiles_d
        del nl
        torch.cuda.empty_cache()
    print(json.dumps({"this / other device": ratios,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()

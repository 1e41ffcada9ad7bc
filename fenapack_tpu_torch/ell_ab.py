"""A/B of the K3 block product (``ell_block_spmv``) of this checkout
against another version of ``csrc/ell_spmv.cu``, in turns on one CUDA GPU,
at the velocity blocks the main paths apply.

    python -m fenapack_tpu_torch.ell_ab --parent FILE [--pairs 2]

``FILE`` is the other version's ``ell_spmv.cu`` (for example the parent
commit's, from ``git show <commit>:fenapack_tpu_torch/csrc/ell_spmv.cu``);
it is built with this checkout's nvcc flags into ``build/ab/`` and called
through its own C entry point, whose block product takes no row lengths
when its signature is the one before them.  The cases (patterns of the
model entry points' meshes, seeded random values on the pattern's own
slots, f64 unless named):

  * ``s3``: config 4's fine velocity level (``StepFlow3D`` level 3, length
    3: 242,913 rows, K = 85), d = 3, without and with R, and in f32
    without R;
  * ``cavity l4``: the lid-driven cavity's fine level (66,049 x 19), d = 2,
    with R (Newton), in f64 and f32;
  * ``cylinder l2``: the DFG cylinder's fine level (145,672 rows), d = 2,
    with and without R, and with R in f32;
  * ``config 5 l2``: the step's fine level at level 2 (11,524 rows), d = 2,
    without R (the SUPG-stabilized A1);
  * ``rank-local``: rank 0's rows of that level among 4 (2,881 rows over
    the 11,524 global columns), without R and without row lengths, as the
    ring and GSPMD paths call it.

Each case first holds both versions against the plain version (1e-12 in
f64, 1e-5 in f32), then times them ``--pairs`` times in the order other,
this, this, other: device time with the L2 flushed before each call
(``measure.device_ms``) and per call from Python (``measure.cuda_ms``).
Prints the card's name and power limit, one JSON line per case (the times
in turn order, their means, this / other, the padded and the entries-only
bound), and a last JSON line of the ratios.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from . import measure
from .fem.dofmap import TaylorHood
from .models import CylinderChannel2D, LidDrivenCavity, StepFlow2D, \
    StepFlow3D
from .ops import ell_spmv, kernels
from .ops.sparse import pattern_from_dofmaps

_BUILD = os.path.join(os.path.dirname(kernels._BUILD), "ab")
_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def load_other(source: str):
    """``call(cols, A1, R, x, y0, row_len) -> y``: the block product of
    another ``ell_spmv.cu``, built into ``build/ab/``.  Its C entry takes a
    row-length pointer when its source names one (this version's
    signature), else none, and the lengths are not passed."""
    os.makedirs(_BUILD, exist_ok=True)
    lib_path = os.path.join(_BUILD, "libell_spmv_other.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, source, "-o",
                    lib_path], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    with open(source) as f:
        takes_lengths = "const void* row_len" in f.read()
    n_ptr = 7 if takes_lengths else 6
    fns = {}
    for name in ("f32", "f64"):
        fn = getattr(lib, f"ell_block_spmv_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fns[name] = fn

    def call(cols, A1, R, x, y0=None, row_len=None):
        (n_rows, K), d = cols.shape, x.shape[0]
        y = torch.empty((d, n_rows), dtype=x.dtype, device=x.device)
        ptr = lambda t: None if t is None else t.data_ptr()
        ptrs = [cols.data_ptr(), A1.data_ptr(), ptr(R), x.data_ptr(),
                ptr(y0), y.data_ptr()]
        if takes_lengths:
            ptrs.append(ptr(row_len))
        rc = fns[_NAMES[A1.dtype]](
            *ptrs, n_rows, K, x.shape[1], d,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other block product failed: CUDA error "
                               f"{rc}")
        return y
    return call


def _p2_pattern(problem, dev):
    V = TaylorHood(problem.mesh()).V
    cd = V.cell_dofs
    return pattern_from_dofmaps(cd, cd, V.dim, V.dim, device=dev)


def cases(dev):
    """``[(name, n_cols, cols, row_len, d, with_R, dtype, live)]``:
    ``row_len`` passed to the product (None: none), ``live`` each row's
    entry count (the slots that get values)."""
    s3 = _p2_pattern(StepFlow3D(level=3, length=3.0, device=str(dev)), dev)
    cav = _p2_pattern(LidDrivenCavity(level=4, device=str(dev)), dev)
    cyl = _p2_pattern(CylinderChannel2D(level=2, device=str(dev)), dev)
    c5 = _p2_pattern(StepFlow2D(level=2, device=str(dev)), dev)
    rank_rows = c5.n_rows // 4
    f64, f32 = torch.float64, torch.float32
    out = [("s3 A1 fine d3", s3, 3, False, f64),
           ("s3 A1 + R fine d3", s3, 3, True, f64),
           ("s3 A1 fine d3 f32", s3, 3, False, f32),
           ("cavity l4 A1 + R", cav, 2, True, f64),
           ("cavity l4 A1 + R f32", cav, 2, True, f32),
           ("cylinder l2 A1 + R", cyl, 2, True, f64),
           ("cylinder l2 A1 + R f32", cyl, 2, True, f32),
           ("cylinder l2 A1", cyl, 2, False, f64),
           ("config 5 l2 A1", c5, 2, False, f64)]
    out = [(n, p.n_cols, p.cols, p.row_len, d, r, dt, p.row_len)
           for n, p, d, r, dt in out]
    out.append(("rank-local A1 (4 ranks, no lengths)", c5.n_cols,
                c5.cols[:rank_rows].contiguous(), None, 2, False, f64,
                c5.row_len[:rank_rows]))
    return out


def _values(cols, lengths, d, with_R, dtype, rng, dev):
    n, K = cols.shape
    live = torch.arange(K)[None, :] < lengths.cpu()[:, None]
    val = lambda *shape: (torch.as_tensor(rng.standard_normal(shape + (
        n, K))) * live).to(dtype).to(dev).contiguous()
    A1 = val()
    R = val(d, d) if with_R else None
    return A1, R


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other version's csrc/ell_spmv.cu")
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
    for name, n_cols, cols, row_len, d, with_R, dt, live in cases(dev):
        A1, R = _values(cols, live, d, with_R, dt, rng, dev)
        x = torch.as_tensor(rng.standard_normal((d, n_cols)), dtype=dt,
                            device=dev)
        this = lambda: ell_spmv.ell_block_spmv(cols, A1, R, x, n_cols,
                                               row_len=row_len)
        that = lambda: other(cols, A1, R, x, None, row_len)
        ref = ell_spmv.ell_block_spmv_plain(cols, A1, R, x, n_cols)
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
            for tag, fn in (("other", that), ("this", this), ("this", this),
                            ("other", that)):
                order.append(tag)
                turns["device_ms"].append(measure.device_ms(fn))
                turns["ms"].append(measure.cuda_ms(fn))
        mean = {f"{tag} {k}": float(np.mean([t for o, t in zip(order, v)
                                             if o == tag]))
                for k, v in turns.items() for tag in ("other", "this")}
        rec = {"case": name, "shape": list(cols.shape), "d": d,
               "with_R": with_R, "dtype": _NAMES[dt],
               "lengths": row_len is not None, "max_rel_err": errs,
               "order": order, **turns, **mean,
               "this / other device": mean["this device_ms"]
               / mean["other device_ms"],
               "bound_ms": measure.bound(measure.ell_block_bytes(
                   A1, R, d, n_cols), 0, dt)[0],
               "bound_entries_ms": measure.bound(measure.ell_block_bytes(
                   A1, R, d, n_cols, row_len=live), 0, dt)[0]}
        ratios[name] = rec["this / other device"]
        print(json.dumps(rec), flush=True)
        del A1, R
        torch.cuda.empty_cache()
    print(json.dumps({"this / other device": ratios,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()

"""Multi-rank Oseen solves: the port's counterpart of ``demos/demo_spmd.py``.

    python -m fenapack_tpu_torch.spmd_demo -l 2 -n 4 [--path both|gspmd|ring]
        [--supg --nu 1e-3] [--vgmg] [--nls newton] [--fused]
        [--device cuda]

``--path gspmd`` (:func:`run_gspmd`) spawns ``-n`` rank processes that run
the single-device solver as one SPMD program over row-sharded ranks
(:class:`.parallel.sharding.ShardedOseen`, the JAX package's default
multi-chip path): the step at level ``-l`` with ``row_align = n``, BRM2,
FGMRES to 1e-6 under a cap of 80 with the JAX package's default subsolves
(dense velocity block and Ap); with ``--supg`` BASELINE config 5's
SUPG-stabilized system, both multigrids (the velocity hierarchy seeded by
the padded assembler) and a cap of 400.  It takes one sharded nonlinear
step from the initial state and prints the JAX demo's ``[gspmd]`` line,
then the collectives and milliseconds per FGMRES iteration.  ``both`` (the
default, as in the JAX demo) runs it and then the ring path.

``--path ring`` spawns ``-n`` rank processes (one gloo group, :mod:`.parallel.comm`); each
builds the 2D backward-facing step at level ``-l`` (RCM-reordered
Taylor-Hood, :class:`NSAssembler` ``reorder=True``) and runs the Picard or
Newton loop whose Oseen solves are distributed over the ranks
(:class:`.parallel.spmd_pcd.SPMDNonlinearSolver`): ring-halo operators,
distributed FGMRES (maxiter 120, 400 with ``--supg``, to 1e-6) and the
distributed pressure multigrid for Ap.  The velocity subsolve is the JAX
demo's: three rounds of four minimal-residual sweeps
(``cheb_velocity_iters=12``), or the distributed velocity multigrid with
``--supg`` or ``--vgmg``.  At level 2 the sweeps leave every linear
solve at the cap of 120 (in the JAX package too, f64 on the CPU); the
Picard loop still converges.  ``--supg`` is BASELINE config 5: the
SUPG-stabilized system, ``--nu 1e-3`` for Re 2000, damping 0.7.
``--nls newton`` starts from two Picard steps.  ``--fused`` keeps each
nonlinear step on the device.

Prints the JAX demo's ``[ring]`` summary, then the backend, the K3
launches of each rank and the exchanges and all-reduces per FGMRES
iteration.  All ranks share device 0 when ``--device cuda``: their times
are those of ranks on one card with gloo halos staged through host memory,
not of one card per rank.  ``--probe`` times the ring path's pieces
instead (:func:`rank_probe`).

The functions :func:`rank_run`, :func:`rank_oseen`, :func:`rank_prepare`,
:func:`rank_probe`, :func:`rank_kernel_check`, :func:`rank_gspmd` and
:func:`rank_gspmd_kernel_check` are what each rank runs;
tests and ``chip_smoke.py`` drive them through
:func:`.parallel.comm.run_ranks` or a :class:`.parallel.comm.RankPool`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from .fem import mesh as meshmod
from .fem import mesh3d
from .fem.assemble import NSAssembler
from .fem.dofmap import DirichletBC
from . import measure
from .ops.bsr_spmv import bsr_spmv, bsr_spmv_plain
from .ops.ell_spmv import (ell_block_spmv, ell_block_spmv_plain, ell_spmv,
                           ell_spmv_plain)
from .parallel.comm import run_ranks
from .parallel.sharding import ShardedOseen, make_device_mesh, timed_solve
from .parallel.spmd_gmg import SPMDPressureGMG, SPMDVelocityGMG
from .parallel.spmd_pcd import SPMDNonlinearSolver
from .solvers import gmg
from .solvers.config import SolverConfig, overrides
from .solvers.nonlinear import NonlinearSolver

def step_inflow(x):
    v = np.zeros((x.shape[0], 2))
    v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
    return v


def duct_inflow(x):
    v = np.zeros((x.shape[0], 3))
    v[:, 0] = 16.0 * x[:, 1] * (1 - x[:, 1]) * x[:, 2] * (1 - x[:, 2])
    return v


def spec_of(level: int = 2, *, problem: str = "step", nu: float = 0.02,
            supg: bool = False, nls: str = "picard", fused: bool = False,
            max_steps: int = 15, rtol: float = 1e-5, ap: str = "gmg",
            vgmg: bool = None, cheb_velocity_iters: int = 12,
            warm: int = None) -> dict:
    """A run of :func:`rank_run`, with the JAX demo's defaults: the step
    (``problem="step"``) or the 3D duct of ``__graft_entry__.py``
    (``"duct"``: ``channel_mesh3d(1, length=2)`` refined ``level`` times,
    Newton on the SUPG-stabilized system, both multigrids).  The velocity
    multigrid is taken with ``supg`` and on the duct unless ``vgmg`` says
    otherwise.  A ``device`` entry added to the spec makes the ranks
    compute there instead of on their group's device (the CPU reference of
    a run on the card)."""
    duct = problem == "duct"
    return dict(
        problem=problem, level=level, nu=nu, supg=supg or duct,
        nls="newton" if duct else nls, fused=fused, max_steps=max_steps,
        rtol=rtol, damping=0.8 if duct else 0.7 if supg else 1.0,
        ap=ap, vgmg=vgmg if vgmg is not None else (supg or duct),
        cheb_velocity_iters=8 if duct else cheb_velocity_iters,
        maxiter=150 if duct else 400 if supg else 120,
        warm=warm if warm is not None else (
            2 if nls == "newton" and not duct else 0))


_MESHES: dict = {}
_PROBLEMS: dict = {}
_SOLVERS: dict = {}


def _discretization(spec: dict, device) -> dict:
    """The mesh hierarchy, the reordered assembler, the boundary conditions
    and both multigrid hierarchies of ``spec``'s problem (cached per
    process: they depend on the problem, level, nu and device only)."""
    key = (spec["problem"], spec["level"], spec["nu"], str(device))
    if key in _MESHES:
        return _MESHES[key]
    dt = torch.float64
    if spec["problem"] == "duct":
        hier = gmg.build_hierarchy(mesh3d.channel_mesh3d(1, length=2.0),
                                   spec["level"])
        asm = NSAssembler(hier.fine, spec["nu"], device=device, dtype=dt,
                          quad_degree=4, reorder=True)
        d, inflow = 3, duct_inflow
    else:
        hier = gmg.build_hierarchy(meshmod.backward_step_mesh(0),
                                   spec["level"])
        asm = NSAssembler(hier.fine, spec["nu"], device=device, dtype=dt,
                          reorder=True)
        d, inflow = 2, step_inflow
    bcs = [DirichletBC.velocity(asm.W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], d))),
           DirichletBC.velocity(asm.W, [meshmod.INFLOW], inflow)]
    out = dict(hier=hier, asm=asm, bcs=bcs, d=d,
               ph=gmg.PressureHierarchy(hier, dt, device=device,
                                        pcd_markers=[meshmod.OUTFLOW]),
               vh=gmg.VelocityHierarchy(hier, spec["nu"], dt, device=device,
                                        bc_markers=[meshmod.WALL,
                                                    meshmod.INFLOW]))
    _MESHES[key] = out
    return out


def build_problem(spec: dict, device) -> dict:
    """The single-device pieces every rank holds (cached per process): the
    pieces of :func:`_discretization`, the nonlinear solver on the
    reordered assembler and, for a Newton run with a Picard warm start, the
    Picard solver."""
    key = (spec["problem"], spec["level"], spec["nu"], spec["supg"],
           spec["nls"], spec["maxiter"], spec["warm"], str(device))
    if key in _PROBLEMS:
        return _PROBLEMS[key]
    out = dict(_discretization(spec, device))
    # the single-device subsolves are never applied on this path; these
    # methods build no dense inverse and need no hierarchy
    cfg = overrides(SolverConfig(), {
        "pcd.variant": "BRM2", "dtype": "float64", "krylov.rtol": 1e-6,
        "krylov.maxiter": spec["maxiter"], "system_supg": spec["supg"],
        "pcd.ap.method": "chebyshev", "velocity.method": "minres"})
    out["nl"] = NonlinearSolver(out["asm"], out["bcs"], cfg,
                                pcd_marker=meshmod.OUTFLOW,
                                linearization=spec["nls"])
    if spec["warm"]:
        out["nl_pic"] = NonlinearSolver(out["asm"], out["bcs"], cfg,
                                        pcd_marker=meshmod.OUTFLOW)
    _PROBLEMS[key] = out
    return out


def build_solvers(comm, spec: dict) -> dict:
    """The rank's distributed solvers for ``spec`` (cached per process and
    group): the pressure multigrid, the velocity multigrid when the spec
    asks for it, the nonlinear driver and the warm-start Picard driver."""
    key = (id(comm), tuple(sorted(spec.items())))
    if key in _SOLVERS:
        return _SOLVERS[key]
    p = build_problem(spec, spec.get("device") or comm.device)
    newton = spec["nls"] == "newton"
    ap = (SPMDPressureGMG(p["ph"], comm, smooth_iters=2, cycles=2)
          if spec["ap"] == "gmg" else None)
    vg = (SPMDVelocityGMG(p["vh"], comm, smooth_iters=4, cycles=2,
                          supg=spec["supg"], newton=newton)
          if spec["vgmg"] else None)
    kw = dict(maxiter=spec["maxiter"], rtol_lin=1e-6)
    out = dict(problem=p, ap=ap, vgmg=vg, snl=SPMDNonlinearSolver(
        p["nl"], comm, ap_gmg=ap, velocity_gmg=vg,
        cheb_velocity_iters=spec["cheb_velocity_iters"], **kw))
    if spec["warm"]:
        out["pic"] = SPMDNonlinearSolver(p["nl_pic"], comm, ap_gmg=ap,
                                         cheb_velocity_iters=12, **kw)
    _SOLVERS[key] = out
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rank_run(comm, spec: dict) -> dict:
    """One rank's share of the nonlinear solve of ``spec``
    (:func:`spec_of`).  Returns the per-step counts, |F| history, true
    relative residuals, wall seconds, the state (NumPy) and a digest of
    the state after every step (the ranks' must be equal), this rank's
    kernel launches and collectives during the solve, and the ring halos."""
    s = build_solvers(comm, spec)
    snl = s["snl"]
    w0 = None
    if spec["warm"]:
        w0 = s["pic"].solve(max_steps=spec["warm"], rtol=0.0).w
    digests = []

    def digest(k, w):
        digests.append(hashlib.sha1(w.cpu().numpy().tobytes()).hexdigest())
    kw = dict(rtol=spec["rtol"], max_steps=spec["max_steps"],
              damping=spec["damping"], callback=digest)
    dev = spec.get("device") or comm.device
    _sync(dev)
    comm.reset_counts()
    measure.reset_launches()
    t0 = time.perf_counter()
    out = (snl.solve_fused if spec["fused"] else snl.solve)(w0=w0, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = measure.launch_counts()
    counts = dict(comm.counts)
    rings = snl.sp._rings
    return dict(
        iters=list(out.linear_iters), res=list(out.nonlinear_res),
        res_end=float(torch.linalg.norm(snl._residual(out.w))),
        lin_rel=list(out.lin_rel), converged=bool(out.converged),
        wall=wall, w=out.w.cpu().numpy(), digests=digests,
        n_dof=int(snl.nl.n),
        counts=counts, launches=launches, halos={"a1": rings["a1"].ring.halo, "kp": rings["kp"].ring.halo},
        size=comm.size, rank=comm.rank)


def rank_prepare(comm, specs) -> float:
    """Build (and cache in this rank's process) the distributed solvers of
    every ring spec in ``specs`` (:func:`spec_of`), so that later runs
    start at once; for a GSPMD spec (:func:`gspmd_spec`, whose solver is
    built afresh by every run) build its solver once, which fills the
    pattern cache and starts the device libraries.  Returns the seconds it
    took.  Communicates nothing."""
    t0 = time.perf_counter()
    for spec in specs:
        if "row_align" in spec:
            build_gspmd(spec, comm.device)
        else:
            build_solvers(comm, spec)
    return time.perf_counter() - t0


def rank_oseen(comm, spec: dict) -> dict:
    """One rank's share of one Oseen solve: the first linearized system of
    ``spec``'s problem (at the initial state).  Returns the solution in the
    assembler's order (NumPy), the count, the true relative residual, the
    wall seconds and this rank's collectives."""
    s = build_solvers(comm, spec)
    sp, nl = s["snl"].sp, s["snl"].nl
    w = nl.initial_state()
    F = nl.residual_of(w)[0].to(sp.dtype)
    b = sp.pack(-F[:nl.n_u], -F[nl.n_u:])
    ops = sp.build_operands(w[:nl.n_u])
    _sync(sp.device)
    comm.reset_counts()
    t0 = time.perf_counter()
    x, k, _ = sp.solve(ops, b)
    _sync(sp.device)
    wall = time.perf_counter() - t0
    return dict(x=np.concatenate(sp.unpack(x)), iters=int(k),
                lin_rel=sp.true_relres(x, b), wall=wall,
                counts=dict(comm.counts))


def rank_probe(comm, spec: dict, n: int = 100) -> dict:
    """Milliseconds per call, on this rank, of the ring path's pieces at
    ``spec``'s sizes: a K3 block product of the rank-local A1 without and
    with a device sync, a copy of a (2, 3000) f64 block to the host, a halo
    exchange of it (halo 100), an all-reduce of 20 values, an all-gather
    of 3,000, the distributed matvec and preconditioner apply, and the
    collectives of one preconditioner apply."""
    s = build_solvers(comm, spec)
    sp = s["snl"].sp
    dev = sp.device
    ops = sp.build_operands(s["snl"].nl.initial_state()[:s["snl"].nl.n_u])
    r = sp._rings["a1"]
    xe = torch.randn(2, r.ring.n_ext, dtype=torch.float64, device=dev)
    x = torch.randn(2, 3000, dtype=torch.float64, device=dev)
    mv, pc = sp._local_ops(ops)
    b = torch.randn(sp.nloc, dtype=torch.float64, device=dev)
    k3 = lambda: ell_block_spmv(r.cols, ops["a1"], None, xe, r.ring.n_ext)
    pieces = {
        "k3_block_a1": k3, "k3_block_a1_sync": lambda: (k3(), _sync(dev)),
        "to_host": lambda: x.to("cpu"),
        "exchange": lambda: comm.ring_exchange([(x, 100)]),
        "allreduce": lambda: comm.allreduce_sum(
            torch.ones(20, dtype=torch.float64, device=dev)),
        "allgather": lambda: comm.all_gather(x[0]),
        "matvec": lambda: mv(b), "pc": lambda: pc(b)}
    out = {}
    for name, fn in pieces.items():
        fn()
        _sync(dev)
        comm.reset_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(dev)
        out[name + "_ms"] = (time.perf_counter() - t0) / n * 1e3
    out["pc_collectives"] = {k: v / n for k, v in comm.counts.items()}
    return out


def _ring_operators(s: dict, ops: dict):
    """``(name, cols, vals, R, x_shape, n_cols, rows)`` of every rank-local
    operator of the solve: A1 (with R for Newton), D_a, B^T_a, Kp, Mp (and
    Ap without a pressure multigrid) of the Oseen solve; every pressure
    multigrid level's Ap and transfer pair; every velocity multigrid
    level's block and transfer pair.  Rank-local shapes: rows of this rank,
    columns of the extended (ring) or global (all-gather) space."""
    sp = s["snl"].sp
    r = sp._rings
    d = sp.d
    out = [("A1" + (" + R" if ops["R"] is not None else ""), r["a1"].cols,
            ops["a1"], ops["R"], (d, r["a1"].ring.n_ext),
            r["a1"].ring.n_ext, r["a1"].ring.n_loc),
           ("Kp", r["kp"].cols, ops["kp"], None, None, r["kp"].ring.n_ext,
            r["kp"].ring.n_loc),
           ("Mp", sp.mp_ring.cols, ops["mp"], None, None,
            sp.mp_ring.ring.n_ext, sp.mp_ring.ring.n_loc)]
    for a in range(d):
        for name, fr, v in (("D", sp.D_rings[a], ops["D"][a]),
                            ("B^T", sp.DT_rings[a], ops["DT"][a])):
            out.append((f"{name}_{a}", fr.cols, v, None, None, fr.ring.n_ext,
                        fr.ring.n_loc))
    if sp.ap_gmg is None:
        out.append(("Ap", sp.ap_ring.cols, ops["ap"], None, None,
                    sp.ap_ring.ring.n_ext, sp.ap_ring.ring.n_loc))
    else:
        g = sp.ap_gmg
        for l, lv in enumerate(g.levels):
            out.append((f"Ap level {l} ({lv.ring.kind})", lv.cols_loc,
                        lv.vals_loc, None, None, lv.ring.n_ext,
                        lv.ring.n_loc))
        for l, tr in enumerate(g.transfers):
            nf = g.levels[l + 1].ring.n_loc
            out.append((f"P1 prolongation {l}", tr[0], tr[1], None, None,
                        g.levels[l].n_pad, nf))
            out.append((f"P1 restriction {l}", tr[2], tr[3], None, None,
                        nf, g.levels[l].n_pad))
    vg = sp.velocity_gmg
    if vg is not None:
        for l, lvd in enumerate(vg.lv):
            vals, _, Rl = ops["vgmg"]["levels"][l]
            ring = lvd["ring"]
            out.append((f"velocity level {l} ({ring.kind})"
                        + (" + R" if Rl is not None else ""),
                        lvd["cols_loc"], vals, Rl, (d, ring.n_ext),
                        ring.n_ext, lvd["loc"]))
        for l, tr in enumerate(vg.tr):
            nf, npc = vg.lv[l + 1]["loc"], vg.lv[l]["n_pad"]
            out.append((f"P2 prolongation {l}", tr[0], tr[1], None,
                        (d, npc), npc, nf))
            out.append((f"P2 restriction {l}", tr[2], tr[3], None,
                        (d, nf), nf, npc))
    return out


def rank_kernel_check(comm, spec: dict, seed: int = 0) -> dict:
    """Every rank-local operator of ``spec``'s solve at its first wind,
    through K3 against the plain version on the same seeded inputs (f64).
    Returns per operator its rank-local shape and the largest absolute and
    relative differences."""
    s = build_solvers(comm, spec)
    sp = s["snl"].sp
    ops = sp.build_operands(s["snl"].nl.initial_state()[:s["snl"].nl.n_u])
    gen = torch.Generator().manual_seed(seed + comm.rank)
    rows = []
    for name, cols, vals, R, xs, n_cols, n_rows in _ring_operators(s, ops):
        shape = xs if xs is not None else (n_cols,)
        x = torch.randn(shape, generator=gen, dtype=torch.float64).to(
            vals.device)
        if xs is not None:
            y = ell_block_spmv(cols, vals, R, x, n_cols)
            ref = ell_block_spmv_plain(cols, vals, R, x, n_cols)
        else:
            y = ell_spmv(cols, vals, x, n_cols)
            ref = ell_spmv_plain(cols, vals, x, n_cols)
        abs_err = float((y - ref).abs().max())
        rows.append(dict(name=name, rows=int(n_rows), cols=int(n_cols),
                         K=int(cols.shape[1]), kind="single" if xs is None
                         else "block", abs_err=abs_err,
                         rel_err=abs_err / max(float(ref.abs().max()),
                                               1e-300)))
    return dict(rank=comm.rank, ops=rows)


# --------------------------------------------------------------------- #
# the GSPMD path (parallel/sharding.py)
# --------------------------------------------------------------------- #

def gspmd_spec(level: int = 2, *, nu: float = 0.02, supg: bool = False,
               row_align: int = 4, block: bool = False,
               hi_block: bool = False, rtol: float = 1e-6,
               maxiter: int = 80) -> dict:
    """A run of :func:`rank_gspmd`: the JAX demo's ``--path gspmd`` at step
    level ``level`` on an assembler with ``row_align`` (a multiple of the
    rank count), FGMRES to ``rtol`` under ``maxiter`` (400 with ``supg``).
    ``block``: the BSR layout of ``tests/test_parallel.py`` (tiles of 32,
    f32 compute constants and preconditioner; ``hi_block`` keeps the f64
    operators in the same layout)."""
    return dict(level=level, nu=nu, supg=supg, row_align=row_align,
                block=block, hi_block=hi_block, rtol=rtol, maxiter=maxiter)


def build_gspmd(spec: dict, device) -> NonlinearSolver:
    """The single-device solver of ``spec`` (a fresh one: sharding mutates
    it).  Without ``supg`` the subsolves are the JAX package's defaults, a
    dense velocity block and a dense Ap; with it the SUPG-stabilized system
    and both multigrids, the velocity hierarchy seeded by the padded
    assembler."""
    dt = torch.float64
    over = {"pcd.variant": "BRM2", "dtype": "float64",
            "krylov.rtol": spec["rtol"], "krylov.maxiter": spec["maxiter"],
            "velocity.method": "lu", "pcd.ap.method": "lu"}
    kw = {}
    if spec["block"]:
        kw = dict(block_size=32, block_dtype=torch.float32,
                  hi_block=spec["hi_block"])
        over["dtype"] = "float32"
    if spec["supg"]:
        hier = gmg.build_hierarchy(meshmod.backward_step_mesh(0),
                                   spec["level"])
        mesh = hier.fine
        over.update({"system_supg": True, "krylov.maxiter": 400,
                     "velocity.method": "gmg", "velocity.smooth_iters": 3,
                     "velocity.cycles": 2, "pcd.ap.method": "gmg"})
    else:
        mesh = meshmod.backward_step_mesh(spec["level"])
    asm = NSAssembler(mesh, spec["nu"], device=device, dtype=dt,
                      row_align=spec["row_align"], **kw)
    bcs = [DirichletBC.velocity(asm.W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [meshmod.INFLOW], step_inflow)]
    ap_h = v_h = None
    if spec["supg"]:
        ap_h = gmg.PressureHierarchy(hier, dt, device=device,
                                     pcd_markers=[meshmod.OUTFLOW])
        v_h = gmg.VelocityHierarchy(hier, spec["nu"], dt, device=device,
                                    bc_markers=[meshmod.WALL,
                                                meshmod.INFLOW],
                                    fine_asm=asm)
    return NonlinearSolver(asm, bcs, overrides(SolverConfig(), over),
                           pcd_marker=meshmod.OUTFLOW, ap_hierarchy=ap_h,
                           velocity_hierarchy=v_h)


def gspmd_single(spec: dict, device) -> dict:
    """The unsharded step of ``spec`` on one device (the same padded
    assembler): the state (NumPy), the count, the wall seconds of the step
    and of its FGMRES loop alone, the kernel launches, and ``relres(w)``:
    the f64 true relative residual of the step's linear system at the
    update ``w - w0`` of any state ``w`` of that layout (this one's, or a
    sharded run's)."""
    nl = build_gspmd(spec, device)
    o = nl.oseen
    w0 = nl.initial_state()
    _sync(device)
    measure.reset_launches()
    t0 = time.perf_counter()
    F = nl.residual_of(w0)[0].to(o.dtype)
    res, fgmres = timed_solve(o, w0[:nl.n_u], -F)
    w1 = w0 + res.x
    _sync(device)
    wall = time.perf_counter() - t0
    launches = measure.launch_counts()
    true_res = o.make_true_residual()
    w64 = w0.to(torch.float64)
    b = -nl.residual_of(w0)[0].to(torch.float64)

    def relres(w) -> float:
        x = torch.as_tensor(w, dtype=torch.float64, device=device) - w64
        return float(true_res(w64[:nl.n_u], x, b)[1] / torch.linalg.norm(b))
    return dict(w=w1.cpu().numpy(), iters=int(res.iters), wall=wall,
                fgmres=fgmres, launches=launches, relres=relres)


def rank_gspmd(comm, spec: dict, repeat: int = 1) -> dict:
    """One rank's share of :class:`ShardedOseen`'s step of ``spec`` from
    the initial state, taken ``repeat`` times by the same sharded solver.
    Returns the first step's state (whole, NumPy), the digest of every
    step's state, the count, the setup and step seconds and the seconds of
    the step's FGMRES loop alone, this rank's collectives and kernel
    launches during the first step, the peak device memory (GiB) of the
    rank's process during the call above what it held when the call began,
    and the sizes."""
    dev = comm.device
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    nl = build_gspmd(spec, dev)
    sh = ShardedOseen(nl, make_device_mesh(comm.size))
    setup = time.perf_counter() - t0
    w0 = nl.initial_state()
    _sync(dev)
    comm.reset_counts()
    measure.reset_launches()
    t0 = time.perf_counter()
    w1, iters, _ = sh.step(w0)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts, launches = dict(comm.counts), measure.launch_counts()
    fgmres = sh.fgmres_seconds
    w = w1.cpu().numpy()
    digests = [hashlib.sha1(w.tobytes()).hexdigest()]
    for _ in range(repeat - 1):
        wr = sh.step(w0)[0].cpu().numpy()
        digests.append(hashlib.sha1(wr.tobytes()).hexdigest())
    asm = nl.asm
    peak = ((torch.cuda.max_memory_allocated(dev) - base) / 2**30
            if cuda else 0.0)
    return dict(w=w, digest=digests[0], digests=digests, peak_gib=peak,
                fgmres=fgmres, iters=int(iters), wall=wall, setup=setup,
                counts=counts, launches=launches,
                n_dof=int(nl.n), n_real=int(asm.dim * asm.n2_real
                                            + asm.n1_real),
                rank=comm.rank, size=comm.size)


def _gspmd_operators(nl):
    """``(name, kind, op, R)`` of every operator the sharded step of ``nl``
    applies on this rank, at the initial wind: the constant operators of
    both precision sets, A1 of the system (and of the preconditioner with
    the streamline diffusion), the Newton reaction blocks with it, Kp;
    every multigrid level's operator and restriction (whole on every
    rank).  ``kind``: ``ell`` (single), ``block`` (velocity block),
    ``bsr``."""
    asm, o = nl.asm, nl.oseen
    wind = nl.initial_state()[:nl.n_u].to(asm.dtype)
    out = []
    sets = [("", asm.const)] + ([("hi ", asm.const_hi)]
                               if asm.const_hi is not asm.const else [])
    for tag, c in sets:
        named = [("L", c.L), ("Mp", c.Mp), ("Ap", c.Ap), ("M2", c.M2)]
        named += [(f"D_{a}", op) for a, op in enumerate(c.D)]
        named += [(f"B^T_{a}", op) for a, op in enumerate(c.DT)]
        for name, op in named:
            if op is not None:
                out.append((tag + name, "bsr" if hasattr(op, "tiles")
                            else "ell", op, None))
    A1, _ = o._operator_values(wind)
    p2 = asm.pat_p2
    if p2.block:
        out.append(("A1", "bsr", p2.matrix(A1), None))
    else:
        R = asm.newton_reaction_values(wind)
        out.append(("A1", "block", p2.matrix(A1), None))
        out.append(("A1 + R", "block", p2.matrix(A1), R))
    kp = asm.pat_p1.matrix(asm.kp_values(wind, surface=True).to(o.dtype))
    out.append(("Kp", "bsr" if asm.pat_p1.block else "ell", kp, None))
    vh, ph = o.velocity_hierarchy, o.ap_hierarchy
    if vh is not None:
        vals = gmg.velocity_gmg_values(vh, wind, o.bc_mask_u, o.dtype,
                                       supg=True)
        for l, (A1l, _) in enumerate(vals["levels"][:-1]):
            out.append((f"velocity level {l}", "block",
                        vh.asms[l].pat_p2.matrix(A1l), None))
        for l, t in enumerate(vh.transfers):
            out.append((f"P2 restriction {l}", "ell", t._PT, None))
    if ph is not None:
        for l, lev in enumerate(ph.levels):
            out.append((f"Ap level {l}", "ell", lev.Ap, None))
        for l, t in enumerate(ph.transfers):
            out.append((f"P1 restriction {l}", "ell", t._PT, None))
    return out


def rank_gspmd_kernel_check(comm, spec: dict, seed: int = 0) -> dict:
    """Every operator the sharded step of ``spec`` applies on this rank
    (:func:`_gspmd_operators`: the rank's rows over global columns, or
    whole), through its kernel against the plain version on the same
    seeded inputs: K3 single and block products in f64 and in f32, BSR in
    its own dtype (K2 for f32 tiles, K1 for f64).  Returns per operator its
    rank-local shape, kernel, dtype and the largest absolute and relative
    differences."""
    dev = comm.device
    nl = build_gspmd(spec, dev)
    ShardedOseen(nl, make_device_mesh(comm.size))
    gen = torch.Generator().manual_seed(seed + comm.rank)
    rows = []

    def record(name, kernel, dtype, shape, y, ref):
        abs_err = float((y - ref).abs().max())
        rows.append(dict(name=name, kernel=kernel, dtype=dtype,
                         shape=[int(v) for v in shape], abs_err=abs_err,
                         rel_err=abs_err / max(float(ref.abs().max()),
                                               1e-300)))
    for name, kind, op, R in _gspmd_operators(nl):
        if kind == "bsr":
            x = torch.randn(op.n_cols, generator=gen,
                            dtype=torch.float64).to(dev, op.tiles.dtype)
            n_rows = op.nbr.shape[0] * op.tiles.shape[2]
            n_rows = min(n_rows, op.pat.n_rows_full)
            y = bsr_spmv(op.nbr, op.tiles, x, n_rows, op.n_cols)
            ref = bsr_spmv_plain(op.nbr, op.tiles, x, n_rows, op.n_cols)
            dt = "f32" if op.tiles.dtype == torch.float32 else "f64"
            record(name, "bsr_spmv_" + dt, dt, op.tiles.shape, y, ref)
            continue
        cols, vals = op.cols, op.vals
        n_cols = op.n_cols
        for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
            v = vals.to(tdt).contiguous()
            if kind == "block":
                x = torch.randn((2, n_cols), generator=gen,
                                dtype=torch.float64).to(dev, tdt)
                Rt = None if R is None else R.to(tdt).contiguous()
                y = ell_block_spmv(cols, v, Rt, x, n_cols)
                ref = ell_block_spmv_plain(cols, v, Rt, x, n_cols)
                record(name, "ell_block_spmv", dt, cols.shape, y, ref)
            else:
                x = torch.randn(n_cols, generator=gen,
                                dtype=torch.float64).to(dev, tdt)
                y = ell_spmv(cols, v, x, n_cols)
                ref = ell_spmv_plain(cols, v, x, n_cols)
                record(name, "ell_spmv", dt, cols.shape, y, ref)
    return dict(rank=comm.rank, ops=rows)


def run_gspmd(args) -> list:
    """``--path gspmd``: :func:`rank_gspmd` on ``-n`` rank processes;
    prints the JAX demo's ``[gspmd]`` line, the backend, and the
    collectives and milliseconds per FGMRES iteration."""
    n = args.devices
    spec = gspmd_spec(args.level, nu=args.nu, supg=args.supg, row_align=n)
    t0 = time.perf_counter()
    res = run_ranks(rank_gspmd, n, spec, device=args.device,
                    timeout=3000.0)
    total = time.perf_counter() - t0
    r0 = res[0]
    if any(r["digest"] != r0["digest"] for r in res):
        raise RuntimeError("the ranks' states differ after the step")
    where = (f"{n} ranks on one card, gloo"
             if torch.device(args.device).type == "cuda"
             else f"{n} ranks on the CPU, gloo")
    print(f"[gspmd] {n} devices: one sharded nonlinear step, "
          f"{r0['iters']} FGMRES iters, {r0['wall']:.1f} s ({where}; "
          f"{total:.1f} s with rank start-up and setup)", flush=True)
    its = max(r0["iters"], 1)
    print(f"[gspmd] backend: torch.distributed gloo, {n} rank processes "
          f"on {args.device}; {r0['n_dof']} dofs ({r0['n_real']} real, "
          f"row_align {spec['row_align']}); FGMRES loop {r0['fgmres']:.3f} "
          f"s of the step; per FGMRES iteration (rank 0): "
          + json.dumps({k: round(v / its, 2) for k, v in
                        r0["counts"].items()})
          + f", {r0['fgmres'] / its * 1e3:.2f} ms", flush=True)
    return res


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="multi-rank Oseen solves: the GSPMD path (the "
                    "single-device solver on row-sharded ranks) and the "
                    "ring path")
    ap.add_argument("-l", "--level", type=int, default=1)
    ap.add_argument("-n", "--devices", type=int, default=4,
                    help="rank processes (all on one card with --device "
                         "cuda)")
    ap.add_argument("--nu", type=float, default=0.02)
    ap.add_argument("--path", choices=["gspmd", "ring", "both"],
                    default="both")
    ap.add_argument("--supg", action="store_true",
                    help="SUPG-stabilized system + velocity multigrid "
                         "(BASELINE config 5: --nu 1e-3 for Re 2000)")
    ap.add_argument("--vgmg", action="store_true",
                    help="distributed velocity multigrid without --supg "
                         "(default: minimal-residual sweeps, as the JAX "
                         "demo)")
    ap.add_argument("--nls", choices=["picard", "newton"], default="picard")
    ap.add_argument("--fused", action="store_true",
                    help="keep each nonlinear step on the device")
    ap.add_argument("--max-steps", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probe", action="store_true",
                    help="time the ring path's pieces instead (rank_probe): "
                         "one rank in this process, then -n rank "
                         "processes, then -n rank threads")
    return ap


def probe(args):
    """``--probe``: :func:`rank_probe` on one rank in this process, on
    ``-n`` rank processes and on ``-n`` rank threads, one JSON line each
    (rank 0's numbers)."""
    from .parallel.comm import Comm
    spec = spec_of(args.level, vgmg=True)
    where = str(torch.device(args.device))
    one = rank_probe(Comm(None, 0, 1, args.device), spec)
    print(json.dumps({"ranks": 1, "kind": "in-process", "device": where,
                      **one}), flush=True)
    for threads in (False, True):
        res = run_ranks(rank_probe, args.devices, spec,
                        30 if threads else 100, device=args.device,
                        threads=threads, timeout=900.0)
        print(json.dumps({"ranks": args.devices, "device": where,
                          "kind": "threads" if threads else "processes",
                          **res[0]}), flush=True)


def main(argv=None):
    """Run the paths of ``--path``; returns the ring path's per-rank
    results when it ran, else the GSPMD path's."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.probe:
        return probe(args)
    if args.supg and args.nls == "newton":
        ap.error("--supg stabilizes with the lagged (Picard) operator; the "
                 "Newton reaction is not the Jacobian of the stabilized "
                 "residual: use --nls picard for high-Re runs")
    gspmd = run_gspmd(args) if args.path in ("gspmd", "both") else None
    if args.path == "gspmd":
        return gspmd
    spec = spec_of(args.level, nu=args.nu, supg=args.supg, nls=args.nls,
                   fused=args.fused, max_steps=args.max_steps,
                   vgmg=args.vgmg or None)
    n = args.devices
    t0 = time.perf_counter()
    res = run_ranks(rank_run, n, spec, device=args.device,
                    timeout=3000.0)
    total = time.perf_counter() - t0
    r0 = res[0]
    if any(r["digests"] != r0["digests"] for r in res):
        raise RuntimeError("the ranks' states differ after a step")
    where = (f"{n} ranks on one card, gloo"
             if torch.device(args.device).type == "cuda"
             else f"{n} ranks on the CPU, gloo")
    print(f"[ring]  {n} devices: full {args.nls} solve over the ring-halo "
          f"SPMD path: converged={r0['converged']} in "
          f"{len(r0['iters'])} steps, FGMRES iters/step {r0['iters']}, "
          f"|F| {r0['res'][-1]:.2e}, {r0['wall']:.1f} s ({where}; "
          f"{total:.1f} s with rank start-up and setup); halos: "
          f"a1={r0['halos']['a1']} kp={r0['halos']['kp']}", flush=True)
    its = max(sum(r0["iters"]), 1)
    print(f"backend: torch.distributed gloo, {n} rank processes on "
          f"{args.device}; {r0['n_dof']} dofs; max true lin_rel "
          f"{max(r0['lin_rel'] or [0.0]):.2e}", flush=True)
    print("K3 launches per rank " + json.dumps(
        [r["launches"] for r in res]), flush=True)
    print("per FGMRES iteration (rank 0): " + json.dumps(
        {k: round(v / its, 2) for k, v in r0["counts"].items()}),
        flush=True)
    return res


if __name__ == "__main__":
    main()

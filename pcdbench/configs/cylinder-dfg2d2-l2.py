"""cylinder-dfg2d2-l2: DFG 2D-2 (Schafer-Turek, Re 100) at level 2 through
the port's entry point for it, ``fenapack_tpu_torch.cylinder.build(...,
unsteady=True)``, stepped by the exact BDF2 loop ``UnsteadySolver.solve``
(:mod:`pcdbench.unsteady`)."""
from pcdbench.unsteady import UnsteadyTarget


def _solver(cfg: dict, device, dtype: str):
    """The entry point's BDF2 solver of the file's problem in ``dtype``,
    with the settings that the entry point fixes checked against the
    file's."""
    from fenapack_tpu_torch import cylinder
    from fenapack_tpu_torch.fem.mesh import OUTFLOW
    b, pr = cfg["build"], cfg["problem"]
    if cfg["level"] != pr["level"]:
        raise ValueError("the file's level and its problem's differ")
    us = cylinder.build(cfg["level"], pr["re"], device=device, unsteady=True,
                        dt=pr["dt"], dtype=dtype, ls=b["ls"],
                        maxiter=b["krylov_maxiter"])
    c = us.oseen.config
    fixed = {
        "nu": (cylinder.NU, pr["nu"]),
        "inflow peak": (1.5 * cylinder.UBAR[pr["re"]], pr["u_max"]),
        "scheme": (us.scheme, pr["scheme"]),
        "dt": (us.dt, pr["dt"]),
        "quad_degree": (us.asm.quad_degree, pr["quad_degree"]),
        "dofs": (us.n, cfg["size"]["dofs"]),
        "pcd": (c.pcd.variant, b["pcd"]),
        "pcd rows": (us.oseen.pcd_marker, OUTFLOW),
        "krylov rtol": (c.krylov.rtol, cfg["solve"]["rtol_lin"]),
        "krylov maxiter": (c.krylov.maxiter, b["krylov_maxiter"]),
        "velocity smoother": (c.velocity.smoother, b["velocity_smoother"]),
        "velocity smooth_iters": (c.velocity.smooth_iters,
                                  b["velocity_smooth_iters"]),
        "velocity cycles": (c.velocity.cycles, b["velocity_cycles"]),
        "layout": (us.asm.block_size, None),
    }
    for k, (built, stated) in fixed.items():
        if built != stated:
            raise ValueError(f"cylinder.build's {k} is {built}, the file's "
                             f"{stated}")
    return us


def target(cfg: dict, device) -> UnsteadyTarget:
    return UnsteadyTarget(
        cfg, lambda: _solver(cfg, device, cfg["build"]["dtype"]), device)


def lower_precision(cfg: dict, device):
    """The control: the same exact loop through the same entry point with
    assembler, state, preconditioner and Krylov solve in float32."""
    return _solver(cfg, device, "float32")

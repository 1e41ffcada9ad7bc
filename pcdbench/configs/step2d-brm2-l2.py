"""step2d-brm2-l2: fenapack's backward-facing step demo at level 2 through
the port's main path, ``fenapack_tpu_torch.bench.build``, with the
configuration file's solver settings."""
from pcdbench.steady import SteadyTarget


def settings(cfg: dict) -> dict:
    """The file's solver settings as the program's dotted options; the
    ones that ``bench.build`` fixes are checked against the file."""
    from fenapack_tpu_torch import bench
    b, pr = cfg["build"], cfg["problem"]
    if cfg["level"] != pr["level"]:
        raise ValueError("the file's level and its problem's differ")
    fixed = {"block": (bench.BLOCK, b["block"]), "nu": (bench.NU, pr["nu"])}
    for k, (built, stated) in fixed.items():
        if built != stated:
            raise ValueError(f"bench.build's {k} is {built}, the file's "
                             f"{stated}")
    return {"pcd.variant": b["pcd"], "krylov.maxiter": b["krylov_maxiter"],
            "krylov.hi_krylov": b["krylov_dtype"] == "float64"}


def target(cfg: dict, device) -> SteadyTarget:
    def build():
        from fenapack_tpu_torch import bench
        return bench.build(cfg["level"], device=device,
                           dtype=cfg["build"]["preconditioner_dtype"],
                           over=settings(cfg))
    return SteadyTarget(cfg, build, device)


def lower_precision(cfg: dict, device):
    """The program's float32 path for this problem (the control): the
    step at the same level with the assembler, the state and the Krylov
    solve in float32."""
    from fenapack_tpu_torch.models import StepFlow2D
    p = StepFlow2D(level=cfg["level"], nu=cfg["problem"]["nu"],
                   length=cfg["problem"]["length"], dtype="float32",
                   device=str(device))
    return p.solver(cfg["build"]["pcd"], gmg_subsolves=True,
                    **{"krylov.maxiter": cfg["build"]["krylov_maxiter"],
                       "velocity.smooth_iters": 3, "velocity.cycles": 2})

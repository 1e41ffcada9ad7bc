"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m pcdbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Set-up builds the cell's configuration
(``configs/<name>.py``), installs the data drawn from ``--seed`` and warms
up; the window then runs requests back to back (``traffic/<name>.json``,
:mod:`.loop`) for ``--seconds``.  With ``--trace 1`` whole requests follow
under the profiler (:mod:`.trace`).  Once the window has closed and the
program's state is freed, the reference judges every answer of the window
(:mod:`.steady`).  The metrics are read by ``metrics/<name>.py``:
``end_to_end`` ones with ``--trace 0``, ``per_layer`` ones with
``--trace 1``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: every number compared beside its
limit); the same comparisons are the last lines of standard error.  The
run fails with no result where no card is present, where the cell asks
for more cards than there are, or where JAX or the JAX package was
imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "fenapack_tpu")


class NoCard(RuntimeError):
    pass


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str, data: str = HERE):
    """``(cell, cfg, cfg_module, traffic)`` of ``workload``, each found by
    its name under ``data``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    name = cell["config"]
    cfg = load_json(os.path.join(data, "configs", name + ".json"))
    mod = load_module(os.path.join(data, "configs", name + ".py"),
                      "pcdbench_config_" + name.replace("-", "_")
                      .replace(".", "_"))
    traffic = load_json(os.path.join(data, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, cfg, mod, traffic


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell
    reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def _cache_dirs():
    """Every build and kernel cache at a fixed path in the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["FENAPACK_CACHE"] = os.path.join(build, "patterns")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def verdict(records, readings, limits: dict):
    """``(failed, check)``: a request fails where it did not converge
    within its caps or a reading exceeds its limit; ``check`` holds the
    worst reading of each number beside its limit."""
    failed = 0
    for rec, r in zip(records, readings):
        if not rec.ok or any(not r[k] <= lim for k, lim in limits.items()):
            failed += 1
    check = {}
    for k, lim in limits.items():
        vals = [r[k] for r in readings]
        check[k] = {"value": max(vals) if vals else None, "limit": lim}
    check["unconverged"] = {"value": sum(not r.ok for r in records),
                            "limit": 0}
    return failed, check


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
        *, device: str = "cuda", data: str = HERE) -> dict:
    """One run of ``workload``; the result object of the last line."""
    _cache_dirs()
    import torch
    cell, cfg, mod, traffic = cell_parts(bench, workload, data)
    cuda = device.startswith("cuda")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cuda and have < int(cell["chips"]):
        raise NoCard(f"{workload} needs {cell['chips']} CUDA device(s); "
                     f"this machine has {have}")
    from . import loop
    from . import trace as tracing

    def sync():
        if cuda:
            torch.cuda.synchronize()

    peak = (lambda: torch.cuda.max_memory_allocated()) if cuda else (
        lambda: 0)
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    stages = {"imports and device": time.perf_counter() - T_START}
    target = mod.target(cfg, torch.device(device))
    t0 = time.perf_counter()
    target.build()
    sync()
    build_s = stages["build"] = time.perf_counter() - t0
    peaks = {"build": peak()}
    t0 = time.perf_counter()
    target.prepare(seed)
    stages["seeded inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    target.warmup(int(traffic.get("warmup_steps", 1)))
    sync()
    stages["warm-up"] = time.perf_counter() - t0
    peaks["warm-up"] = peak()

    from fenapack_tpu_torch.measure import launch_counts

    def launches():
        return sum(sum(v.values()) for v in launch_counts().values())

    n0 = launches()
    window = loop.closed_loop(target, seconds, traffic, sync)
    ctx = {"setup_s": window.t0 - T_START, "build_s": build_s,
           "window": window, "launches": launches() - n0,
           "peak_bytes": peak(), "profile": None}
    peaks["window"] = ctx["peak_bytes"]
    if trace:
        n = int(traffic.get("profile_requests", 1))
        recs, wall, events, scopes = tracing.profile(target, n)
        p = tracing.summarize(events, wall)
        del events
        p.update(requests=n, iters=sum(r.iters for r in recs),
                 least_s=scopes.least_s,
                 calls=dict(scopes.calls), unknown=scopes.unknown)
        ctx["profile"] = p
        print("profile: " + json.dumps(p), flush=True)
    records = window.records
    target.free()
    try:
        readings = target.judge(records)
    except ValueError as e:        # the program's dofs are not the mesh's
        print(f"judge: {e}", file=sys.stderr, flush=True)
        readings = [{k: float("inf") for k in cfg["limits"]}
                    for _ in records]
    failed, check = verdict(records, readings, cfg["limits"])

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, kind, workload):
        reader = load_module(os.path.join(data, "metrics",
                                          m["name"] + ".py"),
                             "pcdbench_metric_" + m["name"])
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device, "count": 1,
           "memory_peak_bytes": int(ctx["peak_bytes"])}
    if cuda:
        dev.update(kind=torch.cuda.get_device_name(0),
                   count=int(cell["chips"]),
                   power_limit_w=_power_limit())
    result = {"correct": bool(records) and failed == 0,
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        p = ctx["profile"]
        dev.update(busy_s=p["busy_s"], window_s=p["wall_s"])
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    print(f"samples: {len(records)} solves, {len(window.step_s)} steps, "
          f"{sum(r.iters for r in records)} FGMRES iterations in "
          f"{window.wall_s!r} s", flush=True)
    print("set-up seconds: " + json.dumps(stages), flush=True)
    print("peak bytes after: " + json.dumps(peaks), flush=True)
    for i, (rec, r, s) in enumerate(zip(records, readings,
                                        window.request_s)):
        print(f"solve {i}: {s!r} s steps {rec.steps} iters {rec.iters} "
              f"converged {rec.ok} "
              + " ".join(f"{k} {v!r}" for k, v in r.items()), flush=True)
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    try:
        result = run(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr, flush=True)
        return 2
    bad = forbidden_loaded()
    if bad:
        print(f"no result: the process loaded {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

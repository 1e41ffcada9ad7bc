"""The unsteady cylinder cell's parts at level 0 on the CPU: the plain BDF2
reference against the program's residual, the span target judged by it,
the geometry check, and the exact loop's spans and counters.

The cell (``pcdbench/configs/cylinder-dfg2d2-l2``) runs DFG 2D-2 at level
2; here the same configuration at level 0 (20,954 dofs) with one lead step
and a span of two.  The dense cap is lowered below the level-0 P1 bottom
(4,764 dofs), as ``test_torch_entry_points.py`` does: its inverse, rebuilt
for every Picard solve, takes seconds on one CPU thread; the bottom becomes
minimal-residual sweeps.  The span runs once for the module (~25 s on one
thread), the tests read it.
"""
import dataclasses
import gc
import os
import warnings

import numpy as np
import pytest
import torch

from fenapack_tpu_torch.ops import sparse
from fenapack_tpu_torch.solvers import gmg as tgmg
from fenapack_tpu_torch.utils import timing
from pcdbench import run as harness
from pcdbench.force import body_force
from pcdbench.reference import bdf2, cylinder as refcyl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "pcdbench")
SEED = 2 ** 31 + 21


def _cfg():
    cfg = harness.load_json(os.path.join(HERE, "configs",
                                         "cylinder-dfg2d2-l2.json"))
    cfg["level"] = cfg["problem"]["level"] = 0
    cfg["size"]["dofs"] = 20954
    cfg["solve"].update(lead_steps=1, span_steps=2)
    return cfg


@pytest.fixture(scope="module")
def target():
    cfg = _cfg()
    mod = harness.load_module(os.path.join(HERE, "configs",
                                           "cylinder-dfg2d2-l2.py"),
                              "cylinder_span_cfg")
    t = mod.target(cfg, torch.device("cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgmg, "DENSE_MAX", 4096)
        t.build()
        yield t


def _row_lengths():
    """``{column tensor's data_ptr: row lengths}`` of every live ELL
    pattern and operator."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        live = [o for o in gc.get_objects()
                if isinstance(o, (sparse.SparsityPattern, sparse.ELL))]
    return {o.cols.data_ptr(): o.row_len for o in live
            if getattr(o, "row_len", None) is not None}


@pytest.fixture(scope="module")
def span(target):
    """The target prepared from SEED and one request, with what the span
    did recorded: the counters' deltas, each Oseen solve's host syncs, and
    the entries (the row lengths of its pattern) and vector entries of
    every product handed to the ELL kernels."""
    target.prepare(SEED)
    us = target.us
    solves, products = [], []
    solve = us.oseen.solve
    lengths = _row_lengths()

    def counted_solve(wind, b):
        s0 = timing.counts["host_syncs"]
        out = solve(wind, b)
        solves.append(timing.counts["host_syncs"] - s0)
        return out

    single, block = sparse.ell_spmv, sparse.ell_block_spmv

    def single_seen(cols, vals, x, n_cols):
        k = 1 if x.dim() == 1 else x.shape[1]
        n = int(torch.sum(lengths[cols.data_ptr()]))
        products.append((vals.dtype, n, (cols.shape[0] + n_cols) * k))
        return single(cols, vals, x, n_cols)

    def block_seen(cols, A1, R, x, n_cols, y0=None, row_len=None):
        d = x.shape[0]
        planes = 1 if R is None else 1 + d * d
        products.append((A1.dtype, planes * int(torch.sum(row_len)),
                         d * (n_cols + cols.shape[0]
                              * (1 if y0 is None else 2))))
        return block(cols, A1, R, x, n_cols, y0, row_len=row_len)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(us.oseen, "solve", counted_solve)
        mp.setattr(sparse, "ell_spmv", single_seen)
        mp.setattr(sparse, "ell_block_spmv", block_seen)
        c0 = dict(timing.counts)
        rec = target.solve()
        delta = {k: timing.counts[k] - c0[k] for k in c0}
    return rec, delta, solves, products


def test_reference_bdf2_residual_is_the_programs(target):
    """The reference's BDF2 residual equals ``_residual_full`` at a seeded
    random state, old and older velocity, with the seeded load, placed by
    coordinates, to 1e-12 of its largest entry."""
    us, cfg = target.us, target.cfg
    f = cfg["force"]
    force = body_force(SEED + 1, 2, f["amplitude"], f["modes"], f["kmax"])
    us.asm.set_body_force(force)
    g = torch.Generator().manual_seed(5)
    w, u_old, u_prev = (torch.randn(n, generator=g, dtype=torch.float64)
                        for n in (us.n, us.n_u, us.n_u))
    got = us._residual_full(w, u_old, u_prev).numpy()
    j = bdf2.SpanJudge(cfg["problem"], *target._mesh, force,
                       cfg["problem"]["dt"], device=torch.device("cpu"))
    j.layout(*target._coords)
    n_u = us.n_u
    place = lambda v: j._place(np.concatenate([v, np.zeros(us.n - n_u)]))
    u, p = j._place(w.numpy())
    ru, rp = j.bdf2.residual(u, p, place(u_old.numpy())[0],
                             place(u_prev.numpy())[0], j.load)
    want = np.concatenate([ru.numpy()[:, j.perm_u].ravel(),
                           rp.numpy()[j.perm_p]])
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-12 * scale


def test_span_passes_the_judge(target, span):
    rec, _, _, _ = span
    assert rec.ok and rec.steps == 2 and rec.states.shape == (2, 20954)
    readings = target.judge([rec])
    failed, check = harness.verdict([rec], readings, target.cfg["limits"])
    assert failed == 0, check
    assert check["res_rel"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
def test_span_at_fault_fails_the_judge(target, span, fault):
    """One free velocity value of the last state altered by 1e-3 (the
    middle one: a P2 vertex value, which the discrete divergence against
    P1 does not see, and whose residual hides under the three Picard
    iterations' own: ``oseen_rel`` shows it), or every state left at the
    span's start: the harness's verdict fails it."""
    rec = span[0]
    states = rec.states.copy()
    if fault == "altered":
        free = np.flatnonzero(target.us.oseen.bc_mask_u.numpy() == 0)
        states[-1, free[len(free) // 2]] += 1e-3
    else:
        states[:] = target._start[0]
    bad = dataclasses.replace(rec, states=states)
    failed, check = harness.verdict([bad], target.judge([bad]),
                                    target.cfg["limits"])
    assert failed == 1, check


def test_geometry_check_refuses_a_vertex_off_the_circle(target):
    v, c = target._mesh
    refcyl.check(v, c)
    r = np.linalg.norm(v - refcyl.CENTRE, axis=1)
    on = np.flatnonzero(np.abs(r - refcyl.RADIUS) <= 1e-12)
    assert on.size > 0
    moved = v.copy()
    i = on[0]
    moved[i] = refcyl.CENTRE + (v[i] - refcyl.CENTRE) * (
        (refcyl.RADIUS + 1e-6) / r[i])
    with pytest.raises(ValueError):
        refcyl.check(moved, c)


def test_step_and_picard_counters_and_sync_sites(span):
    """``unsteady_steps`` and ``unsteady_picard_iters`` count the span's
    steps and Oseen solves; beside the solves' own waits, ``host_syncs``
    rises by the loop's two sites a Picard iteration (the residual's norm,
    the true residual): no residual met the loop's 1e-6 before its third
    solve, so each step reads three residuals and solves three times."""
    rec, delta, solves, _ = span
    assert delta["unsteady_steps"] == rec.steps == 2
    assert delta["unsteady_picard_iters"] == len(solves) == 3 * rec.steps
    assert delta["host_syncs"] - sum(solves) == 2 * len(solves)


def test_ell_counters_count_each_products_entries(span):
    """``ell_nnz_f64`` adds the row lengths of every ELL product the span
    ran (the block product's A1 once), ``ell_vec_f64`` their vector
    entries; nothing in f32.  The products are seen where ``ELL.mv`` and
    ``ELLBlock.mv`` hand them to the kernels."""
    _, delta, _, products = span
    assert products and all(t == torch.float64 for t, _, _ in products)
    assert delta["ell_nnz_f64"] == sum(n for _, n, _ in products)
    assert delta["ell_vec_f64"] == sum(v for _, _, v in products)
    assert delta["ell_nnz_f32"] == delta["ell_vec_f32"] == 0


@pytest.fixture(scope="module")
def card_target():
    """The cell's own configuration at level 2 on the card, prepared from
    SEED with two lead steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: graphs capture the kernels' launches")
    cfg = harness.load_json(os.path.join(HERE, "configs",
                                         "cylinder-dfg2d2-l2.json"))
    cfg["solve"].update(lead_steps=2, span_steps=2)
    mod = harness.load_module(os.path.join(HERE, "configs",
                                           "cylinder-dfg2d2-l2.py"),
                              "cylinder_span_cfg_card")
    t = mod.target(cfg, torch.device("cuda"))
    t.build()
    t.prepare(SEED)
    return t


@pytest.mark.gpu
def test_graphed_span_equals_eager_on_the_card(card_target, monkeypatch):
    """The span's fieldsplit pipelines, one per Picard solve, replay CUDA
    graphs (their V-cycles smooth by minimal residuals through
    ``torch.linalg.solve_ex``): the same states, counts, winds and K3
    launches as the eager pipelines, bit for bit."""
    from fenapack_tpu_torch import measure
    t = card_target
    r0 = timing.counts["pc_graph_replays"]
    l0 = measure.launch_counts()
    graphed = t.solve()
    l1 = measure.launch_counts()
    assert timing.counts["pc_graph_replays"] - r0 >= graphed.iters - 6
    monkeypatch.setattr(t.us.oseen, "_pc_graphs", None)
    eager = t.solve()
    l2 = measure.launch_counts()
    assert graphed.ok and graphed.iters == eager.iters
    assert np.array_equal(graphed.states, eager.states)
    assert np.array_equal(graphed.winds, eager.winds)
    assert ({k: {d: l1[k][d] - l0[k][d] for d in l0[k]} for k in l0}
            == {k: {d: l2[k][d] - l1[k][d] for d in l0[k]} for k in l0})
    assert l1["ell_block_spmv"]["f64"] > l0["ell_block_spmv"]["f64"]

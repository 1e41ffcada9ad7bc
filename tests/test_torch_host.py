"""Host-side setup of the PyTorch port against the JAX package: meshes,
refinement parents, Taylor-Hood dofmaps, Dirichlet masks and BSR patterns
must be array-equal (both packages run the same NumPy/native code)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import native as tnative
from fenapack_tpu_torch.fem import dofmap as tdof
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.ops import sparse as tsparse
from fenapack_tpu_torch.solvers import gmg as tgmg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_FIELDS = ("vertices", "cells", "edges", "cell_edges", "boundary_facets",
               "facet_cells", "facet_markers")


def _jax():
    pytest.importorskip("jax")
    from fenapack_tpu.fem import dofmap, mesh
    from fenapack_tpu.ops import sparse
    from fenapack_tpu.solvers import gmg
    return mesh, dofmap, sparse, gmg


def _assert_mesh_equal(a, b):
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _inflow(x):
    v = np.zeros((x.shape[0], 2))
    v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
    return v


@pytest.mark.parametrize("level", [0, 1])
def test_step_mesh_and_hierarchy_match_jax(level):
    jmesh, _, _, jgmg = _jax()
    _assert_mesh_equal(tmesh.backward_step_mesh(level),
                       jmesh.backward_step_mesh(level))
    ht = tgmg.build_hierarchy(tmesh.backward_step_mesh(0), level)
    hj = jgmg.build_hierarchy(jmesh.backward_step_mesh(0), level)
    assert len(ht.meshes) == len(hj.meshes) == level + 1
    for a, b in zip(ht.meshes, hj.meshes):
        _assert_mesh_equal(a, b)
    for a, b in zip(ht.parents, hj.parents):
        np.testing.assert_array_equal(a, b)
    # markers survive refinement: inflow/outflow/wall facets all present
    assert set(np.unique(ht.fine.facet_markers)) == {
        tmesh.WALL, tmesh.INFLOW, tmesh.OUTFLOW}


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("level", [0, 1])
def test_taylor_hood_dofmaps_and_bcs_match_jax(level, reorder):
    jmesh, jdof, _, _ = _jax()
    mt, mj = tmesh.backward_step_mesh(level), jmesh.backward_step_mesh(level)
    Wt = tdof.TaylorHood(mt, reorder=reorder)
    Wj = jdof.TaylorHood(mj, reorder=reorder)
    assert (Wt.n2, Wt.n1, Wt.dim) == (Wj.n2, Wj.n1, Wj.dim)
    for sp in ("V", "Q"):
        a, b = getattr(Wt, sp), getattr(Wj, sp)
        np.testing.assert_array_equal(a.cell_dofs, b.cell_dofs)
        np.testing.assert_array_equal(a.dof_coords(), b.dof_coords())
        np.testing.assert_array_equal(a.vertex_dofs(), b.vertex_dofs())
        if reorder:
            np.testing.assert_array_equal(a.rank, b.rank)

    def bcs(dof, W, mesh):
        return [dof.DirichletBC.velocity(W, [mesh.WALL],
                                         lambda x: np.zeros((x.shape[0], 2))),
                dof.DirichletBC.velocity(W, [mesh.INFLOW], _inflow)]

    mask_t, vals_t = tdof.merge_bcs(bcs(tdof, Wt, tmesh), Wt.dim_u)
    mask_j, vals_j = jdof.merge_bcs(bcs(jdof, Wj, jmesh), Wj.dim_u)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(vals_t, vals_j)
    pt = tdof.DirichletBC.pressure(Wt, [tmesh.OUTFLOW])
    pj = jdof.DirichletBC.pressure(Wj, [jmesh.OUTFLOW])
    np.testing.assert_array_equal(pt.dofs, pj.dofs)


@pytest.mark.parametrize("block", [32, None])
@pytest.mark.parametrize("level", [0, 1])
def test_patterns_match_jax(level, block, monkeypatch):
    monkeypatch.setenv("FENAPACK_CACHE", "")          # fresh builds only
    jmesh, jdof, jsparse, _ = _jax()
    mesh = tmesh.backward_step_mesh(level)
    W = tdof.TaylorHood(mesh)
    cd2, cd1 = W.V.cell_dofs, W.Q.cell_dofs
    for cr, cc, nr, nc in ((cd2, cd2, W.n2, W.n2), (cd1, cd1, W.n1, W.n1),
                           (cd1, cd2, W.n1, W.n2), (cd2, cd1, W.n2, W.n1)):
        pt = tsparse.pattern_from_dofmaps(cr, cc, nr, nc, block=block,
                                          device="cpu")
        pj = jsparse.pattern_from_dofmaps(cr, cc, nr, nc, block=block)
        # the BSR positions through the dense tiles the JAX package holds
        dense = pt.dense_positions if block else np.asarray
        shape = (pt.nb, block, pt.m * block) if block else pt.value_shape
        assert shape == tuple(pj.value_shape)
        np.testing.assert_array_equal(dense(pt.entry_pos.numpy()),
                                      np.asarray(pj.entry_pos))
        if nr == nc:
            np.testing.assert_array_equal(dense(pt.diag_pos.numpy()),
                                          np.asarray(pj.diag_pos))
        if block:
            np.testing.assert_array_equal(pt.neighbours.numpy(),
                                          np.asarray(pj.nbr))
            assert pt.tile_fill == pj.fill_ratio
        else:
            np.testing.assert_array_equal(pt.cols.numpy(),
                                          np.asarray(pj.cols))


@pytest.mark.parametrize("block", [32, None])
def test_pattern_disk_cache_round_trip(block, tmp_path, monkeypatch):
    monkeypatch.setenv("FENAPACK_CACHE", str(tmp_path))
    W = tdof.TaylorHood(tmesh.backward_step_mesh(0))
    cd2, cd1 = W.V.cell_dofs, W.Q.cell_dofs
    a = tsparse.pattern_from_dofmaps(cd1, cd2, W.n1, W.n2, block=block,
                                     device="cpu")
    assert len(list(tmp_path.glob("*.npz"))) == 1
    b = tsparse.pattern_from_dofmaps(cd1, cd2, W.n1, W.n2, block=block,
                                     device="cpu")
    assert b.value_shape == a.value_shape
    np.testing.assert_array_equal(b.entry_pos.numpy(), a.entry_pos.numpy())
    vals = torch.arange(cd1.shape[0] * 18, dtype=torch.float64)
    np.testing.assert_array_equal(a.to_dense(a.assemble_values(vals)),
                                  b.to_dense(b.assemble_values(vals)))


def test_to_dense_matches_scatter_of_entries():
    """to_dense writes only the pattern's own entries: the sum of the
    element values of each (row, col) pair, zeros elsewhere."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 70, size=(50, 3))
    cols = rng.integers(0, 45, size=(50, 4))
    pat = tsparse.pattern_from_dofmaps(rows, cols, 70, 45, block=16,
                                       device="cpu")
    vals = rng.standard_normal((50, 3, 4))
    ref = np.zeros((70, 45))
    np.add.at(ref, (np.repeat(rows, 4, axis=1), np.tile(cols, (1, 3))),
              vals.reshape(50, 12))
    dense = pat.to_dense(pat.assemble_values(torch.as_tensor(vals)))
    np.testing.assert_allclose(dense.numpy(), ref, rtol=0, atol=1e-13)


def test_native_unique_and_searchsorted_match_numpy():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5000, size=20000)
    uniq, inv = tnative.unique_i64(keys)
    ref_u, ref_inv = np.unique(keys, return_inverse=True)
    np.testing.assert_array_equal(uniq, ref_u)
    np.testing.assert_array_equal(inv, ref_inv)
    q = rng.integers(0, 5000, size=1000)
    pos, hits = tnative.searchsorted_i64(uniq, q)
    np.testing.assert_array_equal(pos, np.searchsorted(uniq, q))
    assert hits == int(np.isin(q, uniq).sum())


def test_import_does_not_load_jax():
    code = ("import sys, fenapack_tpu_torch, fenapack_tpu_torch.bench, "
            "fenapack_tpu_torch.interop, fenapack_tpu_torch.cylinder, "
            "fenapack_tpu_torch.solvers.unsteady, "
            "fenapack_tpu_torch.utils.functionals, "
            "fenapack_tpu_torch.utils.io, fenapack_tpu_torch.highre, "
            "fenapack_tpu_torch.solvers.krylov, fenapack_tpu_torch.step3d, "
            "fenapack_tpu_torch.fem.mesh3d, fenapack_tpu_torch.trace, "
            "fenapack_tpu_torch.determinism, fenapack_tpu_torch.fem.forms, "
            "fenapack_tpu_torch.solvers.custom, "
            "fenapack_tpu_torch.custom_forms, "
            "fenapack_tpu_torch.navier_stokes_pcd, "
            "fenapack_tpu_torch.unsteady_channel, "
            "fenapack_tpu_torch.utils.timing, fenapack_tpu_torch.ir_ab, "
            "fenapack_tpu_torch.parallel.comm, "
            "fenapack_tpu_torch.parallel.spmd, "
            "fenapack_tpu_torch.parallel.spmd_gmg, "
            "fenapack_tpu_torch.parallel.spmd_pcd, "
            "fenapack_tpu_torch.spmd_demo, fenapack_tpu_torch.cavity, "
            "fenapack_tpu_torch.ell_ab\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('fenapack_tpu.') "
            "or m == 'fenapack_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_conftest_pins_torch_to_one_thread_beside_eight_devices():
    """The repository's ``conftest.py`` pins torch, and the environment
    every process of the run inherits, to one thread; XLA keeps its 8 CPU
    devices."""
    assert torch.get_num_threads() == 1
    assert all(os.environ[v] == "1" for v in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"))
    assert "--xla_force_host_platform_device_count=8" in os.environ[
        "XLA_FLAGS"].split()


def test_conftest_pins_blas_and_openmp_to_one_thread():
    threadpoolctl = pytest.importorskip("threadpoolctl")
    import scipy.linalg  # noqa: F401  (loads scipy's own BLAS)

    pools = threadpoolctl.threadpool_info()
    assert {p["user_api"] for p in pools} >= {"blas", "openmp"}
    assert [p["num_threads"] for p in pools] == [1] * len(pools)

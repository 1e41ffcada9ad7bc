"""The 3D host layer of the PyTorch port against the JAX package, and the
fixed-order sums that replaced ``index_add_``, on the CPU in f64.

  * tets: elements and quadrature, ``box_mesh`` topology, the step and duct
    meshes and their 1:8 refinement (parents, propagated markers) array-equal
    to the JAX package's; 3D dofmaps equal.
  * the 3D P2 transfer: exact on quadratics, and its prolongation and
    restriction equal the JAX transfer's on a random vector (1e-14).
  * the fixed-order sums: ``SegmentSum`` equals ``index_add_`` on the CPU
    bit for bit (assembly, and the Kp surface term added to volume values),
    and the ELL restrictions equal the scatter-adds they replaced within
    1e-14 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch.fem import dofmap as tdof
from fenapack_tpu_torch.fem import elements3d as tel3
from fenapack_tpu_torch.fem import mesh3d as tmesh3d
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.ops import sparse as tsparse
from fenapack_tpu_torch.solvers import gmg as tgmg

MESH3D_FIELDS = ("vertices", "cells", "edges", "cell_edges",
                 "boundary_faces", "face_cells", "face_edges",
                 "facet_markers")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jmesh3d():
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh3d
    return mesh3d


def _assert_mesh_equal(a, b):
    for f in MESH3D_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


# --------------------------------------------------------------------- #
# elements, meshes, refinement, dofmaps
# --------------------------------------------------------------------- #

def test_elements3d_match_jax():
    pytest.importorskip("jax")
    from fenapack_tpu.fem import elements3d as jel3
    for deg in (2, 4):
        qt, wt = tel3.tet_quadrature(deg)
        qj, wj = jel3.tet_quadrature(deg)
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(wt, wj)
        assert abs(wt.sum() - 1.0 / 6.0) < 1e-15
        for f in ("p1_basis", "p2_basis"):
            for a, b in zip(getattr(tel3, f)(qt), getattr(jel3, f)(qj)):
                np.testing.assert_array_equal(a, b)
    # degree 4 integrates x^2 y z exactly: 2! 1! 1! / 7! = 2 / 5040
    q, w = tel3.tet_quadrature(4)
    assert abs(w @ (q[:, 0] ** 2 * q[:, 1] * q[:, 2]) - 2 / 5040) < 1e-17


def test_box_mesh_topology_matches_jax():
    """``box_mesh(0,0,0,1,1,1,2,2,2)``: 48 positively oriented Kuhn tets of
    total volume 1 whose boundary has area 6 (``tests/test_3d.py``), and
    the same arrays as the JAX package's."""
    jm = _jmesh3d()
    mesh = tmesh3d.box_mesh(0, 0, 0, 1, 1, 1, 2, 2, 2)
    _assert_mesh_equal(mesh, jm.box_mesh(0, 0, 0, 1, 1, 1, 2, 2, 2))
    assert mesh.num_cells == 6 * 8
    p = mesh.vertices[mesh.cells]
    det = np.linalg.det(np.stack(
        [p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=1))
    assert (det > 0).all()
    assert abs(np.abs(det).sum() / 6 - 1.0) < 1e-12
    assert abs(mesh.face_areas().sum() - 6.0) < 1e-12


@pytest.mark.parametrize("name,kw", [
    ("backward_step_mesh3d", dict(length=3.0)),
    ("channel_mesh3d", dict(length=2.0)),
])
def test_meshes3d_and_refinement_match_jax(name, kw):
    """Level 0 and the 1:8 refinement (parents, propagated markers) of the
    config-4 step and the duct, array-equal; the 3D dofmaps and Dirichlet
    dofs too."""
    jm = _jmesh3d()
    from fenapack_tpu.fem import dofmap as jdof
    mt, mj = getattr(tmesh3d, name)(0, **kw), getattr(jm, name)(0, **kw)
    _assert_mesh_equal(mt, mj)
    (ft, pt), (fj, pj) = tmesh3d.refine_uniform3d(mt), jm.refine_uniform3d(mj)
    _assert_mesh_equal(ft, fj)
    np.testing.assert_array_equal(pt, pj)
    assert (ft.facet_markers > 0).all()
    ht = tgmg.build_hierarchy(mt, 1)
    _assert_mesh_equal(ht.fine, ft)
    np.testing.assert_array_equal(ht.parents[0], pj)
    Wt, Wj = tdof.TaylorHood(ft), jdof.TaylorHood(fj)
    assert (Wt.gdim, Wt.n2, Wt.n1) == (3, Wj.n2, Wj.n1)
    np.testing.assert_array_equal(Wt.V.cell_dofs, Wj.V.cell_dofs)
    np.testing.assert_array_equal(Wt.Q.cell_dofs, Wj.Q.cell_dofs)
    np.testing.assert_array_equal(Wt.V.dof_coords(), Wj.V.dof_coords())
    for m in (1, 2, 3):
        np.testing.assert_array_equal(Wt.V.facet_dofs([m]),
                                      Wj.V.facet_dofs([m]))
        np.testing.assert_array_equal(Wt.Q.facet_dofs([m]),
                                      Wj.Q.facet_dofs([m]))


# --------------------------------------------------------------------- #
# the 3D P2 transfer
# --------------------------------------------------------------------- #

def test_p2_transfer3d_reproduces_quadratics():
    """P2 prolongation is exact for quadratic fields
    (``tests/test_gmg3d.py``)."""
    coarse = tmesh3d.box_mesh(0, 0, 0, 1, 1, 1, 1, 1, 1)
    fine, _ = tmesh3d.refine_uniform3d(coarse)
    t = tgmg.P2Transfer(coarse, fine, torch.float64, device="cpu")

    def f(x):
        return (1.0 + 2 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2]
                + x[:, 0] * x[:, 1] - x[:, 2] ** 2 + 0.25 * x[:, 0] ** 2)

    xc = f(tdof.P2Space3D(coarse).dof_coords())
    xf = f(tdof.P2Space3D(fine).dof_coords())
    got = t.prolong(torch.as_tensor(xc)).numpy()
    assert np.abs(got - xf).max() <= 1e-12


def test_p2_transfer3d_matches_jax():
    """The transfer of the duct's level 0 -> 1 against the JAX package's:
    the midpoint stencil (1e-14), prolongation and restriction of a random
    vector (1e-14), and restriction as the transpose (<P x, y> = <x, R y>)."""
    jm = _jmesh3d()
    import jax.numpy as jnp
    from fenapack_tpu.solvers import gmg as jgmg
    ht = tgmg.build_hierarchy(tmesh3d.channel_mesh3d(0), 1)
    hj = jgmg.build_hierarchy(jm.channel_mesh3d(0), 1)
    tt = tgmg.P2Transfer(*ht.meshes, torch.float64, device="cpu")
    tj = jgmg.P2Transfer(*hj.meshes, jnp.float64)
    np.testing.assert_array_equal(tt.mid_dofs.numpy(),
                                  np.asarray(tj.mid_dofs))
    assert _rel(tt.mid_w.numpy(), tj.mid_w) <= 1e-14
    rng = np.random.default_rng(3)
    xc, rf = rng.standard_normal(tt.n_coarse), rng.standard_normal(tt.n_fine)
    p = tt.prolong(torch.as_tensor(xc))
    r = tt.restrict(torch.as_tensor(rf))
    assert _rel(p.numpy(), tj.prolong(jnp.asarray(xc))) <= 1e-14
    assert _rel(r.numpy(), tj.restrict(jnp.asarray(rf))) <= 1e-14
    lhs, rhs = float(p @ torch.as_tensor(rf)), float(torch.as_tensor(xc) @ r)
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


# --------------------------------------------------------------------- #
# the fixed-order sums
# --------------------------------------------------------------------- #

def test_segment_sum_is_index_add_on_the_cpu():
    """``SegmentSum`` adds each target's entries in entry order, as
    ``index_add_`` does on the CPU: bit-for-bit equal, with and without a
    base, on indices with skewed multiplicities."""
    rng = np.random.default_rng(0)
    size = 300
    index = rng.integers(0, size, size=4000) ** 2 % size   # skewed
    src = torch.as_tensor(rng.standard_normal(index.shape[0]) * 1e3)
    base = torch.as_tensor(rng.standard_normal(size))
    s = tsparse.SegmentSum(index, size, device="cpu")
    assert len(s.lengths) == np.bincount(index).max()
    idx = torch.as_tensor(index)
    ref = torch.zeros(size, dtype=torch.float64).index_add_(0, idx, src)
    assert torch.equal(s(src), ref)
    assert torch.equal(s(src, base=base), base.clone().index_add_(0, idx,
                                                                  src))


def test_fixed_order_assembly_and_restriction_equal_index_add():
    """On the duct's level-1 hierarchy: every assembled operator (P2 A1 at
    a random wind, Kp with its surface term, the constant D) equals the
    scatter-add of the same element values bit for bit, and the ELL
    restrictions (P2, P1, p-coarse) equal the scatter-adds they replaced
    within 1e-14 relative."""
    ht = tgmg.build_hierarchy(tmesh3d.channel_mesh3d(0), 1)
    asm = NSAssembler(ht.fine, 0.1, device="cpu", quad_degree=4)
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal(3 * asm.n2))
    # assembly: element values through the pattern, and through index_add_
    pat = asm.pat_p2
    elem = torch.as_tensor(rng.standard_normal((asm.nc, 10, 10)))
    old = torch.zeros(pat.value_size, dtype=torch.float64).index_add_(
        0, pat.entry_pos, elem.reshape(-1)).reshape(pat.value_shape)
    assert torch.equal(pat.assemble_values(elem), old)
    # Kp: surface entries added to the volume values
    vol = asm.kp_values(u).reshape(-1)
    f_cd1 = asm._cd1_np[ht.fine.face_cells[
        ht.fine.facet_markers == tmesh3d.INFLOW]]
    pos = torch.as_tensor(asm.pat_p1.entry_positions(f_cd1, f_cd1))
    surf = torch.as_tensor(rng.standard_normal(pos.shape[0]))
    assert torch.equal(asm.kp_surf_sum(surf, base=vol),
                       vol.clone().index_add_(0, pos, surf))
    assert not torch.equal(asm.kp_values(u, surface=True).reshape(-1), vol)
    # restrictions: P2 (3D, 8 children), P1 and p-coarse
    t2 = tgmg.P2Transfer(*ht.meshes, torch.float64, device="cpu")
    rf = torch.as_tensor(rng.standard_normal(t2.n_fine))
    z = rf[:t2.n_coarse].clone().index_add_(
        0, t2.mid_dofs.reshape(-1),
        (t2.mid_w * rf[t2.n_coarse:, None]).reshape(-1))
    assert _rel(t2.restrict(rf).numpy(), z.numpy()) <= 1e-14
    t1 = tgmg.P1Transfer(ht.parents[0], ht.meshes[0].num_vertices,
                         torch.float64, device="cpu")
    rp = torch.as_tensor(rng.standard_normal(t1.n_fine))
    z = torch.zeros(t1.n_coarse, dtype=torch.float64)
    z.index_add_(0, t1.pa, 0.5 * rp).index_add_(0, t1.pb, 0.5 * rp)
    assert _rel(t1.restrict(rp).numpy(), z.numpy()) <= 1e-14
    tp = tgmg.PCoarseTransfer(asm.W, device="cpu")
    ru = torch.as_tensor(rng.standard_normal(asm.n2))
    z = torch.zeros(asm.n1, dtype=torch.float64)
    z.index_add_(0, tp._IA, 0.5 * ru).index_add_(0, tp._IB, 0.5 * ru)
    assert _rel(tp.restrict(ru).numpy(), z.numpy()) <= 1e-14

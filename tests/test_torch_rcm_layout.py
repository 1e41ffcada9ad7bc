"""The dof order of the port's layouts, on the CPU: the main path's BSR
operators and transfers (``bench.build``, every level in its RCM order)
store fewer tile slots per nonzero than the natural order would; every ELL
assembler and hierarchy keeps the natural order; the tracing counters
``bsr_slots`` / ``bsr_nnz`` add what a BSR product reads, and only while
tracing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import bench, measure
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem import mesh3d
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.fem.dofmap import TaylorHood
from fenapack_tpu_torch.models import LidDrivenCavity, StepFlow3D
from fenapack_tpu_torch.ops.sparse import BlockELL, SparsityPattern
from fenapack_tpu_torch.solvers import gmg
from fenapack_tpu_torch.utils import timing


@pytest.fixture(scope="module")
def main_path():
    """``bench.build(1)`` and the natural order's assembler on its mesh."""
    nl = bench.build(1, device="cpu")
    natural = NSAssembler(nl.asm.mesh, bench.NU, device="cpu",
                          block_size=bench.BLOCK, hi_block=True,
                          reorder=False)
    return nl, natural


def _fill(op) -> float:
    """Stored tile slots per nonzero of a BSR operator."""
    return op.tiles.numel() / op.nnz


@pytest.mark.parametrize("name", ["pat_p2", "pat_p1", "pat_div",
                                  "pat_divT"])
def test_main_path_patterns_store_less_fill(main_path, name):
    nl, natural = main_path
    assert nl.asm.W.reorder and not natural.W.reorder
    rcm, nat = getattr(nl.asm, name), getattr(natural, name)
    assert rcm.nnz == nat.nnz and rcm.block == nat.block == bench.BLOCK
    assert rcm.fill_ratio < nat.fill_ratio
    assert _fill(rcm.matrix(torch.zeros(rcm.value_shape))) == \
        pytest.approx(rcm.fill_ratio)


def test_main_path_transfers_store_less_fill(main_path):
    """Every velocity transfer below its natural-order twin; the pressure
    transfers no worse (at level 1 the coarse pressure level is seven
    block rows in either order)."""
    nl, _ = main_path
    vh, ph = nl.oseen.velocity_hierarchy, nl.oseen.ap_hierarchy
    hier = vh.hier
    assert vh.reorder and ph.reorder
    for l, t in enumerate(vh.transfers):
        nat = gmg.P2Transfer(hier.meshes[l], hier.meshes[l + 1],
                             torch.float32, device="cpu",
                             block_size=bench.BLOCK)
        assert _fill(t._P) < _fill(nat._P)
        assert _fill(t._PT) < _fill(nat._PT)
    for l, t in enumerate(ph.transfers):
        nat = gmg.P1Transfer(hier.parents[l], hier.meshes[l].num_vertices,
                             torch.float32, device="cpu",
                             block_size=bench.BLOCK)
        assert _fill(t._P) <= _fill(nat._P)
        assert _fill(t._PT) <= _fill(nat._PT)


@pytest.mark.parametrize("mesh", [
    lambda: tmesh.backward_step_mesh(0), lambda: tmesh.cavity_mesh(0),
    lambda: mesh3d.channel_mesh3d(0)], ids=["step", "cavity", "duct3d"])
def test_ell_assemblers_keep_the_natural_order(mesh):
    m = mesh()
    natural = TaylorHood(m)
    for kw in ({}, {"p1_only": True}, {"row_align": 8}):
        asm = NSAssembler(m, 0.1, device="cpu", quad_degree=4, **kw)
        assert asm.block_size is None and not asm.W.reorder
        np.testing.assert_array_equal(asm.W.V.cell_dofs,
                                      natural.V.cell_dofs)
        np.testing.assert_array_equal(asm.W.Q.cell_dofs,
                                      natural.Q.cell_dofs)


@pytest.mark.parametrize("problem", [
    lambda: LidDrivenCavity(level=1, nu=0.01, device="cpu"),
    lambda: StepFlow3D(level=1, nu=0.02, device="cpu")],
    ids=["cavity", "step3d"])
def test_ell_hierarchies_keep_the_natural_order(problem):
    nl = problem().solver(gmg_subsolves=True)
    vh, ph = nl.oseen.velocity_hierarchy, nl.oseen.ap_hierarchy
    assert not (nl.asm.W.reorder or vh.reorder or ph.reorder)
    for t in vh.transfers:
        x = torch.arange(t.n_fine, dtype=torch.float64)
        assert torch.equal(t.inject(x), x[:t.n_coarse])
    for asm in vh.asms + [lev.asm for lev in ph.levels]:
        assert not asm.W.reorder


def test_bsr_counters_add_one_products_read(main_path):
    nl, _ = main_path
    pat = nl.asm.pat_p2
    op = pat.matrix(torch.ones(pat.value_shape))
    x = torch.ones(pat.n_cols)
    c0 = measure.host_counts()
    op.mv(x)
    c1 = measure.host_counts()
    assert c1["bsr_slots"] == c0["bsr_slots"]
    assert c1["bsr_nnz"] == c0["bsr_nnz"]
    with timing.tracing():
        op.mv(x)
        op.with_vals(op.tiles).mv(torch.ones(pat.n_cols, 3))
    c2 = measure.host_counts()
    assert c2["bsr_slots"] - c1["bsr_slots"] == 2 * pat.nb * pat.m * 32 * 32
    assert c2["bsr_nnz"] - c1["bsr_nnz"] == 2 * pat.nnz
    # an ELL product and a BSR matrix built without its pattern's count
    # add nothing
    ell = SparsityPattern(np.arange(4), np.arange(4), 4, 4, device="cpu")
    with timing.tracing():
        ell.matrix(torch.ones(ell.value_shape)).mv(torch.ones(4))
        BlockELL(op.nbr, op.tiles, op.n_rows, op.n_cols).mv(x)
    assert measure.host_counts() == c2

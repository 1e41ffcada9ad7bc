"""The frozen roofline arithmetic counts an operator's entries: one matrix
costs the same bytes as ELL (padded), CSR and BSR (b = 32), on real
level-0 patterns of the port's 2D and 3D steps."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pcdbench import roofline
from pcdbench.trace import SpmvScopes


def _dofmaps(which):
    from fenapack_tpu_torch.fem import mesh as meshmod, mesh3d
    from fenapack_tpu_torch.fem.dofmap import TaylorHood
    m = (meshmod.backward_step_mesh(0) if which == "step2d"
         else mesh3d.backward_step_mesh3d(0, length=9.0))
    W = TaylorHood(m)
    return (W.V.cell_dofs.astype(np.int64), W.V.dim,
            W.Q.cell_dofs.astype(np.int64), W.Q.dim)


@pytest.mark.parametrize("which", ["step2d", "step3d"])
@pytest.mark.parametrize("space", ["p2", "div"])
def test_one_matrix_same_bytes_in_every_layout(which, space):
    from fenapack_tpu_torch.ops.sparse import pattern_from_dofmaps
    cd2, n2, cd1, n1 = _dofmaps(which)
    rows_d, cols_d, nr, nc = ((cd2, cd2, n2, n2) if space == "p2"
                              else (cd1, cd2, n1, n2))
    ell = pattern_from_dofmaps(rows_d, cols_d, nr, nc, device="cpu")
    bsr = pattern_from_dofmaps(rows_d, cols_d, nr, nc, block=32,
                               device="cpu")
    a, b = rows_d.shape[1], cols_d.shape[1]
    coo_r = np.repeat(rows_d, b, axis=1).ravel()
    coo_c = np.tile(cols_d, (1, a)).ravel()
    csr = sp.coo_matrix((np.ones(coo_r.shape[0]), (coo_r, coo_c)),
                        shape=(nr, nc)).tocsr()
    nnz = SpmvScopes()._entries()
    n_ell, n_bsr = nnz[ell.cols.data_ptr()], nnz[bsr.nbr.data_ptr()]
    assert n_ell == n_bsr == csr.nnz
    # the layouts themselves hold more: ELL padding, BSR tile fill
    assert ell.cols.numel() > csr.nnz
    assert bsr.nb * bsr.m * 32 * 32 > csr.nnz
    costs = {roofline.single(n, nr, nc, 1, 8, 8) for n in (n_ell, n_bsr,
                                                          csr.nnz)}
    assert len(costs) == 1
    (nbytes, flops), = costs
    assert nbytes == csr.nnz * 12 + (nr + nc) * 8
    assert flops == 2 * csr.nnz


def test_scoped_calls_add_the_entries_least_time():
    from fenapack_tpu_torch.ops.sparse import pattern_from_dofmaps
    cd2, n2, _, _ = _dofmaps("step2d")
    rng = np.random.default_rng(0)
    ell = pattern_from_dofmaps(cd2, cd2, n2, n2, device="cpu")
    bsr = pattern_from_dofmaps(cd2, cd2, n2, n2, block=32, device="cpu")
    vals = torch.as_tensor(rng.standard_normal(cd2.shape + (6,)))
    A, B = ell.assemble(vals), bsr.assemble(vals)
    x = torch.as_tensor(rng.standard_normal(n2))
    xb = torch.as_tensor(rng.standard_normal((2, n2)))
    with SpmvScopes() as s:
        ya, yb = A.mv(x), B.mv(x)
        yk = ell.block_matrix(A.vals).mv(xb)
    torch.testing.assert_close(ya, yb)
    torch.testing.assert_close(yk[1], A.mv(xb[1]))
    one = roofline.least_s(*roofline.single(ell.nnz, n2, n2, 1, 8, 8), 8)
    blk = roofline.least_s(*roofline.block(ell.nnz, n2, n2, 2, False,
                                           False, 8, 8), 8)
    assert s.unknown == 0 and dict(s.calls) == {"ell": 1, "bsr": 1,
                                                "ell_block": 1}
    assert s.least_s == pytest.approx(2 * one + blk, rel=1e-12)
    # the scopes restore the dispatch points
    from fenapack_tpu_torch.ops import sparse
    from fenapack_tpu_torch.ops.ell_spmv import ell_spmv
    assert sparse.ell_spmv is ell_spmv

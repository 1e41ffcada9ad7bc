"""Row-block distributed geometric multigrid: pressure Laplacian and
velocity convection-diffusion.

The port of ``fenapack_tpu/parallel/spmd_gmg.py``: the single-device
V-cycles of :mod:`fenapack_tpu_torch.solvers.gmg` as rank-local compute
plus collectives (:mod:`.comm`).

  * Every level is row-block partitioned over the ranks after its own RCM
    relabeling, so the level operator is one ring hop
    (:class:`.spmd.RingHaloELL`); a level whose RCM bandwidth exceeds a
    rank's block (small and 3D levels) falls back to the all-gather
    product (:class:`.spmd.RowBlockELL`).
  * The orderings of two levels are unrelated, so prolongation all-gathers
    the coarse vector and applies the rank's rows of the prolongation;
    restriction applies the rank's columns of its transpose to the rank's
    fine block and all-reduces the partial coarse vectors.  Both are ELL
    matrices applied by K3 (rows summed in a fixed order).
  * The coarsest level is solved by a replicated dense inverse: every rank
    holds it (the velocity one is rebuilt from the wind on every rank).
    The restriction onto it is all-reduced, so every rank holds the whole
    coarse right-hand side and then the whole correction: neither is
    all-gathered again (the JAX package slices and re-gathers both; the
    values are the same).  A smoothing pass that starts from zero takes
    ``b`` as its residual instead of computing ``b - A 0`` (the same bits,
    one halo exchange fewer).

Vectors are rank blocks: pressure ``(loc,)``; velocity ``(d * loc,)`` with
the components one after the other, ``[ux_i | uy_i (| uz_i)]``.
"""
from __future__ import annotations


import numpy as np
import torch

from ..fem.dofmap import rcm_rank
from ..ops.ell_spmv import ell_block_spmv, ell_spmv
from .spmd import (RingHaloELL, RowBlockELL, _np, local_rows,
                   psum_minres_smooth)


class _HostELL:
    """Host ELL arrays in the shape the ring layouts read."""

    def __init__(self, cols: np.ndarray, vals: np.ndarray, n_cols: int):
        self.cols, self.vals, self.n_cols = cols, vals, n_cols


def _ring_or_gather(ell: _HostELL, n_dev: int):
    """One-hop ring layout, else the all-gather fallback (small and
    coarse levels, 3D especially, whose RCM bandwidth exceeds a rank's
    column block)."""
    try:
        return RingHaloELL(ell, n_dev)
    except ValueError:
        return RowBlockELL(ell, n_dev)


def _local_transfer(P_cols: np.ndarray, P_w: np.ndarray, rank: int,
                    loc_f: int, n_coarse: int, dtype, device):
    """The rank's rows of the prolongation (``loc_f`` x ``n_coarse``, ELL)
    and the matching columns of its transpose, the restriction
    (``n_coarse`` x ``loc_f``, ELL; each coarse row sums its fine entries
    in fine-row order, weight-0 entries left out).  Returns
    ``(P_cols, P_vals, R_cols, R_vals)`` on ``device``."""
    rows = slice(rank * loc_f, (rank + 1) * loc_f)
    pc, pw = P_cols[rows], P_w[rows]
    fine = np.repeat(np.arange(loc_f), pc.shape[1])
    coarse, w = pc.ravel(), pw.ravel()
    keep = w != 0
    fine, coarse, w = fine[keep], coarse[keep], w[keep]
    order = np.lexsort((fine, coarse))
    fine, coarse, w = fine[order], coarse[order], w[order]
    counts = np.bincount(coarse, minlength=n_coarse)
    K = max(int(counts.max(initial=0)), 1)
    start = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(coarse.shape[0]) - start[coarse]
    R_cols = np.zeros((n_coarse, K), dtype=np.int32)
    R_vals = np.zeros((n_coarse, K))
    R_cols[coarse, slot] = fine
    R_vals[coarse, slot] = w
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
    return (t(pc, torch.int32), t(pw, dtype), t(R_cols, torch.int32),
            t(R_vals, dtype))


def _restrict(comm, tr, r_loc: torch.Tensor) -> torch.Tensor:
    """Partial coarse vector(s) of the rank's fine block, summed over the
    ranks: ``(n_coarse,)`` or ``(d, n_coarse)``."""
    _, _, R_cols, R_vals = tr
    nf = r_loc.shape[-1]
    if r_loc.dim() == 1:
        rc = ell_spmv(R_cols, R_vals, r_loc.contiguous(), nf)
    else:
        rc = ell_block_spmv(R_cols, R_vals, None, r_loc.contiguous(), nf)
    return comm.allreduce_sum(rc)


def _prolong(tr, ec_full: torch.Tensor) -> torch.Tensor:
    """The rank's rows of the prolongation of the global coarse vector(s)."""
    P_cols, P_vals, _, _ = tr
    n = ec_full.shape[-1]
    if ec_full.dim() == 1:
        return ell_spmv(P_cols, P_vals, ec_full.contiguous(), n)
    return ell_block_spmv(P_cols, P_vals, None, ec_full.contiguous(), n)


class _Level:
    """One pressure level: the relabeled, padded operator (identity rows on
    the padding), its ring layout, Jacobi data and mask, and the rank's
    blocks of them on the device."""

    def __init__(self, ell, mask, n_real: int, comm, dtype,
                 rank: np.ndarray, device):
        n_dev = comm.size
        self.n_real = n_real
        self.rank = rank                          # old -> new (unpadded ids)
        n_pad = -(-n_real // n_dev) * n_dev
        self.n_pad = n_pad

        cols = _np(ell.cols)
        vals = _np(ell.vals).astype(np.float64)
        K = cols.shape[1]
        new_cols = np.zeros((n_pad, K), dtype=np.int32)
        new_vals = np.zeros((n_pad, K))
        inv = np.argsort(rank)                    # new -> old
        nc_r = rank[cols[inv]]
        valid = vals[inv] != 0
        new_cols[:n_real] = np.where(valid, nc_r, 0)
        new_vals[:n_real] = np.where(valid, vals[inv], 0.0)
        for i in range(n_real, n_pad):            # identity padding rows
            new_cols[i, 0] = i
            new_vals[i, 0] = 1.0
        self.new_cols, self.new_vals = new_cols, new_vals
        self.ring = _ring_or_gather(_HostELL(new_cols, new_vals, n_pad),
                                    n_dev)

        diag = np.zeros(n_pad)
        dmask = new_cols == np.arange(n_pad)[:, None]
        np.add.at(diag, np.where(dmask)[0], new_vals[dmask])
        m = np.zeros(n_pad)
        if mask is not None:
            m[:n_real] = _np(mask)[inv]
        m[n_real:] = 1.0                          # padding rows pinned
        diag = np.where(m > 0, 1.0, np.where(diag != 0, diag, 1.0))
        self.mask_np = m
        loc = self.ring.n_loc
        r = comm.rank
        t = lambda a, dt=dtype: torch.as_tensor(
            np.ascontiguousarray(a[r * loc:(r + 1) * loc]), dtype=dt,
            device=device)
        self.vals_loc = t(new_vals)
        self.cols_loc = t(self.ring.cols_ext, torch.int32)
        self.dinv_loc = t(1.0 / diag)
        self.mask_loc = t(m)


class SPMDPressureGMG:
    """Distributed V-cycle for the PCD ``Ap`` subsolve.

    Built from a single-device :class:`solvers.gmg.PressureHierarchy`;
    :meth:`solve_local` runs on every rank on the rank's block of a vector
    in THIS object's fine ordering (``fine_rank`` maps the fine level's
    dof ids to it; padded to ``levels[-1].n_pad``)."""

    def __init__(self, hierarchy, comm, *, dtype=torch.float64,
                 smooth_iters: int = 2, cycles: int = 1,
                 omega: float = 0.67):
        self.comm = comm
        self.smooth_iters, self.cycles, self.omega = smooth_iters, cycles, \
            omega
        self.n_dev = n_dev = comm.size
        self.dtype = dtype
        device = hierarchy.levels[-1].Ap.vals.device
        self.device = device

        self.levels = []
        for lev in hierarchy.levels:
            n_real = lev.asm.n1_real
            rank = rcm_rank(np.asarray(lev.asm.W.Q.cell_dofs), n_real)
            self.levels.append(_Level(lev.Ap, lev.mask, n_real, comm, dtype,
                                      rank, device))
        self.fine_rank = self.levels[-1].rank

        # transfers: fine new id <- its parents' coarse new ids, weight 1/2
        # (0 on padding rows)
        self.transfers = []
        for l, t in enumerate(hierarchy.transfers):
            fine, coarse = self.levels[l + 1], self.levels[l]
            pa, pb = _np(t.pa), _np(t.pb)
            inv_f = np.argsort(fine.rank)
            P_cols = np.zeros((fine.n_pad, 2), dtype=np.int64)
            P_w = np.zeros((fine.n_pad, 2))
            P_cols[:fine.n_real, 0] = coarse.rank[pa[inv_f]]
            P_cols[:fine.n_real, 1] = coarse.rank[pb[inv_f]]
            P_w[:fine.n_real] = 0.5
            self.transfers.append(_local_transfer(
                P_cols, P_w, comm.rank, fine.ring.n_loc, coarse.n_pad,
                dtype, device))

        # replicated dense coarse inverse (relabeled, padded)
        l0 = self.levels[0]
        A = np.zeros((l0.n_pad, l0.n_pad))
        rows = np.repeat(np.arange(l0.n_pad), l0.new_cols.shape[1])
        np.add.at(A, (rows, l0.new_cols.ravel()), l0.new_vals.ravel())
        m0 = l0.mask_np
        free = 1.0 - m0
        A = free[:, None] * A * free[None, :] + np.diag(m0)
        if not m0[:l0.n_real].any():
            # pure-Neumann coarse operator: rank-1 constant regularization
            A = A + np.outer(free, free) / max(free.sum(), 1.0)
        self.coarse_inv = torch.as_tensor(np.linalg.inv(A), dtype=dtype,
                                          device=device)
        self._mask0 = torch.as_tensor(m0, dtype=dtype, device=device)

    # ---------------------------------------------------------------- #
    def _mv_masked(self, lvl, x_loc):
        """Symmetric bc-eliminated level operator: free A free + I_bc."""
        lv = self.levels[lvl]
        free = 1.0 - lv.mask_loc
        y = lv.ring.mv_local(self.comm, lv.vals_loc, lv.cols_loc,
                             free * x_loc)
        return free * y + lv.mask_loc * x_loc

    def _smooth_local(self, lvl, b_loc, x_loc, iters):
        """Damped Jacobi sweeps; ``x_loc`` None stands for zeros."""
        lv = self.levels[lvl]
        for _ in range(iters):
            if x_loc is None:
                x_loc = self.omega * lv.dinv_loc * b_loc
                continue
            r = b_loc - self._mv_masked(lvl, x_loc)
            x_loc = x_loc + self.omega * lv.dinv_loc * r
        return x_loc

    def _cycle_local(self, lvl, b_loc):
        comm = self.comm
        if lvl == 0:
            b_full = comm.all_gather(b_loc).reshape(-1)
            x_full = self.coarse_inv @ b_full
            n_loc = self.levels[0].ring.n_loc
            return x_full[comm.rank * n_loc:(comm.rank + 1) * n_loc]
        lv = self.levels[lvl]
        tr = self.transfers[lvl - 1]
        free = 1.0 - lv.mask_loc
        x = self._smooth_local(lvl, b_loc, None, self.smooth_iters)
        if x is None:
            x = torch.zeros_like(b_loc)
        r = free * (b_loc - self._mv_masked(lvl, x))
        coarse = self.levels[lvl - 1]
        nc_loc = coarse.ring.n_loc
        rc = _restrict(comm, tr, r)
        if lvl == 1:
            # the whole coarse system on every rank: no re-gather
            ec = self.coarse_inv @ (rc * (1.0 - self._mask0))
        else:
            rc_loc = rc[comm.rank * nc_loc:(comm.rank + 1) * nc_loc] \
                * (1.0 - coarse.mask_loc)
            ec_loc = self._cycle_local(lvl - 1, rc_loc)
            ec = comm.all_gather(ec_loc).reshape(-1)
        x = x + free * _prolong(tr, ec)
        return self._smooth_local(lvl, b_loc, x, self.smooth_iters)

    def solve_local(self, b_loc: torch.Tensor) -> torch.Tensor:
        """V-cycle(s) on the fine level from the rank's block."""
        L = len(self.levels)
        x = self._cycle_local(L - 1, b_loc)
        for _ in range(self.cycles - 1):
            r = b_loc - self._mv_masked(L - 1, x)
            x = x + self._cycle_local(L - 1, r)
        return x


# --------------------------------------------------------------------- #
# velocity (P2 vector) multigrid: wind-dependent level operators
# --------------------------------------------------------------------- #

def _pattern_used(pat) -> np.ndarray:
    """(n_rows, K) bool: the pattern's structural ELL slots."""
    used = np.zeros(pat.value_shape, dtype=bool).reshape(-1)
    used[np.asarray(pat._upos)] = True
    return used.reshape(pat.value_shape)


class SPMDVelocityGMG:
    """Distributed V-cycle for the velocity convection-diffusion block.

    The distributed form of :func:`solvers.gmg.make_velocity_gmg_from_wind`
    (its natural-ordered :class:`VelocityHierarchy`): per-level RCM ring
    layouts built once from the P2 pattern (structural, so every wind
    reuses them), P2 transfers through all-gathered coarse vectors,
    minimal-residual smoothing (the level operators are nonsymmetric) with
    all-reduced Gram systems, and a replicated dense coarse inverse rebuilt
    from the wind.  ``supg``, ``theta``, ``inv_dt`` and ``newton`` (the
    (d, d) reaction blocks, re-discretized per level, and a coupled dense
    coarse inverse) follow the JAX package.  A level product is one block
    product (A1 on every component plus the reaction blocks) over the
    level's shared columns."""

    def __init__(self, vh, comm, *, dtype=torch.float64,
                 smooth_iters: int = 4, cycles: int = 1, supg: bool = False,
                 theta: float = 1.0, inv_dt: float = 0.0,
                 newton: bool = False):
        self.vh, self.comm, self.dtype = vh, comm, dtype
        self.smooth_iters, self.cycles = smooth_iters, cycles
        self.supg, self.newton = supg, newton
        self.theta, self.inv_dt = float(theta), float(inv_dt)
        self.n_dev = n_dev = comm.size
        self.d = d = vh.asms[0].dim
        dev = self.device = vh.asms[-1].device
        r = comm.rank

        self.lv = []
        for l, asm in enumerate(vh.asms):
            n2 = asm.n2_real
            rank = rcm_rank(np.asarray(asm.W.V.cell_dofs), n2)
            n_pad = -(-n2 // n_dev) * n_dev
            inv = np.argsort(rank)
            pat = asm.pat_p2
            cols = pat._ell_cols_np
            used = _pattern_used(pat)
            K = cols.shape[1]
            new_cols = np.zeros((n_pad, K), dtype=np.int32)
            new_used = np.zeros((n_pad, K), dtype=bool)
            new_cols[:n2] = np.where(used[inv], rank[cols[inv]], 0)
            new_used[:n2] = used[inv]
            for i in range(n2, n_pad):            # identity padding rows
                new_cols[i, 0] = i
                new_used[i, 0] = True
            ring = _ring_or_gather(
                _HostELL(new_cols, new_used.astype(np.float64), n_pad),
                n_dev)
            m = np.zeros(n_pad)
            m[:n2] = _np(vh.masks[l])[:n2][inv]
            m[n2:] = 1.0
            loc = n_pad // n_dev
            rows = slice(r * loc, (r + 1) * loc)
            lvd = dict(asm=asm, n2=n2, n_pad=n_pad, loc=loc, rank=rank,
                       inv=inv, used=used, ring=ring, K=K, mask_s=m,
                       cols_loc=torch.as_tensor(ring.cols_ext[rows],
                                                device=dev),
                       mask_loc=torch.as_tensor(
                           np.concatenate([m[rows]] * d), dtype=dtype,
                           device=dev),
                       mask_full=torch.as_tensor(m, dtype=dtype,
                                                 device=dev))
            # device index maps of the per-wind binding
            lvd["inv_t"] = torch.as_tensor(inv, device=dev)
            lvd["used_inv_t"] = torch.as_tensor(used[inv], device=dev)
            lvd["diag_pos_t"] = pat.diag_pos
            if l == 0:
                urow, ucol = np.asarray(pat._urow), np.asarray(pat._ucol)
                keep = (urow < n2) & (ucol < n2)
                lvd["upos_t"] = torch.as_tensor(
                    np.asarray(pat._upos)[keep], device=dev)
                lvd["rr_t"] = torch.as_tensor(rank[urow[keep]], device=dev)
                lvd["cc_t"] = torch.as_tensor(rank[ucol[keep]], device=dev)
            self.lv.append(lvd)

        # transfers: prolongation stencils in the relabeled orderings
        self.tr = []
        for l, t in enumerate(vh.transfers):
            fine, coarse = self.lv[l + 1], self.lv[l]
            n2f, npf = fine["n2"], fine["n_pad"]
            mid_dofs, mid_w = _np(t.mid_dofs), _np(t.mid_w)
            nb2 = mid_dofs.shape[1]
            P_cols = np.zeros((npf, nb2), dtype=np.int64)
            P_w = np.zeros((npf, nb2))
            n_c = t.n_coarse
            nat = fine["inv"]                # fine natural id at new pos
            is_vert = nat < n_c
            P_cols[:n2f][is_vert, 0] = coarse["rank"][nat[is_vert]]
            P_w[:n2f][is_vert, 0] = 1.0
            mids = nat[~is_vert] - n_c
            P_cols[:n2f][~is_vert] = coarse["rank"][mid_dofs[mids]]
            P_w[:n2f][~is_vert] = mid_w[mids]
            self.tr.append(_local_transfer(P_cols, P_w, r, fine["loc"],
                                           coarse["n_pad"], dtype, dev))

    # ---------------------------------------------------------------- #
    def _local(self, l, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a padded level array."""
        loc = self.lv[l]["loc"]
        return local_rows(t, self.comm.rank, loc)

    def bind_operands(self, wind_fine_nat: torch.Tensor) -> dict:
        """The wind-dependent operands on the device: per level the rank's
        block of the relabeled A1 values (identity on the padding), the
        reaction planes (Newton), the Jacobi inverse diagonal, and the
        replicated dense coarse inverse.  ``wind_fine_nat`` is the stacked
        ``(d * n2_fine,)`` velocity in the fine level's natural order."""
        d, dt = self.d, self.dtype
        levels = [None] * len(self.lv)
        ops = {"levels": levels, "coarse_inv": None}
        wl = wind_fine_nat.to(dt)
        for l in reversed(range(len(self.lv))):
            lvd = self.lv[l]
            asm = lvd["asm"]
            n2, n_pad, K = lvd["n2"], lvd["n_pad"], lvd["K"]
            wind_c = None
            if l > 0:
                nc = self.vh.transfers[l - 1].n_coarse
                wind_c = torch.cat([wl[a * n2:a * n2 + nc]
                                    for a in range(d)])
            A1 = asm.picard_matrix_values(wl).to(dt)
            if self.theta != 1.0 or self.inv_dt != 0.0:
                A1 = (self.theta * A1
                      + self.inv_dt * asm.mass2(hi=False).vals.to(dt))
            if self.supg:
                A1 = A1 + asm.supg_values(wl).to(dt)
            inv, used_inv = lvd["inv_t"], lvd["used_inv_t"]
            nv = torch.zeros((n_pad, K), dtype=dt, device=A1.device)
            nv[:n2] = torch.where(used_inv, A1[inv], 0.0)
            nv[n2:, 0] = 1.0
            diag = torch.ones(n_pad, dtype=dt, device=A1.device)
            diag[:n2] = A1.reshape(-1)[lvd["diag_pos_t"]][inv]
            m = torch.as_tensor(lvd["mask_s"], dtype=dt, device=A1.device)
            R = Rloc = None
            if self.newton:
                R = asm.newton_reaction_values(wl).to(dt)
                if self.theta != 1.0:
                    R = self.theta * R
                Rpk = torch.zeros((d, d, n_pad, K), dtype=dt,
                                  device=A1.device)
                Rpk[:, :, :n2] = torch.where(used_inv, R[:, :, inv], 0.0)
                Rloc = self._local(l, Rpk.movedim(2, 0)).movedim(0, 2)
                Rloc = Rloc.contiguous()
            comps = []
            for a in range(d):
                da = diag
                if R is not None:
                    da = diag.clone()
                    da[:n2] += R[a, a].reshape(-1)[lvd["diag_pos_t"]][inv]
                da = torch.where(m > 0, 1.0, torch.where(da != 0, da, 1.0))
                comps.append(self._local(l, 1.0 / da))
            levels[l] = (self._local(l, nv), torch.cat(comps), Rloc)
            if l == 0:
                ops["coarse_inv"] = self._coarse_inverse(lvd, A1, R, m)
            wl = wind_c
        return ops

    def build_operands(self, wind_fine_nat) -> dict:
        """:meth:`bind_operands` from a host or device wind."""
        return self.bind_operands(torch.as_tensor(
            wind_fine_nat, device=self.device))

    def _coarse_inverse(self, lvd, A1, R, m):
        """Dense inverse of the masked coarse operator: block-diagonal over
        the components for Picard (one scalar inverse), coupled over them
        for Newton."""
        d, dt = self.d, self.dtype
        n2, n_pad = lvd["n2"], lvd["n_pad"]
        upos, rr, cc = lvd["upos_t"], lvd["rr_t"], lvd["cc_t"]

        def dense_of(flat_vals):
            Ar = torch.zeros((n_pad, n_pad), dtype=dt, device=A1.device)
            Ar[rr, cc] = flat_vals.reshape(-1)[upos].to(dt)
            return Ar

        Ar = dense_of(A1)
        idx = torch.arange(n2, n_pad, device=A1.device)
        Ar[idx, idx] = 1.0
        if R is None:
            free = 1.0 - m
            Am = free[:, None] * Ar * free[None, :] + torch.diag(m)
            return torch.linalg.inv(Am)
        blocks = [[Ar + dense_of(R[a, a]) if a == b else dense_of(R[a, b])
                   for b in range(d)] for a in range(d)]
        A_full = torch.cat([torch.cat(row, dim=1) for row in blocks])
        m_full = torch.cat([m] * d)
        f_full = 1.0 - m_full
        A_full = (f_full[:, None] * A_full * f_full[None, :]
                  + torch.diag(m_full))
        return torch.linalg.inv(A_full)

    # ---------------------------------------------------------------- #
    def _mv(self, l, lops, x_loc):
        vals, _, Rloc = lops
        lvd = self.lv[l]
        mask = lvd["mask_loc"]
        free = 1.0 - mask
        xf = (free * x_loc).view(self.d, lvd["loc"])
        ext = lvd["ring"].extend(self.comm, xf)
        y = ell_block_spmv(lvd["cols_loc"], vals, Rloc, ext.contiguous(),
                           lvd["ring"].n_ext)
        return free * y.reshape(-1) + mask * x_loc

    def _smooth(self, l, lops, b_loc, x_loc):
        """Minimal-residual rounds; ``x_loc`` None stands for zeros."""
        mv = lambda x: self._mv(l, lops, x)
        for _ in range(max(1, self.smooth_iters // 4)):
            x_loc = psum_minres_smooth(self.comm, mv, lops[1], 4, b_loc,
                                       x_loc)
        return x_loc

    def _coarse_solve(self, comp, ops):
        """The dense coarse solve of the whole (d, n_pad) right-hand side."""
        if self.newton:
            return (ops["coarse_inv"] @ comp.reshape(-1)).view(comp.shape)
        return (ops["coarse_inv"] @ comp.T).T

    def _cycle(self, l, b_loc, ops):
        comm, d = self.comm, self.d
        lops = ops["levels"][l]
        if l == 0:
            lvd = self.lv[0]
            n_pad, loc = lvd["n_pad"], lvd["loc"]
            bf = comm.all_gather(b_loc).view(self.n_dev, d, loc)
            comp = bf.movedim(1, 0).reshape(d, n_pad)   # (d, n_pad) global
            r0 = comm.rank * loc
            x = self._coarse_solve(comp, ops)
            return x[:, r0:r0 + loc].reshape(-1)
        lvd, cvd = self.lv[l], self.lv[l - 1]
        free = 1.0 - lvd["mask_loc"]
        x = self._smooth(l, lops, b_loc, None)
        r = free * (b_loc - self._mv(l, lops, x))
        tr = self.tr[l - 1]
        loc_c = cvd["loc"]
        rc = _restrict(comm, tr, r.view(d, lvd["loc"]))     # (d, npc)
        if l == 1:
            # the whole coarse system on every rank: no re-gather
            ec = self._coarse_solve(rc * (1.0 - cvd["mask_full"]), ops)
        else:
            r0 = comm.rank * loc_c
            rc_loc = (rc[:, r0:r0 + loc_c].reshape(-1)
                      * (1.0 - cvd["mask_loc"]))
            ec_loc = self._cycle(l - 1, rc_loc, ops)
            ec = comm.all_gather(ec_loc).view(self.n_dev, d, loc_c)
            ec = ec.movedim(1, 0).reshape(d, cvd["n_pad"])
        x = x + free * _prolong(tr, ec).reshape(-1)
        return self._smooth(l, lops, b_loc, x)

    def solve_local(self, b_loc: torch.Tensor, ops: dict) -> torch.Tensor:
        L = len(self.lv)
        x = self._cycle(L - 1, b_loc, ops)
        for _ in range(self.cycles - 1):
            r = b_loc - self._mv(L - 1, ops["levels"][L - 1], x)
            x = x + self._cycle(L - 1, r, ops)
        return x

"""Distributed Oseen solve: ring-halo FGMRES around the PCD fieldsplit, and
the Picard/Newton and unsteady drivers on it.

The port of ``fenapack_tpu/parallel/spmd_pcd.py``, the JAX package's
multi-device production path:

  * one global device-major vector ``[ux_0|uy_0|p_0 | ux_1|uy_1|p_1 | ...]``:
    rank i's block is its contiguous chunk, its rows of every field.
    ``pack``/``unpack`` (NumPy) and ``pack_dev``/``unpack_dev`` (on the
    device) map the assembler's order to it;
  * every operator (velocity A1 with the Newton reaction blocks R,
    divergence D, gradient DT, pressure Kp, Mp, the Chebyshev fallback's
    Ap) is a :class:`.spmd.RingHaloELL` row block in the RCM-correlated
    orders of ``NSAssembler(reorder=True)``: one ring hop.  A matvec
    exchanges the velocity and pressure halos in one message each way;
  * the PCD BRM1/BRM2 applies and the upper Schur fieldsplit run
    rank-local: Chebyshev Mp, Ap by the distributed pressure multigrid
    (its own per-level order, bridged by two pressure all-gathers) or by
    Chebyshev, the velocity block by the distributed velocity multigrid
    or minimal-residual sweeps;
  * the outer loop is :func:`.spmd._fgmres_local`.

Every rank holds the whole problem: it assembles the global residual and
operator values and takes its row blocks; only the Oseen solve is
distributed, and its solution's chunks are all-gathered, so every rank
updates the same global state.  Layouts are structural (pattern slots), so
a new wind only re-binds values on the device (:meth:`build_operands`,
:meth:`bind_operands`).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops import subsolve
from ..ops.ell_spmv import ell_block_spmv, ell_spmv
from .spmd import (RingHaloELL, _fgmres_local, _np, local_rows, narrow_ext,
                   psum_minres_smooth, ring_extend)
from .spmd_gmg import SPMDPressureGMG, _HostELL, _pattern_used


def _pad_len(n: int, n_dev: int) -> int:
    return -(-n // n_dev) * n_dev


class _FieldRing:
    """RingHaloELL over a padded field: rows ``[0, n_rows_real)`` of the
    operator plus padding rows (identity with ``diag_identity_pad``, else
    empty); its columns live in a possibly different padded field.  ``used``
    is the structural slot mask (required for wind-dependent operators).
    Holds the rank's blocks of the columns and values; :meth:`rebind`
    takes new values of the same pattern on the device."""

    def __init__(self, ell, n_rows_real, n_rows_pad, n_cols_real,
                 n_cols_pad, comm, dtype, diag_identity_pad=False,
                 used=None):
        cols = _np(ell.cols)[:n_rows_real]
        vals = _np(ell.vals)[:n_rows_real]
        K = cols.shape[1]
        valid = (np.asarray(used)[:n_rows_real] if used is not None
                 else vals != 0)
        nc = np.zeros((n_rows_pad, K), dtype=np.int32)
        nv = np.zeros((n_rows_pad, K))
        va = np.zeros((n_rows_pad, K), dtype=bool)
        nc[:n_rows_real] = np.where(valid, cols, 0)
        nv[:n_rows_real] = np.where(valid, vals, 0.0)
        va[:n_rows_real] = valid
        if diag_identity_pad:
            for i in range(n_rows_real, n_rows_pad):
                nc[i, 0] = min(i, n_cols_pad - 1)
                nv[i, 0] = 1.0
                va[i, 0] = True
        self.ring = RingHaloELL(_HostELL(nc, nv, n_cols_pad), comm.size,
                                valid=va)
        dev = ell.vals.device
        self.rank, self.dtype = comm.rank, dtype
        loc = self.ring.n_loc
        rows = slice(comm.rank * loc, (comm.rank + 1) * loc)
        self.cols = torch.as_tensor(self.ring.cols_ext[rows], device=dev)
        self.vals = torch.as_tensor(nv[rows], dtype=dtype, device=dev)
        self._n_rows_real = n_rows_real
        self._valid_real = torch.as_tensor(valid, device=dev)
        self._tail = torch.as_tensor(nv[n_rows_real:], dtype=dtype,
                                     device=dev)

    def rebind(self, vals_full: torch.Tensor) -> torch.Tensor:
        """The rank's block of new values of the same pattern
        (``vals_full``: the pattern's value array; rows past the real
        count dropped, the padding rows keep their constant values)."""
        n = self._n_rows_real
        v = torch.where(self._valid_real, vals_full[:n].to(self.dtype), 0.0)
        return local_rows(torch.cat([v, self._tail]), self.rank,
                          self.ring.n_loc)

    def mv(self, comm, vals, x_loc):
        """The rank's rows of the product (one halo exchange)."""
        ext = self.ring.extend(comm, x_loc)
        return ell_spmv(self.cols, vals, ext.contiguous(), self.ring.n_ext)


class SPMDPCDSolver:
    """Distributed PCD-preconditioned Oseen solve for one linearization
    point, on the ranks of ``comm``.

    Built from a single-device :class:`solvers.oseen.OseenSolver` whose
    assembler uses ``reorder=True`` (RCM: correlated orders keep every
    operator one ring hop); padding to the rank count is done here.  The
    wind enters through the A1/R/Kp values (:meth:`build_operands`).
    ``ap_gmg``: a :class:`.spmd_gmg.SPMDPressureGMG` for Ap (else
    Chebyshev on a ring, ``pcd.ap.iters`` steps over ``pcd.ap.bounds`` or
    power-iteration bounds); ``velocity_gmg``: a
    :class:`.spmd_gmg.SPMDVelocityGMG` (else ``cheb_velocity_iters // 4``
    rounds of 4 minimal-residual steps)."""

    def __init__(self, oseen, comm, *, ap_gmg: Optional[SPMDPressureGMG]
                 = None, velocity_gmg=None, cheb_velocity_iters: int = 8,
                 maxiter: int = 60, rtol: float = 1e-6):
        self.oseen, self.comm = oseen, comm
        self.maxiter, self.rtol = maxiter, rtol
        asm = oseen.asm
        self.asm = asm
        self.d = d = asm.dim
        self.n_dev = n_dev = comm.size
        dt = self.dtype = oseen.dtype
        dev = self.device = asm.device
        r = comm.rank

        self.n2r, self.n1r = asm.n2_real, asm.n1_real
        self.n2p, self.n1p = _pad_len(self.n2r, n_dev), _pad_len(self.n1r,
                                                                  n_dev)
        self.loc2, self.loc1 = self.n2p // n_dev, self.n1p // n_dev
        self.nloc = d * self.loc2 + self.loc1
        self.n_glob = n_dev * self.nloc
        self.cheb_velocity_iters = cheb_velocity_iters
        self.ap_gmg, self.velocity_gmg = ap_gmg, velocity_gmg
        self._build_pack_maps()
        rows2 = slice(r * self.loc2, (r + 1) * self.loc2)
        rows1 = slice(r * self.loc1, (r + 1) * self.loc1)
        t = lambda a, dtype=dt: torch.as_tensor(np.ascontiguousarray(a),
                                                dtype=dtype, device=dev)

        # masks: u-space blocks (d, loc2), pressure blocks (loc1,)
        mask_u = np.zeros(d * self.n2p)
        bm = _np(oseen.bc_mask_u)
        for a in range(d):
            mask_u[a * self.n2p:a * self.n2p + self.n2r] = \
                bm[a * asm.n2:a * asm.n2 + self.n2r]
            mask_u[a * self.n2p + self.n2r:(a + 1) * self.n2p] = 1.0
        self.mask_u = t(mask_u.reshape(d, self.n2p)[:, rows2])
        mask_p = np.zeros(self.n1p)
        if oseen.pcd_mask is not None:
            mask_p[:self.n1r] = _np(oseen.pcd_mask)[:self.n1r]
        mask_p[self.n1r:] = 1.0
        self.mask_p = t(mask_p[rows1])
        p_pad = np.zeros(self.n1p)
        p_pad[self.n1r:] = 1.0
        self.p_pad = t(p_pad[rows1])

        # Mp: Jacobi-Chebyshev on a ring operator
        c = asm.const
        self.mp_ring = _FieldRing(c.Mp, self.n1r, self.n1p, self.n1r,
                                  self.n1p, comm, dt, diag_identity_pad=True)
        mp_diag = np.ones(self.n1p)
        mp_diag[:self.n1r] = _np(c.Mp.diag_from(asm.pat_p1.diag_pos))[
            :self.n1r]
        self.mp_dinv = t(1.0 / mp_diag[rows1])

        # Ap without a multigrid: Jacobi-Chebyshev on a ring operator
        if ap_gmg is None:
            self.ap_ring = _FieldRing(c.Ap, self.n1r, self.n1p, self.n1r,
                                      self.n1p, comm, dt,
                                      diag_identity_pad=True)
            ap_diag = np.ones(self.n1p)
            ap_diag[:self.n1r] = _np(c.Ap.diag_from(asm.pat_p1.diag_pos))[
                :self.n1r]
            ap_diag = np.where(mask_p > 0, 1.0, ap_diag)
            self.ap_dinv = t(1.0 / ap_diag[rows1])
            ap_cfg = oseen.config.pcd.ap
            if ap_cfg.bounds is not None:
                self._ap_bounds = tuple(ap_cfg.bounds)
            else:
                # bounds of the sequential masked operator: the ring
                # operator is the same matrix with identity on masked rows
                ap_mask_seq = oseen._union(oseen.pcd_mask, oseen.p_pad)
                op0 = c.Ap.with_vals(c.Ap.vals.to(dt))
                diag0 = c.Ap.diag_from(asm.pat_p1.diag_pos).to(dt)
                if ap_mask_seq is not None:
                    diag0 = torch.where(ap_mask_seq > 0, 1.0, diag0)
                mv0 = oseen._masked_spd_matvec(op0, ap_mask_seq)
                self._ap_bounds = subsolve.power_bounds(
                    mv0, 1.0 / diag0, c.Ap.shape[0])
            self._ap_iters = ap_cfg.iters

        # divergence / gradient rings (rectangular)
        self.D_rings = [_FieldRing(c.D[a], self.n1r, self.n1p, self.n2r,
                                   self.n2p, comm, dt) for a in range(d)]
        self.DT_rings = [_FieldRing(c.DT[a], self.n2r, self.n2p, self.n1r,
                                    self.n1p, comm, dt) for a in range(d)]

        # structural A1 / Kp / R layouts: pattern slots, so every wind
        # reuses them (a layout from the values would shrink the halo
        # wherever a convection value happens to be zero)
        used_p2 = _pattern_used(asm.pat_p2)
        used_p1 = _pattern_used(asm.pat_p1)
        zeros = lambda pat: pat.matrix(torch.zeros(pat.value_shape,
                                                   dtype=dt, device=dev))
        a1_ring = _FieldRing(zeros(asm.pat_p2), self.n2r, self.n2p,
                             self.n2r, self.n2p, comm, dt,
                             diag_identity_pad=True, used=used_p2)
        kp_ring = _FieldRing(zeros(asm.pat_p1), self.n1r, self.n1p,
                             self.n1r, self.n1p, comm, dt, used=used_p1)
        R_ring = None
        if oseen.linearization == "newton":
            R_ring = _FieldRing(zeros(asm.pat_p2), self.n2r, self.n2p,
                                self.n2r, self.n2p, comm, dt, used=used_p2)
            # the reaction blocks ride A1's column array in the block
            # product: the layouts differ only on padding rows, where R
            # holds zeros
            if R_ring.ring.halo != a1_ring.ring.halo:
                raise ValueError("reaction and A1 ring halos differ")
        self._rings = dict(a1=a1_ring, kp=kp_ring, R=R_ring)

        if velocity_gmg is not None:
            # the velocity multigrid's fine layout must be this solver's
            # u-space layout: both RCM-rank the same natural P2 dofmap
            lvf = velocity_gmg.lv[-1]
            if (lvf["n_pad"] != self.n2p or not np.array_equal(
                    lvf["rank"], np.asarray(asm.W.V.rank))):
                raise ValueError(
                    "SPMD velocity GMG fine ordering does not match the "
                    "solver's u-space layout (same mesh + RCM required)")

        # pressure multigrid order bridge: assembler order <-> gmg order
        # (natural -> assembler is W.Q.rank, natural -> gmg fine_rank)
        if ap_gmg is not None:
            q = asm.W.Q
            q_rank = (np.asarray(q.rank) if hasattr(q, "rank")
                      else np.arange(self.n1r, dtype=np.int32))
            g_rank = ap_gmg.fine_rank
            npad_g = ap_gmg.levels[-1].n_pad
            nloc_g = npad_g // n_dev
            asm_of_gmg = np.zeros(npad_g, dtype=np.int64)
            asm_of_gmg[g_rank] = q_rank
            gmg_of_asm = np.zeros(self.n1p, dtype=np.int64)
            gmg_of_asm[q_rank] = g_rank
            self._gmg_from_asm = t(asm_of_gmg[r * nloc_g:(r + 1) * nloc_g],
                                   torch.int64)
            self._asm_from_gmg = t(gmg_of_asm[rows1], torch.int64)
        self._values = None

    # ---------------------------------------------------------------- #
    # pack / unpack: assembler order <-> global device-major
    # ---------------------------------------------------------------- #
    def _build_pack_maps(self):
        d, n_dev = self.d, self.n_dev
        loc2, loc1, nloc = self.loc2, self.loc1, self.nloc
        u_pos = np.empty(d * self.n2p, dtype=np.int64)
        j = np.arange(self.n2p)
        dev = j // loc2
        for a in range(d):
            u_pos[a * self.n2p:(a + 1) * self.n2p] = (
                dev * nloc + a * loc2 + (j - dev * loc2))
        j = np.arange(self.n1p)
        dev = j // loc1
        p_pos = dev * nloc + d * loc2 + (j - dev * loc1)
        self._u_pos, self._p_pos = u_pos, p_pos
        n2, n2r, n2p = self.asm.n2, self.n2r, self.n2p
        self._pad_u_dst = np.concatenate([a * n2p + np.arange(n2r)
                                          for a in range(d)])
        self._pad_u_src = np.concatenate([a * n2 + np.arange(n2r)
                                          for a in range(d)])
        self._dev_maps = None

    def pack(self, u_asm, p_asm) -> np.ndarray:
        """Assembler order (stacked u, p) -> global device-major vector."""
        u_asm, p_asm = _np(u_asm), _np(p_asm)
        up = np.zeros(self.d * self.n2p)
        up[self._pad_u_dst] = u_asm[self._pad_u_src]
        out = np.zeros(self.n_glob)
        out[self._u_pos] = up
        out[self._p_pos[:self.n1r]] = p_asm[:self.n1r]
        return out

    def unpack(self, x_dm):
        """Global device-major vector -> (stacked u, p), assembler order."""
        x_dm = _np(x_dm)
        up = x_dm[self._u_pos]
        u = np.zeros(self.d * self.asm.n2)
        u[self._pad_u_src] = up[self._pad_u_dst]
        p = np.zeros(self.asm.n1)
        p[:self.n1r] = x_dm[self._p_pos[:self.n1r]]
        return u, p

    def _maps_dev(self):
        if self._dev_maps is None:
            t = lambda a: torch.as_tensor(a, device=self.device)
            self._dev_maps = dict(
                u_pos=t(self._u_pos), p_pos=t(self._p_pos[:self.n1r]),
                dst=t(self._pad_u_dst), src=t(self._pad_u_src))
        return self._dev_maps

    def pack_dev(self, u_asm: torch.Tensor, p_asm: torch.Tensor):
        """:meth:`pack` on the device."""
        m, dt = self._maps_dev(), self.dtype
        up = torch.zeros(self.d * self.n2p, dtype=dt, device=self.device)
        up[m["dst"]] = u_asm[m["src"]].to(dt)
        out = torch.zeros(self.n_glob, dtype=dt, device=self.device)
        out[m["u_pos"]] = up
        out[m["p_pos"]] = p_asm[:self.n1r].to(dt)
        return out

    def unpack_dev(self, x_dm: torch.Tensor):
        """:meth:`unpack` on the device."""
        m = self._maps_dev()
        up = x_dm[m["u_pos"]]
        u = torch.zeros(self.d * self.asm.n2, dtype=x_dm.dtype,
                        device=x_dm.device)
        u[m["src"]] = up[m["dst"]]
        p = torch.zeros(self.asm.n1, dtype=x_dm.dtype, device=x_dm.device)
        p[:self.n1r] = x_dm[m["p_pos"]]
        return u, p

    def local(self, x_dm) -> torch.Tensor:
        """The rank's block of a global device-major vector."""
        x = torch.as_tensor(x_dm, dtype=self.dtype, device=self.device)
        r = self.comm.rank
        return x[r * self.nloc:(r + 1) * self.nloc].contiguous()

    def gather(self, x_loc: torch.Tensor) -> torch.Tensor:
        """The global device-major vector from every rank's block."""
        return self.comm.all_gather(x_loc).reshape(-1)

    # ---------------------------------------------------------------- #
    # operands
    # ---------------------------------------------------------------- #
    def _wind_operands(self, wind_asm: torch.Tensor) -> dict:
        """The wind-dependent operands, computed on the device: the rank's
        blocks of the A1, R and Kp values, the velocity Jacobi diagonal and
        the velocity multigrid's levels."""
        oseen, asm, dt, d = self.oseen, self.asm, self.dtype, self.d
        wind = torch.as_tensor(wind_asm, device=self.device).to(dt)
        A1vals, R = oseen._operator_values(wind)
        if (R is not None and self.velocity_gmg is not None
                and not getattr(self.velocity_gmg, "newton", False)):
            raise ValueError(
                "Newton linearization with a Picard-level velocity GMG: "
                "construct SPMDVelocityGMG(..., newton=True) so the levels "
                "carry the reaction coupling")
        self._values = (A1vals, R)
        kpvals = asm.kp_values(
            wind, surface=(oseen.config.pcd.variant == "BRM2")).to(dt)
        rings = self._rings
        ops = {"a1": rings["a1"].rebind(A1vals),
               "kp": rings["kp"].rebind(kpvals), "R": None}
        n2r, n2p, loc2 = self.n2r, self.n2p, self.loc2
        diag_pos = asm.pat_p2.diag_pos
        base = torch.ones(n2p, dtype=dt, device=self.device)
        base[:n2r] = A1vals.reshape(-1)[diag_pos][:n2r]
        comps = []
        for a in range(d):
            da = base
            if R is not None:
                da = base.clone()
                da[:n2r] += R[a, a].reshape(-1)[diag_pos][:n2r].to(dt)
            comps.append(local_rows(1.0 / da, self.comm.rank, loc2))
        ops["a1_dinv"] = torch.stack(comps)
        if R is not None:
            ops["R"] = torch.stack([torch.stack([
                rings["R"].rebind(R[a, b]) for b in range(d)])
                for a in range(d)])
        if self.velocity_gmg is not None:
            # the velocity multigrid's assemblers are natural-ordered; the
            # wind arrives in the (RCM) solver-assembler order:
            # new id = rank[nat], so nat = new[rank]
            rank = torch.as_tensor(np.asarray(asm.W.V.rank),
                                   device=self.device)
            wind_nat = torch.cat([wind[a * asm.n2:a * asm.n2 + n2r][rank]
                                  for a in range(d)])
            ops["vgmg"] = self.velocity_gmg.bind_operands(wind_nat)
        return ops

    def build_operands(self, wind_asm) -> dict:
        """The rank's operands at ``wind_asm`` (stacked velocity in the
        assembler's order): the wind-dependent ones of
        :meth:`bind_operands` plus the constant ones."""
        ops = {"mp": self.mp_ring.vals,
               "D": [r.vals for r in self.D_rings],
               "DT": [r.vals for r in self.DT_rings],
               "mask_u": self.mask_u, "mask_p": self.mask_p,
               "p_pad": self.p_pad, "mp_dinv": self.mp_dinv}
        if self.ap_gmg is None:
            ops["ap"], ops["ap_dinv"] = self.ap_ring.vals, self.ap_dinv
        ops.update(self._wind_operands(wind_asm))
        return ops

    def bind_operands(self, wind_asm: torch.Tensor, ops: dict) -> dict:
        """``ops`` with its wind-dependent entries re-bound to
        ``wind_asm`` on the device (the constant ones are kept)."""
        out = dict(ops)
        out.update(self._wind_operands(wind_asm))
        return out

    # ---------------------------------------------------------------- #
    # the rank-local operator and preconditioner
    # ---------------------------------------------------------------- #
    def _local_ops(self, ops: dict):
        comm, d = self.comm, self.d
        loc2 = self.loc2
        rings = self._rings
        a1r, kpr = rings["a1"], rings["kp"]
        h_a1, n_a1 = a1r.ring.halo, a1r.ring.n_ext
        h_D = [r.ring.halo for r in self.D_rings]
        h_DT = [r.ring.halo for r in self.DT_rings]
        H_u, H_p = max([h_a1] + h_D), max(h_DT)
        a1v, Rv, kpv, mpv = ops["a1"], ops["R"], ops["kp"], ops["mp"]
        Dv, DTv = ops["D"], ops["DT"]
        mus = ops["mask_u"]
        fus = 1.0 - mus
        mask_p, p_pad = ops["mask_p"], ops["p_pad"]

        def grad_p(ext_p):
            return torch.stack([ell_spmv(
                r.cols, DTv[a], narrow_ext(ext_p, H_p, h).contiguous(),
                r.ring.n_ext) for a, (r, h) in
                enumerate(zip(self.DT_rings, h_DT))])

        def matvec_local(x_loc):
            us = x_loc[:d * loc2].view(d, loc2)
            p = x_loc[d * loc2:]
            ufs = fus * us
            ext_u, ext_p = ring_extend(comm, [(ufs, H_u), (p, H_p)])
            y = ell_block_spmv(a1r.cols, a1v, Rv,
                               narrow_ext(ext_u, H_u, h_a1).contiguous(),
                               n_a1, grad_p(ext_p))
            ys = fus * y + mus * us
            yp = sum(ell_spmv(r.cols, Dv[a],
                              narrow_ext(ext_u, H_u, h)[a].contiguous(),
                              r.ring.n_ext)
                     for a, (r, h) in enumerate(zip(self.D_rings, h_D)))
            yp = yp + p_pad * p
            return torch.cat([ys.reshape(-1), yp])

        def vel_mv(u_all):
            us = u_all.view(d, loc2)
            ext = ring_extend(comm, [(fus * us, h_a1)])[0]
            y = ell_block_spmv(a1r.cols, a1v, Rv, ext.contiguous(), n_a1)
            return (fus * y + mus * us).reshape(-1)

        if self.velocity_gmg is not None:
            vgmg, vgmg_ops = self.velocity_gmg, ops["vgmg"]

            def vel_solve(b):
                return vgmg.solve_local(b, vgmg_ops)
        else:
            a1_dinv = ops["a1_dinv"].reshape(-1)
            rounds = max(1, self.cheb_velocity_iters // 4)

            def vel_solve(b):
                x = None                            # zeros
                for _ in range(rounds):
                    x = psum_minres_smooth(comm, vel_mv, a1_dinv, 4, b, x)
                return x

        # Mp: always the Chebyshev polynomial (pcd.mp bounds and iters)
        mp_cfg = self.oseen.config.pcd.mp
        mp_lmin, mp_lmax = mp_cfg.bounds or (0.5, 2.5)
        fp = 1.0 - p_pad

        def mp_mv(x):
            return fp * self.mp_ring.mv(comm, mpv, fp * x) + p_pad * x
        mp_solve = subsolve.chebyshev_solver(mp_mv, ops["mp_dinv"], mp_lmin,
                                             mp_lmax, mp_cfg.iters)

        if self.ap_gmg is not None:
            gmg = self.ap_gmg
            g_from_a, a_from_g = self._gmg_from_asm, self._asm_from_gmg

            def ap_solve(r_loc):
                # bridge the orders: all-gather the assembler-order
                # pressure, take the gmg-order block, and back
                r_full = comm.all_gather(r_loc).reshape(-1)
                eg = gmg.solve_local(r_full[g_from_a])
                e_full = comm.all_gather(eg).reshape(-1)
                return (1.0 - p_pad) * e_full[a_from_g]
        else:
            free_ap = 1.0 - mask_p
            apv = ops["ap"]
            ap_lmin, ap_lmax = self._ap_bounds

            def ap_mv(x):
                return (free_ap * self.ap_ring.mv(comm, apv, free_ap * x)
                        + mask_p * x)
            ap_cheb = subsolve.chebyshev_solver(ap_mv, ops["ap_dinv"],
                                                ap_lmin, ap_lmax,
                                                self._ap_iters)

            def ap_solve(r_loc):
                return free_ap * ap_cheb(r_loc)

        variant = self.oseen.config.pcd.variant
        free_p = 1.0 - mask_p
        theta, inv_dt = self.oseen.theta, self.oseen.inv_dt
        nullspace = getattr(self.oseen, "_nullspace", False)
        act_p = 1.0 - p_pad
        n_act = float(self.n1r)

        def project(x):
            if not nullspace:
                return x
            s = comm.allreduce_sum(torch.sum(x * act_p))
            return x - (s / n_act) * act_p

        def ap_inv(x):
            if nullspace:
                return project(ap_solve(project(x)))
            return ap_solve(x)

        def kp_mv(x):
            return kpr.mv(comm, kpv, x)

        if variant == "BRM1":
            def schur(r_p):
                w1 = ap_inv(free_p * r_p)
                return project(-(theta * mp_solve(r_p + kp_mv(w1))
                                 + inv_dt * w1))
        else:
            def schur(r_p):
                w1 = mp_solve(r_p)
                w2 = free_p * (theta * kp_mv(w1) + inv_dt * r_p)
                return project(-(theta * w1 + ap_inv(w2)))

        def pc_local(r_loc):
            us = r_loc[:d * loc2].view(d, loc2)
            zp = schur(r_loc[d * loc2:])
            ext_p = ring_extend(comm, [(zp, H_p)])[0]
            rhs = fus * (us - grad_p(ext_p))
            zu = vel_solve(rhs.reshape(-1)).view(d, loc2)
            zus = fus * zu + mus * us
            return torch.cat([zus.reshape(-1), zp])

        return matvec_local, pc_local

    def solve(self, ops: dict, b_dm):
        """FGMRES of the global device-major ``b_dm`` to ``rtol``; returns
        ``(x_dm, iters, resnorm_estimate)`` with ``x_dm`` global (every
        rank's block, all-gathered) on the device."""
        matvec_local, pc_local = self._local_ops(ops)
        x_loc, k, res = _fgmres_local(self.comm, matvec_local, pc_local,
                                      self.local(b_dm), maxiter=self.maxiter,
                                      rtol=self.rtol)
        return self.gather(x_loc), k, res

    def true_relres(self, x_dm, b_dm) -> float:
        """|b - A x| / |b| with the single-device system matvec at the last
        bound wind (the check of a solve, in assembler order)."""
        mv = self.oseen._matvec_factory(*self._values)
        dev = self.device
        xu, xp = self.unpack_dev(torch.as_tensor(x_dm, dtype=self.dtype,
                                                 device=dev))
        bu, bp = self.unpack_dev(torch.as_tensor(b_dm, dtype=self.dtype,
                                                 device=dev))
        b = torch.cat([bu, bp])
        r = b - mv(torch.cat([xu, xp]))
        return float(torch.linalg.norm(r)) / max(
            float(torch.linalg.norm(b)), 1e-300)


# --------------------------------------------------------------------- #
# drivers
# --------------------------------------------------------------------- #

def _solver_for(oseen, comm, spmd_solver, **kw):
    if spmd_solver is not None:
        return spmd_solver
    return SPMDPCDSolver(oseen, comm, **kw)


class SPMDNonlinearSolver:
    """Picard/Newton loop whose linear solves run on the ranks.

    Mirrors :meth:`solvers.nonlinear.NonlinearSolver.solve`; each
    linearized system is solved by :class:`SPMDPCDSolver`.  Picard or
    Newton follows the wrapped solver's linearization (Newton with a
    velocity multigrid needs ``SPMDVelocityGMG(..., newton=True)``).
    Every rank runs the loop on the same global state; the stopping test
    reads the global |F|, which every rank computes the same way."""

    def __init__(self, nl, comm=None, *, ap_gmg=None, velocity_gmg=None,
                 cheb_velocity_iters: int = 8, maxiter: int = 60,
                 rtol_lin: float = 1e-6,
                 spmd_solver: Optional[SPMDPCDSolver] = None):
        self.nl = nl
        self.sp = _solver_for(nl.oseen, comm, spmd_solver, ap_gmg=ap_gmg,
                              velocity_gmg=velocity_gmg,
                              cheb_velocity_iters=cheb_velocity_iters,
                              maxiter=maxiter, rtol=rtol_lin)

    def initial_state(self):
        return self.nl.initial_state()

    def _residual(self, w):
        return self.nl.residual_of(w)[0].to(self.nl.oseen.dtype)

    def solve(self, w0=None, rtol: float = 1e-5, atol: float = 0.0,
              max_steps: int = 25, damping: float = 1.0, callback=None):
        """The Picard loop with the residual, packing and unpacking on the
        host (NumPy), the solve on the ranks.  Returns a
        :class:`solvers.nonlinear.NonlinearResult` whose ``lin_rel`` holds
        each solve's true relative residual.  ``callback(k, w)`` is called
        with each new state."""
        from ..solvers.nonlinear import NonlinearResult
        nl, sp = self.nl, self.sp
        n_u = nl.n_u
        w = nl.initial_state() if w0 is None else w0.to(nl.oseen.dtype)
        t0 = time.perf_counter()
        res_hist, lin_iters, lin_res, lin_rel = [], [], [], []
        r0, converged = None, False
        for _ in range(max_steps):
            F = self._residual(w).cpu().numpy()
            rn = float(np.linalg.norm(F))
            res_hist.append(rn)
            if r0 is None:
                r0 = rn if rn > 0 else 1.0
            if rn <= max(rtol * r0, atol):
                converged = True
                break
            ops = sp.build_operands(w[:n_u])
            b_dm = sp.pack(-F[:n_u], -F[n_u:])
            x_dm, k, lrn = sp.solve(ops, b_dm)
            lin_rel.append(sp.true_relres(x_dm, b_dm))
            du, dp = sp.unpack(x_dm)
            dw = torch.as_tensor(np.concatenate([du, dp]), dtype=w.dtype,
                                 device=w.device)
            w = w + damping * dw
            lin_iters.append(int(k))
            lin_res.append(np.asarray(lrn))
            if callback is not None:
                callback(len(lin_iters) - 1, w)
        return NonlinearResult(w=w, nonlinear_res=res_hist,
                               linear_iters=lin_iters,
                               linear_resnorms=lin_res, converged=converged,
                               wall_time=time.perf_counter() - t0,
                               lin_rel=lin_rel)

    def make_step_fused(self):
        """``(step, ops)``: ``step(w, ops, damping) -> (w_new, |F|, iters,
        lin_rel)``, one nonlinear step that stays on the device (residual,
        packing, operand re-binding, the distributed solve, the update).
        The template ``ops`` carry the constant operands."""
        nl, sp = self.nl, self.sp
        n_u = nl.n_u
        ops0 = sp.build_operands(nl.initial_state()[:n_u])

        def step(w, ops, damping, F=None):
            if F is None:
                F = self._residual(w)
            b = sp.pack_dev(-F[:n_u], -F[n_u:])
            ops2 = sp.bind_operands(w[:n_u], ops)
            x, k, _ = sp.solve(ops2, b)
            rel = sp.true_relres(x, b)
            du, dp = sp.unpack_dev(x)
            return w + damping * torch.cat([du, dp]).to(w.dtype), k, rel

        return step, ops0

    def solve_fused(self, w0=None, rtol: float = 1e-5, atol: float = 0.0,
                    max_steps: int = 25, damping: float = 1.0, callback=None):
        """:meth:`solve` over the device-resident step
        (:meth:`make_step_fused`): one host read per step, its |F|."""
        from ..solvers.nonlinear import NonlinearResult
        nl = self.nl
        if getattr(self, "_fused", None) is None:
            self._fused = self.make_step_fused()
        step, ops = self._fused
        w = nl.initial_state() if w0 is None else w0.to(nl.oseen.dtype)
        t0 = time.perf_counter()
        res_hist, lin_iters, lin_rel = [], [], []
        r0, converged = None, False
        for _ in range(max_steps):
            F = self._residual(w)
            rn = float(torch.linalg.norm(F))
            res_hist.append(rn)
            if r0 is None:
                r0 = rn if rn > 0 else 1.0
            if rn <= max(rtol * r0, atol):
                converged = True
                break
            w, k, rel = step(w, ops, damping, F)
            lin_iters.append(int(k))
            lin_rel.append(rel)
            if callback is not None:
                callback(len(lin_iters) - 1, w)
        return NonlinearResult(w=w, nonlinear_res=res_hist,
                               linear_iters=lin_iters, linear_resnorms=[],
                               converged=converged,
                               wall_time=time.perf_counter() - t0,
                               lin_rel=lin_rel)


class SPMDUnsteadySolver:
    """theta-scheme / BDF2 stepping whose linear solves run on the ranks.

    Wraps a single-device :class:`solvers.unsteady.UnsteadySolver` (its
    residuals, and an OseenSolver carrying ``theta``/``inv_dt``, which the
    distributed Schur apply reads).  Time-dependent boundary data
    (``bc_fn``) is refused: the steps here assume ``u_old == u`` at the
    Dirichlet dofs, as the JAX package's fused SPMD step does."""

    def __init__(self, us, comm=None, *, ap_gmg=None, velocity_gmg=None,
                 cheb_velocity_iters: int = 8, maxiter: int = 60,
                 rtol_lin: float = 1e-6,
                 spmd_solver: Optional[SPMDPCDSolver] = None):
        if getattr(us, "bc_fn", None) is not None:
            raise ValueError(
                "time-dependent BCs (bc_fn) need the exact single-device "
                "loop (UnsteadySolver.solve); the SPMD steps would freeze "
                "the t=0 boundary values")
        self.us = us
        self.sp = _solver_for(us.oseen, comm, spmd_solver, ap_gmg=ap_gmg,
                              velocity_gmg=velocity_gmg,
                              cheb_velocity_iters=cheb_velocity_iters,
                              maxiter=maxiter, rtol=rtol_lin)

    def step(self, w, *, picard_iters: int = 1, rtol: float = 1e-6,
             u_prev=None):
        """One time step on the host loop; ``(w_new, iterations, |F|)``."""
        us, sp = self.us, self.sp
        n_u = us.n_u
        u_old = w[:n_u]
        aux = us._step_aux(u_old, u_prev)
        total, rn = 0, None
        for _ in range(max(picard_iters, 1)):
            F = us._residual_full(w, u_old, aux).cpu().numpy()
            rn = float(np.linalg.norm(F))
            if rn <= rtol:
                break
            ops = sp.build_operands(w[:n_u])
            x_dm, k, _ = sp.solve(ops, sp.pack(-F[:n_u], -F[n_u:]))
            du, dp = sp.unpack(x_dm)
            w = w + torch.as_tensor(np.concatenate([du, dp]), dtype=w.dtype,
                                    device=w.device)
            total += int(k)
        return w, total, rn

    def _loop(self, t_end, w0, step_fn, keep_history, callback):
        from ..solvers.unsteady import UnsteadyResult
        us = self.us
        t0 = time.perf_counter()
        w = us.initial_state() if w0 is None else w0.to(us.oseen.dtype)
        t, times, iters, resid = 0.0, [], [], []
        hist = [] if keep_history else None
        u_prev = None
        for k in range(int(round(t_end / us.dt))):
            u_old = w[:us.n_u]
            w, it, rn = step_fn(w, u_prev)
            u_prev = u_old                   # BDF2 history (theta: unread)
            t += us.dt
            times.append(t)
            iters.append(it)
            resid.append(rn)
            if keep_history:
                hist.append(w.cpu().numpy())
            if callback is not None:
                callback(k, t, w)
        return UnsteadyResult(w=w, times=times, linear_iters=iters,
                              step_res=resid,
                              wall_time=time.perf_counter() - t0,
                              history=hist)

    def solve(self, t_end: float, w0=None, *, picard_iters: int = 1,
              keep_history: bool = False, callback=None):
        return self._loop(
            t_end, w0, lambda w, up: self.step(
                w, picard_iters=picard_iters, u_prev=up),
            keep_history, callback)

    def make_step_fused(self):
        """``(step, ops)``: ``step(w, u_prev, ops) -> (w_new, iters, |F|)``,
        one semi-implicit time step (as :meth:`step` with one Picard
        iteration) that stays on the device; ``u_prev`` is the BDF2
        velocity of two steps ago (None: the startup step)."""
        us, sp = self.us, self.sp
        n_u = us.n_u
        ops0 = sp.build_operands(us.initial_state()[:n_u])

        def step(w, u_prev, ops):
            u_old = w[:n_u]
            F = us._residual_full(w, u_old, us._step_aux(u_old, u_prev))
            rn = float(torch.linalg.norm(F))
            b = sp.pack_dev(-F[:n_u], -F[n_u:])
            x, k, _ = sp.solve(sp.bind_operands(u_old, ops), b)
            du, dp = sp.unpack_dev(x)
            return w + torch.cat([du, dp]).to(w.dtype), k, rn

        return step, ops0

    def solve_fused(self, t_end: float, w0=None, *, keep_history=False,
                    callback=None):
        """The time loop over the device-resident step."""
        if getattr(self, "_fused", None) is None:
            self._fused = self.make_step_fused()
        step, ops = self._fused
        return self._loop(t_end, w0, lambda w, up: step(w, up, ops),
                          keep_history, callback)

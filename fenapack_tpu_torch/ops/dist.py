"""How a solver's vectors are laid out over ranks: the distribution object
that the single-device factories take.

:data:`LOCAL` is the single-device layout, where every vector is whole and
every method is the identity or the plain reduction the factories computed
before they took a distribution, so a single-device solve does the same
arithmetic as it always did.  The row-sharded layout
(:class:`fenapack_tpu_torch.parallel.sharding.RowShard`) gives each rank one
contiguous row block of every field component and answers the same calls
with collectives.  A ``space`` names the layout of a vector:

  * ``"u"``: the stacked velocity ``[u_0; ...; u_{d-1}]``;
  * ``"p"``: the pressure;
  * ``"v"``: one scalar P2 component;
  * ``"w"``: the state ``[u; p]``.
"""
from __future__ import annotations

import torch


class Local:
    """The single-device layout (one rank holds every row)."""

    size = 1
    rank = 0

    def rows(self, x: torch.Tensor, space: str) -> torch.Tensor:
        """The rows of the full-length ``x`` (a vector, or a matrix along
        its first axis) that this rank owns."""
        return x

    def full(self, x: torch.Tensor, space: str) -> torch.Tensor:
        """The full vector from every rank's rows."""
        return x

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x)

    def proj(self, V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``V @ w`` over the rows of the distributed axis."""
        return V @ w

    def proj_norm(self, V: torch.Tensor, w: torch.Tensor):
        """``(V @ w, |w|)`` (one reduction where the rows are spread)."""
        return V @ w, torch.linalg.norm(w)

    def gram(self, W: torch.Tensor, r: torch.Tensor):
        """``(W @ W^T, W @ r)`` (one reduction where the rows are
        spread)."""
        return W @ W.T, W @ r


LOCAL = Local()


def zero_mean(x: torch.Tensor, active=None, n_active=None,
              dist: Local = LOCAL) -> torch.Tensor:
    """``x`` with its mean over the active dofs removed: the plain mean
    without padding, else the sum over ``active`` (1.0 on the real dofs,
    0.0 on the alignment padding) divided by ``n_active``, removed from the
    active dofs only."""
    if active is None:
        return x - dist.mean(x)
    act = active.to(x.dtype)
    return x - (dist.sum(x * act) / n_active) * act

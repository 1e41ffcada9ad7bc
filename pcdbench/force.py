"""The seeded body force of a steady cell: the problem's data that ``--seed``
draws.  The same callable goes to the program (through its assembler's
``set_body_force``) and to the reference.

    f_a(x) = A * sum_j c_aj * sin(pi * k_j . x + phi_aj)

with ``modes`` wave vectors k_j of whole numbers in [0, kmax] (not all
zero), c_aj standard normal over sqrt(modes) and phi_aj uniform in
[0, 2 pi), all drawn from ``numpy.random.default_rng(seed)``.  The
amplitude A is the configuration's: small beside the inertial forces
(about 1 here), so that every seed asks for the same work to a few
iterations, and large against the tolerances, so that a state solved
without the load is wrong by far more than they allow.
"""
from __future__ import annotations

import numpy as np


def body_force(seed: int, dim: int, amplitude: float, modes: int,
               kmax: int):
    """``f(x (k, dim)) -> (k, dim)`` for ``seed`` (any whole number >= 0)."""
    rng = np.random.default_rng(int(seed))
    k = rng.integers(0, kmax + 1, size=(modes, dim))
    k[k.sum(axis=1) == 0, 0] = 1
    c = rng.standard_normal((dim, modes)) / np.sqrt(modes)
    ph = rng.uniform(0.0, 2.0 * np.pi, size=(dim, modes))
    kk = np.pi * k.T.astype(np.float64)                   # (dim, modes)

    def f(x: np.ndarray) -> np.ndarray:
        arg = np.asarray(x, dtype=np.float64) @ kk         # (n, modes)
        return amplitude * np.stack(
            [np.sin(arg + ph[a]) @ c[a] for a in range(dim)], axis=1)
    return f

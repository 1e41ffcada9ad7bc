"""The backward-facing steps of the configurations, as the reference builds
them: mesh, Dirichlet nodes and their values.

``spec`` is the ``problem`` object of a configuration file:
``{"domain": "step2d" | "step3d", "level": ..., "length": ..., "nu": ...,
"quad_degree": ...}``.  Walls are no-slip; the inflow at x = -1 carries
``4 y (1 - y)`` in 2D and ``16 y (1 - y) z (1 - z)`` in 3D (peak 1, zero
on its rim) in the x component; the outflow at x = L is natural.  Nodes of
wall and inflow facets are Dirichlet; the nodes of the outflow face that no
wall facet touches are free.
"""
from __future__ import annotations

import numpy as np

from . import mesh as meshes


def inflow(x: np.ndarray) -> np.ndarray:
    """The inflow velocity at points x (k, d)."""
    g = np.zeros_like(x)
    if x.shape[1] == 2:
        g[:, 0] = 4.0 * x[:, 1] * (1.0 - x[:, 1])
    else:
        g[:, 0] = (16.0 * x[:, 1] * (1.0 - x[:, 1]) * x[:, 2]
                   * (1.0 - x[:, 2]))
    return g


def build(spec: dict):
    """``(mesh, dirichlet (n2,) bool, g (n2, d))`` of ``spec``."""
    level, length = int(spec["level"]), float(spec["length"])
    if spec["domain"] == "step2d":
        v, c = meshes.tri_step(level, length)
    elif spec["domain"] == "step3d":
        v, c = meshes.tet_step(level, length, float(spec.get("width", 1.0)))
    else:
        raise ValueError(f"unknown domain {spec['domain']!r}")
    m = meshes.build(v, c)
    tol = 1e-9
    outflow = m.facet_mid[:, 0] > length - tol
    infl = m.facet_mid[:, 0] < -1.0 + tol
    dirichlet = np.zeros(m.nodes.shape[0], dtype=bool)
    dirichlet[m.facet_nodes[~outflow].ravel()] = True
    g = np.zeros_like(m.nodes)
    on_in = np.zeros_like(dirichlet)
    on_in[m.facet_nodes[infl].ravel()] = True
    g[on_in] = inflow(m.nodes[on_in])
    return m, dirichlet, g

"""Checkpoint and resume, and VTK export, the port of
``fenapack_tpu/utils/io.py``: the state is ``(w, t)``, so a checkpoint is
an npz archive; :func:`save_vtk` writes the Taylor-Hood fields as legacy
VTK for visualization.  NumPy only.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


def save_checkpoint(path: str, w, t: float = 0.0,
                    meta: Optional[dict] = None):
    """Write the state ``w`` (a CPU tensor or an array), the time and a
    JSON-serializable ``meta`` mapping."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, w=np.asarray(w), t=t, meta=json.dumps(meta or {}))


def load_checkpoint(path: str) -> Tuple[np.ndarray, float, dict]:
    d = np.load(path, allow_pickle=False)
    return d["w"], float(d["t"]), json.loads(str(d["meta"]))


def save_vtk(path: str, asm, w) -> None:
    """Write the velocity (its P1 part, the values at the vertices) and the
    pressure on the mesh as legacy ASCII VTK: triangles (cell type 5, the
    velocity with a zero z component) or tets (type 10).  ``w`` may lie on
    any device; the text equals the JAX package's for the same state."""
    mesh = asm.mesh
    d = asm.dim
    w = w.cpu().numpy() if hasattr(w, "cpu") else np.asarray(w)
    nv = mesh.num_vertices
    vdofs = asm.W.V.vertex_dofs()
    qdofs = asm.W.Q.vertex_dofs()
    n2 = asm.n2
    u = [w[a * n2:(a + 1) * n2][vdofs] for a in range(d)]
    if d == 2:
        u.append(np.zeros(nv))
    p = w[d * n2:][qdofs]
    npts = d + 1                        # vertices per simplex cell
    cell_type = 5 if d == 2 else 10     # VTK_TRIANGLE / VTK_TETRA
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nfenapack_tpu\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {nv} float\n")
        for v in mesh.vertices:
            z = v[2] if d == 3 else 0.0
            f.write(f"{v[0]} {v[1]} {z}\n")
        nc = mesh.num_cells
        f.write(f"CELLS {nc} {(npts + 1) * nc}\n")
        for c in mesh.cells:
            f.write(f"{npts} " + " ".join(str(int(ci)) for ci in c[:npts])
                    + "\n")
        f.write(f"CELL_TYPES {nc}\n")
        f.write(f"{cell_type}\n" * nc)
        f.write(f"POINT_DATA {nv}\n")
        f.write("VECTORS velocity float\n")
        for a, b, c in zip(u[0], u[1], u[2]):
            f.write(f"{a} {b} {c}\n")
        f.write("SCALARS pressure float 1\nLOOKUP_TABLE default\n")
        for q in p:
            f.write(f"{q}\n")

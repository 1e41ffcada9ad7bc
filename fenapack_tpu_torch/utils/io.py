"""Checkpoint and resume, the port of ``fenapack_tpu/utils/io.py``: the
state is ``(w, t)``, so a checkpoint is an npz archive.  NumPy only.
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

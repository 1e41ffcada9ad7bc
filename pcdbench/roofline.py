"""The yardstick of the sparse products: the least time the card could take
for each call, from the operator's entries and never from its layout.

Frozen here so that a change to a kernel or a layout cannot move it.  A
product with ``nnz`` entries (the pattern's unique (row, column) pairs, as
its CSR would hold them) moves at least

    nnz * (value bytes + 4)          each entry: its value and an int32 column
    + n_cols * k * x bytes           x read once (k right-hand sides)
    + n_rows * k * y bytes           y written once (and y0 read, if given)

and makes 2 operations per entry and right-hand side.  An ELL, a CSR and a
BSR of one matrix therefore cost the same.  The least time is the bytes
over the HBM rate, or the operations over the dtype's peak if longer.

Peaks of one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM3;
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor cores.
"""
from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}           # by value bytes: f32, f64


def least_s(nbytes: float, flops: float, value_bytes: int) -> float:
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[value_bytes])


def single(nnz: int, n_rows: int, n_cols: int, k: int, value_bytes: int,
           vec_bytes: int):
    """``(bytes, flops)`` of ``y = A x`` with k right-hand sides."""
    return (nnz * (value_bytes + 4) + (n_cols + n_rows) * k * vec_bytes,
            2 * nnz * k)


def block(nnz: int, n_rows: int, n_cols: int, d: int, reaction: bool,
          y0: bool, value_bytes: int, vec_bytes: int):
    """``(bytes, flops)`` of the velocity block ``y[a] = A1 x[a] (+ y0[a])
    (+ sum_b R[a, b] x[b])`` over one pattern: the columns once, A1's
    values and each of the d*d reaction planes once."""
    planes = 1 + (d * d if reaction else 0)
    nbytes = (nnz * (4 + planes * value_bytes)
              + d * (n_cols + n_rows * (2 if y0 else 1)) * vec_bytes)
    flops = 2 * nnz * (d + (d * d if reaction else 0)) + (d * n_rows
                                                          if y0 else 0)
    return nbytes, flops

"""Packed symmetric matrix storage — the dspMatrix analog.

The reference's ``useMatrix=TRUE`` option returns Matrix::dspMatrix packed
upper triangles to halve the memory of the n x n symmetric outputs
(R/IBD.R:25,336,546,841, R/IBS.R:24; packed write in genPCA.cpp via
CdMatTri). Here the analog is :class:`PackedSymmetric`: the upper triangle
(including the diagonal) stored row-major in a flat vector of length
n(n+1)/2.
"""

from __future__ import annotations

import numpy as np


class PackedSymmetric:
    """Upper triangle (row-major, diagonal included) of a symmetric n x n
    matrix in a flat length-n(n+1)/2 vector.

    ``p[i, j]`` indexes like the dense matrix (numpy fancy indexing
    supported); ``p.full()`` expands to dense.
    """

    def __init__(self, n: int, packed: np.ndarray):
        packed = np.asarray(packed)
        if packed.shape != (n * (n + 1) // 2,):
            raise ValueError("packed length must be n*(n+1)/2")
        self.n = int(n)
        self.packed = packed

    @classmethod
    def from_full(cls, mat: np.ndarray) -> "PackedSymmetric":
        mat = np.asarray(mat)
        n = mat.shape[0]
        if mat.shape != (n, n):
            raise ValueError("matrix must be square")
        iu = np.triu_indices(n)
        return cls(n, np.ascontiguousarray(mat[iu]))

    def _flat_index(self, i, j):
        i = np.asarray(i, np.int64)
        j = np.asarray(j, np.int64)
        # dense-matrix index semantics: negatives wrap, out-of-range raises
        i = np.where(i < 0, i + self.n, i)
        j = np.where(j < 0, j + self.n, j)
        if np.any((i < 0) | (i >= self.n) | (j < 0) | (j >= self.n)):
            raise IndexError(f"index out of range for n={self.n}")
        lo = np.minimum(i, j)
        hi = np.maximum(i, j)
        # row-major upper triangle: offset(row) = row*n - row*(row-1)/2
        return lo * self.n - lo * (lo - 1) // 2 + (hi - lo)

    def __getitem__(self, idx):
        i, j = idx
        return self.packed[self._flat_index(i, j)]

    def diagonal(self) -> np.ndarray:
        i = np.arange(self.n)
        return self.packed[self._flat_index(i, i)]

    def full(self) -> np.ndarray:
        out = np.empty((self.n, self.n), self.packed.dtype)
        iu = np.triu_indices(self.n)
        out[iu] = self.packed
        out[(iu[1], iu[0])] = self.packed
        return out

    @property
    def shape(self):
        return (self.n, self.n)

    def __repr__(self):
        return (f"PackedSymmetric(n={self.n}, "
                f"dtype={self.packed.dtype}, "
                f"bytes={self.packed.nbytes})")


def maybe_packed(mat: np.ndarray, use_matrix: bool):
    """Dense symmetric matrix, or its packed triangle when use_matrix
    (the reference's useMatrix=TRUE return convention)."""
    return PackedSymmetric.from_full(mat) if use_matrix else mat

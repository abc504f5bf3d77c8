"""VBR — variable block row.

Reference: src/matrix/lis_matrix_vbr.c.  VBR partitions rows and columns into
variable-sized blocks; the reference itself gives it no MPI support (skipped
when nprocs>1, test/spmvtest1.c:201) and no specialised fast kernels.  Ragged
blocks do not map to fixed-shape tiles, so this class keeps the VBR
structural metadata (row/col partition + block pointers, matching the
reference's struct fields lis.h:641-657) for format fidelity, while compute
routes through an internal CSR view — same arrays, fixed shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lis_tpu.matrix.base import SparseMatrix, matrix_format, static, host


def auto_rowcol(ptr, index, n) -> tuple:
    """The reference's automatic VBR partition
    (lis_matrix_get_vbr_rowcol, src/matrix/lis_matrix_vbr.c:262): mark a
    boundary wherever any row's contiguous column run starts or ends, so
    blocks are the maximal column intervals no row's run crosses (the
    same partition is used for rows and columns)."""
    ptr = np.asarray(ptr)
    index = np.asarray(index, dtype=np.int64)
    if len(index):  # run detection needs sorted columns per row
        rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int64),
                         np.diff(ptr))
        index = index[np.lexsort((index, rows))]
    iw = np.zeros(n + 2, dtype=bool)
    if len(index):
        nz_rows = np.diff(ptr) > 0
        first = ptr[:-1][nz_rows]
        last = ptr[1:][nz_rows] - 1
        # run starts: first entry of each row + any entry whose left
        # neighbour (within the row) is not index-1
        starts = np.ones(len(index), dtype=bool)
        starts[1:] = index[1:] != index[:-1] + 1
        starts[first] = True
        # run ends: last entry of each row + any entry whose right
        # neighbour is not index+1
        ends = np.ones(len(index), dtype=bool)
        ends[:-1] = index[:-1] != index[1:] - 1
        ends[last] = True
        iw[index[starts]] = True
        iw[index[ends] + 1] = True
    iw[0] = False
    bounds = np.flatnonzero(iw)
    return (0,) + tuple(int(b) for b in bounds) + \
        ((n,) if (len(bounds) == 0 or bounds[-1] != n) else ())


@matrix_format("vbr")
class VBRMatrix(SparseMatrix):
    # CSR compute view
    ptr: jax.Array
    index: jax.Array
    value: jax.Array
    row_ids: jax.Array
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    # VBR structure (static tuples: host-side metadata)
    row_part: tuple = static()     # row partition boundaries, len nr+1
    col_part: tuple = static()     # col partition boundaries, len nc+1
    bptr: tuple = static()         # block-row pointers into bindex
    bindex: tuple = static()       # block-column index per stored block
    fast: object = None            # uniform partition: a BSRMatrix of the
                                   # SAME matrix — matvecs run its
                                   # windowed slabs instead of gathers

    def _rebuild_kwargs(self):
        return {"row_part": tuple(self.row_part),
                "col_part": tuple(self.col_part)}

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, row_part=None,
                        col_part=None, block: int | None = None
                        ) -> "VBRMatrix":
        """``block=None`` (the default) auto-detects the partition from the
        sparsity pattern the way the reference's conversion does
        (lis_matrix_get_vbr_rowcol, lis_matrix_vbr.c:262); an explicit
        ``block`` gives a uniform partition instead."""
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        if row_part is None and col_part is None and block is None and n == m:
            row_part = col_part = auto_rowcol(ptr, index, n)
        if block is None:
            block = 2
        if row_part is None:
            row_part = tuple(range(0, n, block)) + (n,)
        if col_part is None:
            col_part = tuple(range(0, m, block)) + (m,)
        row_part = tuple(dict.fromkeys(row_part))
        col_part = tuple(dict.fromkeys(col_part))
        # build block structure: which (brow, bcol) blocks are nonempty
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        brow = np.searchsorted(np.asarray(row_part), rows, side="right") - 1
        bcol = np.searchsorted(np.asarray(col_part), index, side="right") - 1
        nr = len(row_part) - 1
        pairs = np.unique(brow * (len(col_part) - 1) + bcol)
        bindex_all = (pairs % (len(col_part) - 1)).astype(int)
        brow_all = (pairs // (len(col_part) - 1)).astype(int)
        bptr = np.zeros(nr + 1, dtype=np.int64)
        np.add.at(bptr, brow_all + 1, 1)
        bptr = np.cumsum(bptr)
        row_ids = rows.astype(np.int32)
        # uniform partitions make the matrix EXACTLY a BSR: compute
        # matvecs through the BSR windowed-slab kernels (einsums)
        # instead of the scalar gather view — the VBR identity (block
        # ILU partition, conversions) is untouched.  Deliberate
        # trade-off: the CSR view stays resident next to the BSR slabs
        # (≈2x memory for this niche parity format) because the scalar
        # view defines the exact nonzero PATTERN (a BSR-derived view
        # would add explicit in-block zeros, changing ILU fill), and
        # same-format rebuilds re-run this constructor
        fast = None
        rs, cs = np.diff(np.asarray(row_part)), np.diff(np.asarray(col_part))
        if (len(rs) > 1 and rs.max() == rs.min()
                and np.array_equal(rs, cs) and rs[0] > 1):
            from lis_tpu.matrix.bsr import BSRMatrix
            fast = BSRMatrix.from_csr_arrays(ptr, index, value, shape,
                                             bnr=int(rs[0]))
        return cls(ptr=jnp.asarray(ptr, jnp.int32),
                   index=jnp.asarray(index, jnp.int32),
                   value=jnp.asarray(value),
                   row_ids=jnp.asarray(row_ids),
                   nrows=int(n), ncols=int(m), nnz=int(len(value)),
                   row_part=row_part, col_part=col_part,
                   bptr=tuple(int(v) for v in bptr),
                   bindex=tuple(int(v) for v in bindex_all),
                   fast=fast)

    def to_csr_arrays(self):
        return host(self.ptr), host(self.index), host(self.value)

    def matvec(self, x):
        if self.fast is not None:
            return self.fast.matvec(x)
        prod = self.value * jnp.take(x, self.index, axis=0)
        return jax.ops.segment_sum(prod, self.row_ids,
                                   num_segments=self.nrows,
                                   indices_are_sorted=True)

    def matvech(self, x):
        if self.fast is not None:
            return self.fast.matvech(x)
        v = jnp.conj(self.value) if jnp.iscomplexobj(self.value) else self.value
        prod = v * jnp.take(x, self.row_ids, axis=0)
        y = jnp.zeros(self.ncols, dtype=prod.dtype)
        return y.at[self.index].add(prod)

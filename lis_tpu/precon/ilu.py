"""ILU preconditioners: ILU(k), ILUT, Crout ILU.

Reference: lis_precon_iluk.c (symbolic fact :263, numeric :638, psolve
:880, 3,019 LoC), lis_precon_ilut.c (dual-threshold, :67), and
lis_precon_iluc.c (Crout with drop/growth params, :67).  Options: -ilu_fill
(level-of-fill, default 0), -iluc_drop (0.05), -iluc_rate (5.0).

The split mirrors the reference's MPI behavior: factorization is a local
(block-Jacobi) operation on owned rows (the reference factors only the
local diagonal block under MPI), done host-side at create; the apply is two
level-scheduled triangular solves on device.  Host factorization is the
designated native-C++ acceleration point (the reference's is C for the same
reason).
"""

from __future__ import annotations

import jax
import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from lis_tpu.ops.trisolve import TriSolvePlan, make_plan, trisolve
from lis_tpu.precon.base import precon_pytree, register_precon


@precon_pytree
class ILUPrecon:
    lower: TriSolvePlan       # unit L (dinv = 1)
    upper: TriSolvePlan       # U (dinv = 1/U_ii)
    lower_t: TriSolvePlan     # Uᵀ scaled (for Mᴴ solve)
    upper_t: TriSolvePlan     # Lᵀ (unit)

    def psolve(self, r):
        return trisolve(self.upper, trisolve(self.lower, r))

    def psolveh(self, r):
        return trisolve(self.upper_t, trisolve(self.lower_t, r))


def _factor_iluk(ptr, index, value, n, fill):
    """Level-of-fill ILU(k), IKJ variant (Saad Alg. 10.5; reference's
    lis_symbolic_fact_csr + lis_numerical_fact_csr combined)."""
    rows_idx = []
    rows_val = []
    rows_lev = []
    # store factored rows as dicts col -> (val, lev)
    for i in range(n):
        work = {}
        lev = {}
        for p in range(ptr[i], ptr[i + 1]):
            work[int(index[p])] = value[p]
            lev[int(index[p])] = 0
        if i not in work:
            work[i] = 0.0
            lev[i] = 0
        for k in sorted(work):
            if k >= i:
                break
            lk = lev[k]
            if lk > fill:
                continue
            ukk = rows_val[k].get(k, 0.0)
            if ukk == 0.0:
                continue
            factor = work[k] / ukk
            work[k] = factor
            for j, vkj in rows_val[k].items():
                if j <= k:
                    continue
                new_lev = lk + rows_lev[k][j] + 1
                if j in work:
                    work[j] -= factor * vkj
                    lev[j] = min(lev[j], new_lev)
                elif new_lev <= fill:
                    work[j] = -factor * vkj
                    lev[j] = new_lev
        # drop entries above fill level (original entries are level 0)
        keep = {j: v for j, v in work.items() if lev[j] <= fill}
        if keep.get(i, 0.0) == 0.0:
            keep[i] = 1.0
        rows_val.append(keep)
        rows_lev.append(lev)
        rows_idx.append(sorted(keep))
    return rows_val


def _factor_ilut(ptr, index, value, n, drop, rate):
    """Dual-threshold ILUT matching the reference's actual rules
    (lis_precon_ilut.c:61-63,129-131,230-320):
    - drop tolerance relative to the MEAN |a_ij| of the row;
    - the elimination factor is NEVER dropped — only update terms with
      |l_ik*u_kj| < tol that would create NEW fill are skipped;
    - the final keep is the top lfil = (nnz/2n)*rate entries PER SIDE by
      magnitude (no tolerance filter), diagonal always kept."""
    import heapq
    rows_val = []
    diag = np.zeros(n, dtype=value.dtype)
    nnz_tot = int(ptr[n]) if len(ptr) > n else len(value)
    lfil = max(int((nnz_tot / (2.0 * max(n, 1))) * rate), 1)
    for i in range(n):
        work = {}
        abssum = 0.0
        for p in range(ptr[i], ptr[i + 1]):
            c = int(index[p])
            work[c] = work.get(c, 0.0) + value[p]
            abssum += abs(value[p])
        k_cnt = max(ptr[i + 1] - ptr[i], 1)
        nrm = abssum / k_cnt or 1.0
        tol_i = drop * nrm

        heap = [c for c in work if c < i]
        heapq.heapify(heap)
        done = set()
        while heap:
            k = heapq.heappop(heap)
            if k in done or k not in work:
                continue
            done.add(k)
            dk = diag[k]
            if dk == 0.0:
                continue
            fact = work[k] / dk
            work[k] = fact
            for j, ukj in rows_val[k].items():
                if j <= k:
                    continue
                lxu = -fact * ukj
                if abs(lxu) < tol_i and j not in work:
                    continue
                work[j] = work.get(j, 0.0) + lxu
                if j < i and j not in done:
                    heapq.heappush(heap, j)

        dv = work.get(i, 0.0)
        if dv == 0.0:
            dv = nrm
        lower = sorted(((abs(v), j) for j, v in work.items() if j < i),
                       reverse=True)[:lfil]
        upper = sorted(((abs(v), j) for j, v in work.items() if j > i),
                       reverse=True)[:lfil]
        keep = {j: work[j] for _, j in lower}
        keep.update({j: work[j] for _, j in upper})
        keep[i] = dv
        diag[i] = dv
        rows_val.append(keep)
    return rows_val


def _factor_iluc(ptr, index, value, n, drop, rate):
    """Crout ILU (Li/Saad/Chow scheme; reference lis_precon_iluc.c:67): at
    step k compute row k of U and column k of L, each with relative drop
    tolerance (-iluc_drop) and a fill growth bound (-iluc_rate).  Unlike
    row-IKJ ILUT, updates read already-DROPPED factor entries of both L and
    U, so the computed factors differ from ILUT's whenever dropping is
    active.  Pure-Python fallback for the native iluc_factor."""
    Urows = [dict() for _ in range(n)]     # row k of U (incl. diagonal)
    Lcols = [dict() for _ in range(n)]     # column k of L (strict)
    Lrows = [dict() for _ in range(n)]     # mirror: row view of L
    Ucols = [dict() for _ in range(n)]     # mirror: column view of strict U
    Acols = [[] for _ in range(n)]         # strict-lower A by column
    rownrm = np.zeros(n)
    colnrm = np.zeros(n)
    nnz_col = np.zeros(n, dtype=np.int64)
    nnz_row = np.diff(ptr)
    for i in range(n):
        for p in range(ptr[i], ptr[i + 1]):
            vp = value[p]
            c = int(index[p])
            a2 = abs(vp) ** 2          # == vp*vp for real, |vp|^2 complex
            rownrm[i] += a2
            colnrm[c] += a2
            nnz_col[c] += 1
            if c < i:
                Acols[c].append((i, vp))
    rownrm = np.sqrt(rownrm)
    colnrm = np.sqrt(colnrm)
    rownrm[rownrm == 0] = 1.0
    colnrm[colnrm == 0] = 1.0

    for k in range(n):
        z = {}
        for p in range(ptr[k], ptr[k + 1]):
            c = int(index[p])
            if c >= k:
                z[c] = z.get(c, 0.0) + value[p]
        for j, lkj in Lrows[k].items():
            for c, u in Urows[j].items():
                if c >= k:
                    z[c] = z.get(c, 0.0) - lkj * u
        w = {}
        for r, vp in Acols[k]:
            w[r] = w.get(r, 0.0) + vp
        for j, ujk in Ucols[k].items():
            for r, l in Lcols[j].items():
                if r > k:
                    w[r] = w.get(r, 0.0) - ujk * l
        dv = z.pop(k, 0.0)
        if dv == 0.0:
            dv = rownrm[k]
        tol_r = drop * rownrm[k]
        tol_c = drop * colnrm[k]
        keep_u = sorted(((c, v) for c, v in z.items() if abs(v) >= tol_r),
                        key=lambda t: -abs(t[1]))[:max(int(rate * nnz_row[k]), 2)]
        Urows[k] = {k: dv, **dict(keep_u)}
        for c, v in keep_u:
            Ucols[c][k] = v
        keep_l = sorted(((r, v) for r, v in w.items() if abs(v) >= tol_c),
                        key=lambda t: -abs(t[1]))[:max(int(rate * nnz_col[k]), 2)]
        Lcols[k] = {r: v / dv for r, v in keep_l}
        for r, v in keep_l:
            Lrows[r][k] = v / dv

    # merge into per-row dicts for _plans_from_rows
    return [{**Lrows[i], **Urows[i]} for i in range(n)]


def _plans_from_rows(rows_val, n, shape):
    li, lv, lp = [], [], [0]
    ui, uv, up = [], [], [0]
    # cheap complex sniff (short-circuits on the first complex entry —
    # an O(nnz) np.result_type over 0-d arrays costs seconds at 100k rows)
    dtype = (np.complex128
             if any(isinstance(v, complex) or np.iscomplexobj(v)
                    for row in rows_val for v in row.values())
             else np.float64)
    udiag = np.zeros(n, dtype=dtype)
    for i in range(n):
        for j in sorted(rows_val[i]):
            v = rows_val[i][j]
            if j < i:
                li.append(j)
                lv.append(v)
            else:
                ui.append(j)
                uv.append(v)
                if j == i:
                    udiag[i] = v
        lp.append(len(li))
        up.append(len(ui))
    lp = np.asarray(lp, dtype=np.int32)
    up = np.asarray(up, dtype=np.int32)
    li = np.asarray(li, dtype=np.int32)
    ui = np.asarray(ui, dtype=np.int32)
    lv = np.asarray(lv)
    uv = np.asarray(uv)
    return _plans_from_lu(lp, li, lv, up, ui, uv, udiag, n, shape)


def _plans_from_combined_csr(ptr, index, value, n, shape):
    """Split a combined LU CSR (factors in L part, U incl. diagonal) into
    the plan arrays — used with the native factorisation output."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    lower = index < rows
    upper = ~lower
    udiag = np.zeros(n, dtype=value.dtype)
    isd = index == rows
    np.add.at(udiag, rows[isd], value[isd])

    def side(mask):
        r, c, v = rows[mask], index[mask], value[mask]
        p = np.zeros(n + 1, dtype=np.int32)
        np.add.at(p, r + 1, 1)
        return np.cumsum(p).astype(np.int32), c.astype(np.int32), v

    lp, li, lv = side(lower)
    up, ui, uv = side(upper)
    return _plans_from_lu(lp, li, lv, up, ui, uv, udiag, n, shape)


def _plans_from_lu(lp, li, lv, up, ui, uv, udiag, n, shape):
    with np.errstate(divide="ignore"):
        udinv = np.where(udiag != 0, 1.0 / np.where(udiag != 0, udiag, 1), 1.0)

    # strictly-upper part of U for the solve (diag handled by dinv)
    strict = ui != np.repeat(np.arange(n), np.diff(up))
    sui, suv = ui[strict], uv[strict]
    sup = np.zeros(n + 1, dtype=np.int32)
    np.add.at(sup, np.repeat(np.arange(n), np.diff(up))[strict] + 1, 1)
    sup = np.cumsum(sup).astype(np.int32)

    lower = make_plan(lp, li, lv, np.ones(n), lower=True)
    upper = make_plan(sup, sui, suv, udinv, lower=False)

    # transposed factors: Mᴴx=b -> Uᴴ (lower, diag 1/conj(u_ii)) then Lᴴ
    Lm = sp.csr_matrix((lv, li, lp), shape=shape)
    Um_strict = sp.csr_matrix((suv, sui, sup), shape=shape)
    Ut = Um_strict.T.tocsr()
    Lt = Lm.T.tocsr()
    Ut.sort_indices(); Lt.sort_indices()
    # Uᴴ y = b with Uᴴ = (D_u + U_s)ᴴ: y[i] = (b[i] - Σ Ūs[j,i] y[j])·(1/ū_ii)
    lower_t = make_plan(Ut.indptr, Ut.indices,
                        np.conj(Ut.data) if np.iscomplexobj(Ut.data) else Ut.data,
                        np.conj(udinv) if np.iscomplexobj(udinv) else udinv,
                        lower=True)
    upper_t = make_plan(Lt.indptr, Lt.indices,
                        np.conj(Lt.data) if np.iscomplexobj(Lt.data) else Lt.data,
                        np.ones(n), lower=False)
    return ILUPrecon(lower=lower, upper=upper,
                     lower_t=lower_t, upper_t=upper_t)


@precon_pytree
class ILUDiaPrecon:
    """ILU(0) factors of a DIA-structured matrix, applied by Jacobi-relaxed
    sweeps of diagonal streams — the DIA path (level-scheduled
    triangular solves gather; the reference's own OpenMP
    tri-solve already relaxes cross-thread dependencies,
    src/matrix/lis_matrix_csr.c:1577-1605).  ILU(0) preserves the sparsity
    pattern, so the factors of a DIA matrix are DIA with the same offsets.
    Sweep count: -ssor_sweeps (shared knob, default 2)."""
    L: object                 # strict-lower DIA (unit diagonal implied)
    U: object                 # strict-upper DIA
    udinv: jax.Array          # 1 / diag(U)
    nsweeps: int
    _static = ("nsweeps",)

    def psolve(self, r):
        y = r
        for _ in range(self.nsweeps):
            y = r - self.L.matvec(y)
        z = y * self.udinv
        for _ in range(self.nsweeps):
            z = (y - self.U.matvec(z)) * self.udinv
        return z

    def psolveh(self, r):
        # (LU)ᴴ = UᴴLᴴ: solve Uᴴw = r then Lᴴz = w
        ud = jnp.conj(self.udinv) if jnp.iscomplexobj(self.udinv)             else self.udinv
        w = r * ud
        for _ in range(self.nsweeps):
            w = (r - self.U.matvech(w)) * ud
        z = w
        for _ in range(self.nsweeps):
            z = w - self.L.matvech(z)
        return z


def _dia_from_csr(ptr, index, value, n):
    """(ptr,index,value) -> (strict-lower DIA, strict-upper DIA, diag)."""
    from lis_tpu.matrix.dia import DIAMatrix
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    offs_all = index.astype(np.int64) - rows
    diag = np.zeros(n, dtype=value.dtype)
    isd = offs_all == 0
    np.add.at(diag, rows[isd], value[isd])

    def side(mask):
        offs = np.unique(offs_all[mask])
        v = np.zeros((max(len(offs), 1), n), dtype=value.dtype)
        if mask.any():
            pos = np.searchsorted(offs, offs_all[mask])
            np.add.at(v, (pos, rows[mask]), value[mask])
        return DIAMatrix(value=tuple(jnp.asarray(v[k])
                                     for k in range(v.shape[0])),
                         nrows=n, ncols=n, nnz=int(np.count_nonzero(v)),
                         offsets=tuple(int(o) for o in offs) or (0,))
    return side(offs_all < 0), side(offs_all > 0), diag


@register_precon("ilu")
def create_iluk(A, opts):
    fill = getattr(opts, "ilu_fill", 0)
    if getattr(A, "format_name", None) == "bsr":
        return _create_bilu(A, fill)
    if getattr(A, "format_name", None) == "vbr":
        vb = _create_vbilu(A, fill)
        if vb is not None:
            return vb
    if getattr(A, "format_name", None) == "dia" and fill == 0:
        is_complex = any(jnp.iscomplexobj(v) for v in A.value)
        if not is_complex:
            n = A.nrows
            from lis_tpu import _native
            # fast path: factor directly on the diagonal arrays (no format
            # round trips; exact match with the generic ILU(0))
            lu = _native.ilu0_dia(np.asarray(A.offsets), A.value_2d)
            if lu is not None:
                from lis_tpu.matrix.dia import DIAMatrix
                offs = tuple(int(o) for o in A.offsets)
                # upload the factors in the OPERATOR's dtype: at 10M-row
                # f32 solves the f64 default doubles a ~1 GB transfer
                in_dt = A.value[0].dtype if A.value else lu.dtype
                lu = lu.astype(in_dt) if lu.dtype != in_dt else lu

                nnz_row = [int(np.count_nonzero(lu[k]))
                           for k in range(len(offs))]

                def side(sel):
                    ks = [k for k, o in enumerate(offs) if sel(o)]
                    if not ks:
                        return DIAMatrix(value=(jnp.zeros(n, lu.dtype),),
                                         nrows=n, ncols=n, nnz=0,
                                         offsets=(0,))
                    return DIAMatrix(
                        value=tuple(jnp.asarray(lu[k]) for k in ks),
                        nrows=n, ncols=n,
                        nnz=sum(nnz_row[k] for k in ks),
                        offsets=tuple(offs[k] for k in ks))

                k0 = offs.index(0)
                d = lu[k0]
                with np.errstate(divide="ignore"):
                    udinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1),
                                     1.0)
                return ILUDiaPrecon(L=side(lambda o: o < 0),
                                    U=side(lambda o: o > 0),
                                    udinv=jnp.asarray(udinv),
                                    nsweeps=getattr(opts, "ssor_sweeps", 2))
            # no native library: generic factorization, DIA apply
            ptr, index, value = A.to_csr_arrays()
            rows_val = _factor_iluk(ptr, index, value, n, 0)
            fi, fv, fp = [], [], [0]
            for i in range(n):
                for j in sorted(rows_val[i]):
                    fi.append(j)
                    fv.append(rows_val[i][j])
                fp.append(len(fi))
            L, U, d = _dia_from_csr(np.asarray(fp, np.int32),
                                    np.asarray(fi, np.int32),
                                    np.asarray(fv), n)
            with np.errstate(divide="ignore"):
                udinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
            return ILUDiaPrecon(L=L, U=U, udinv=jnp.asarray(udinv),
                                nsweeps=getattr(opts, "ssor_sweeps", 2))
    ptr, index, value = A.to_csr_arrays()
    if not np.iscomplexobj(value):
        from lis_tpu import _native
        out = _native.iluk_factor(ptr, index, value, fill)
        if out is not None:
            return _plans_from_combined_csr(*out, A.nrows, A.shape)
    rows = _factor_iluk(ptr, index, value, A.nrows, fill)
    return _plans_from_rows(rows, A.nrows, A.shape)


@precon_pytree
class BlockILUPrecon:
    """Block ILU(k) for BSR operators: M = (I+L)·D·(I+Ũ) with block
    factors, Ũ = D⁻¹U.  Reference: lis_precon_iluk.c:1289 (symbolic),
    :1670 (numeric, block ops via lis_array_matmat/lis_array_ge), psolve
    :1990.  The apply is two level-scheduled scalar triangular solves on
    the block-expanded unit factors plus one batched (nr,bnr,bnr) block
    D⁻¹ einsum between them — batched dense work instead of the reference's scalar
    per-block loops."""
    lower: TriSolvePlan       # expanded L̃ (unit diag)
    upper: TriSolvePlan       # expanded Ũ = D⁻¹U (unit diag)
    lower_t: TriSolvePlan     # Ũᴴ (unit lower)
    upper_t: TriSolvePlan     # L̃ᴴ (unit upper)
    dinv: jax.Array           # (nr, bnr, bnr) inverted diagonal blocks
    n: int                    # true (unpadded) size
    bnr: int
    _static = ("n", "bnr")

    def _apply(self, r, lo, d, up):
        N = d.shape[0] * self.bnr
        rp = r if r.shape[0] == N else jnp.pad(r, (0, N - r.shape[0]))
        z = trisolve(lo, rp)
        w = jnp.einsum("tij,tj->ti", d,
                       z.reshape(-1, self.bnr)).reshape(-1)
        return trisolve(up, w)[: self.n]

    def psolve(self, r):
        return self._apply(r, self.lower, self.dinv, self.upper)

    def psolveh(self, r):
        dh = jnp.conj(jnp.swapaxes(self.dinv, -1, -2))
        return self._apply(r, self.lower_t, dh, self.upper_t)


def _bilu_symbolic(bptr, bindex, nr, fill):
    """Level-of-fill pattern at block granularity (the reference's
    lis_symbolic_fact_bsr, lis_precon_iluk.c:1289): single ascending
    pivot pass per row, fill entry kept when lev(j)+lev(U_jk)+1 ≤ fill."""
    import heapq
    upat = []
    rows = []
    for i in range(nr):
        lev = {int(j): 0 for j in bindex[bptr[i]:bptr[i + 1]]}
        lev.setdefault(i, 0)
        heap = [c for c in lev if c < i]
        heapq.heapify(heap)
        seen = set()
        while heap:
            j = heapq.heappop(heap)
            if j in seen:
                continue
            seen.add(j)
            lj = lev[j]
            for k, lu in upat[j].items():
                l = lj + lu + 1
                if l <= fill:
                    if k not in lev:
                        if k < i:
                            heapq.heappush(heap, k)
                        lev[k] = l
                    elif l < lev[k]:
                        lev[k] = l
        rows.append(sorted(lev))
        upat.append({k: v for k, v in lev.items() if k > i})
    return rows


def _factor_bilu(bptr, bindex, bval, nr, bnr, fill):
    """Block IKJ ILU(k): L_ij ← A_ij·D_j⁻¹, row updates −L_ij·U_jk kept
    on the symbolic pattern, D_i inverted after its row (the reference's
    lis_numerical_fact_bsr, lis_precon_iluk.c:1670)."""
    patt = _bilu_symbolic(bptr, bindex, nr, fill)
    dtype = bval.dtype if np.issubdtype(bval.dtype, np.complexfloating) \
        else np.float64
    Dinv = np.zeros((nr, bnr, bnr), dtype=dtype)
    Lrows = []
    Urows = []
    z = np.zeros((bnr, bnr), dtype=dtype)
    for i in range(nr):
        row = {c: z.copy() for c in patt[i]}
        for p in range(bptr[i], bptr[i + 1]):
            row[int(bindex[p])] = bval[p].astype(dtype).copy()
        for j in (c for c in patt[i] if c < i):
            Lij = row[j] @ Dinv[j]
            row[j] = Lij
            for k, Ujk in Urows[j].items():
                tgt = row.get(k)
                if tgt is not None:
                    tgt -= Lij @ Ujk
        d = row[i]
        try:
            Dinv[i] = np.linalg.inv(d)
        except np.linalg.LinAlgError:
            Dinv[i] = np.linalg.pinv(d)
        Urows.append({k: v for k, v in row.items() if k > i})
        Lrows.append({k: v for k, v in row.items() if k < i})
    return Lrows, Urows, Dinv


def _blocks_to_strict_csr(rows, nr, bnr, dtype):
    indptr = [0]
    indices = []
    data = []
    for row in rows:
        for c in sorted(row):
            indices.append(c)
            data.append(row[c])
        indptr.append(len(indices))
    if not indices:
        return sp.csr_matrix((nr * bnr, nr * bnr), dtype=dtype)
    m = sp.bsr_matrix((np.asarray(data, dtype=dtype),
                       np.asarray(indices, np.int32),
                       np.asarray(indptr, np.int32)),
                      shape=(nr * bnr, nr * bnr)).tocsr()
    m.eliminate_zeros()
    m.sort_indices()
    return m


def _create_bilu(A, fill):
    p, i, v = A.to_csr_arrays()
    N = A.nr * A.bnr
    a = sp.csr_matrix((np.asarray(v), np.asarray(i), np.asarray(p)),
                      shape=A.shape)
    a.resize((N, N))
    if N > A.nrows:  # unit diagonal on padded rows keeps D blocks regular
        pad_d = np.arange(A.nrows, N)
        a = (a + sp.coo_matrix((np.ones(len(pad_d)), (pad_d, pad_d)),
                               shape=(N, N))).tocsr()
    b = sp.bsr_matrix(a, blocksize=(A.bnr, A.bnr))
    b.sort_indices()
    Lrows, Urows, Dinv = _factor_bilu(b.indptr, b.indices, b.data,
                                      A.nr, A.bnr, fill)
    dtype = Dinv.dtype
    Ut_rows = [{k: Dinv[t] @ blk for k, blk in Urows[t].items()}
               for t in range(A.nr)]
    L = _blocks_to_strict_csr(Lrows, A.nr, A.bnr, dtype)
    U = _blocks_to_strict_csr(Ut_rows, A.nr, A.bnr, dtype)
    lo, up, lo_t, up_t = _unit_factor_plans(L, U)
    return BlockILUPrecon(
        lower=lo, upper=up, lower_t=lo_t, upper_t=up_t,
        dinv=jnp.asarray(Dinv), n=A.nrows, bnr=A.bnr)


def _unit_factor_plans(L, U):
    """Level-scheduled solve plans for the unit factors (I+L), (I+Û) and
    their conjugate transposes, from strict-triangular CSR parts —
    shared by the uniform-block and variable-block builders."""
    n = L.shape[0]
    ones = np.ones(n, dtype=L.dtype)
    LH = L.conj().T.tocsr()
    UH = U.conj().T.tocsr()
    LH.sort_indices()
    UH.sort_indices()
    return (make_plan(L.indptr, L.indices, L.data, ones, lower=True),
            make_plan(U.indptr, U.indices, U.data, ones, lower=False),
            make_plan(UH.indptr, UH.indices, UH.data, ones, lower=True),
            make_plan(LH.indptr, LH.indices, LH.data, ones, lower=False))


@precon_pytree
class VBlockILUPrecon:
    """Variable-block ILU(k) for VBR operators: M = (I+L̂)·D·(I+Û) with
    blocks sized by the VBR partition, Û = D⁻¹U.  Reference:
    lis_symbolic_fact_vbr / lis_numerical_fact_vbr / lis_psolve_iluk_vbr
    (lis_precon_iluk.c:2220-2905).  The unit factors expand to scalar
    level-scheduled triangular solves.  The block-diagonal D⁻¹ (variable
    block sizes, so no single aligned batched einsum) applies as diagonal
    streams of its scalar expansion when max_block is small (bandwidth
    ≤ 2·max_block−1), and as a padded gather/einsum/scatter when a large
    block would blow the stream count up.
    (The reference leaves lis_psolveh_iluk_vbr unimplemented — BiCG on
    VBR+ILU errors out there; the transposed apply here is complete.)"""
    lower: TriSolvePlan       # L̂ expanded (unit lower)
    upper: TriSolvePlan       # Û = D⁻¹U expanded (unit upper)
    lower_t: TriSolvePlan     # Ûᴴ (unit lower)
    upper_t: TriSolvePlan     # L̂ᴴ (unit upper)
    dL: object                # strict-lower DIA streams of expanded D⁻¹
    dU: object                # strict-upper DIA streams of expanded D⁻¹
    dd: object                # diagonal of expanded D⁻¹
    pbinv: object = None      # (nbl, mb, mb) padded D⁻¹ blocks (large mb)
    pidx: object = None       # (nbl, mb) global row per slot; n = padding

    def _pad_apply(self, binv, x):
        xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        z = jnp.einsum("kij,kj->ki", binv, xp[self.pidx])
        return jnp.zeros(x.shape[0] + 1,
                         z.dtype).at[self.pidx].add(z)[:-1]

    def _dinv(self, x):
        if self.pbinv is not None:
            return self._pad_apply(self.pbinv, x)
        return self.dL.matvec(x) + self.dU.matvec(x) + self.dd * x

    def _dinvh(self, x):
        if self.pbinv is not None:
            b = jnp.conj(self.pbinv) if jnp.iscomplexobj(self.pbinv) \
                else self.pbinv
            return self._pad_apply(jnp.swapaxes(b, 1, 2), x)
        dd = jnp.conj(self.dd) if jnp.iscomplexobj(self.dd) else self.dd
        return self.dL.matvech(x) + self.dU.matvech(x) + dd * x

    def psolve(self, r):
        return trisolve(self.upper, self._dinv(trisolve(self.lower, r)))

    def psolveh(self, r):
        # M⁻ᴴ = (I+L̂)⁻ᴴ D⁻ᴴ (I+Û)⁻ᴴ
        return trisolve(self.upper_t, self._dinvh(trisolve(self.lower_t, r)))


def _create_vbilu(A, fill):
    """Build the VBR block ILU(k); returns None when the VBR partition is
    not square-conformal (row/col partitions differ) or is all 1×1 (the
    scalar CSR path is identical and cheaper) — the caller falls back."""
    part = tuple(A.row_part)
    if part != tuple(A.col_part) or A.shape[0] != A.shape[1]:
        return None
    sizes = np.diff(np.asarray(part))
    if not len(sizes) or sizes.max() <= 1:
        return None
    nr = len(part) - 1
    p, i, v = (np.asarray(t) for t in A.to_csr_arrays())
    a = sp.csr_matrix((v, i, p), shape=A.shape)
    bptr = np.asarray(A.bptr)
    bindex = np.asarray(A.bindex)

    patt = _bilu_symbolic(bptr, bindex, nr, fill)
    dtype = np.complex128 if np.iscomplexobj(v) else np.float64
    stored = [{} for _ in range(nr)]
    for bi in range(nr):
        r0, r1 = part[bi], part[bi + 1]
        for q in range(bptr[bi], bptr[bi + 1]):
            bj = int(bindex[q])
            stored[bi][bj] = a[r0:r1, part[bj]:part[bj + 1]] \
                .toarray().astype(dtype)
    # block IKJ at variable sizes (mirrors _factor_bilu)
    Dinv = []
    Lrows, Urows = [], []
    for bi in range(nr):
        row = {c: np.zeros((sizes[bi], sizes[c]), dtype=dtype)
               for c in patt[bi]}
        row.update(stored[bi])
        for j in (c for c in patt[bi] if c < bi):
            Lij = row[j] @ Dinv[j]
            row[j] = Lij
            for k, Ujk in Urows[j].items():
                tgt = row.get(k)
                if tgt is not None:
                    tgt -= Lij @ Ujk
        d = row.get(bi)
        if d is None:
            d = np.eye(sizes[bi], dtype=dtype)
        try:
            Dinv.append(np.linalg.inv(d))
        except np.linalg.LinAlgError:
            Dinv.append(np.linalg.pinv(d))
        Urows.append({k: blk for k, blk in row.items() if k > bi})
        Lrows.append({k: blk for k, blk in row.items() if k < bi})

    n = A.shape[0]

    def expand(rows_of_blocks):
        rr, cc, vv = [], [], []
        for bi, row in enumerate(rows_of_blocks):
            for bj, blk in row.items():
                r0, c0 = part[bi], part[bj]
                ri, ci = np.nonzero(blk)
                rr.append(ri + r0)
                cc.append(ci + c0)
                vv.append(blk[ri, ci])
        if not rr:
            return sp.csr_matrix((n, n), dtype=dtype)
        m = sp.coo_matrix((np.concatenate(vv),
                           (np.concatenate(rr), np.concatenate(cc))),
                          shape=(n, n)).tocsr()
        m.sort_indices()
        return m

    Ut_rows = [{k: Dinv[t] @ blk for k, blk in Urows[t].items()}
               for t in range(nr)]
    L = expand(Lrows)
    U = expand(Ut_rows)
    lo, up, lo_t, up_t = _unit_factor_plans(L, U)
    mb = int(sizes.max())
    if mb <= 64:
        # small blocks: 2·mb−1 DIA streams of the scalar expansion
        Dx = expand([{bi: Dinv[bi]} for bi in range(nr)])
        dLo, dUp, dd = _dia_from_csr(Dx.indptr, Dx.indices, Dx.data, n)
        return VBlockILUPrecon(lower=lo, upper=up, lower_t=lo_t,
                               upper_t=up_t, dL=dLo, dU=dUp,
                               dd=jnp.asarray(dd))
    # a large block would cost 2·mb−1 length-n streams; pad the blocks
    # to mb and batch one einsum instead (memory nr·mb² ≤ n·mb)
    pidx = np.full((nr, mb), n, np.int32)
    pbinv = np.zeros((nr, mb, mb), dtype=dtype)
    for k in range(nr):
        pidx[k, :sizes[k]] = np.arange(part[k], part[k + 1])
        pbinv[k, :sizes[k], :sizes[k]] = Dinv[k]
    return VBlockILUPrecon(lower=lo, upper=up, lower_t=lo_t, upper_t=up_t,
                           dL=None, dU=None, dd=None,
                           pbinv=jnp.asarray(pbinv),
                           pidx=jnp.asarray(pidx))


def _maybe_dia_apply(fp, fi, fv, A, opts, max_nnd=512):
    """Opportunistic DIA relaxed-sweep apply for a factored LU in CSR: the
    factors of a banded operator keep (roughly) its profile, so when they
    fit on few diagonals the psolve can be diagonal streams instead of
    gather-bound level-scheduled plans."""
    n = A.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(fp))
    offs = np.unique(fi.astype(np.int64) - rows)
    if len(offs) > max_nnd or len(offs) * n > 4 * max(len(fv), 1):
        return None
    L, U, d = _dia_from_csr(fp, fi, fv, n)
    with np.errstate(divide="ignore"):
        udinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)
    return ILUDiaPrecon(L=L, U=U, udinv=jnp.asarray(udinv),
                        nsweeps=getattr(opts, "ssor_sweeps", 2))


@register_precon("ilut")
def create_ilut(A, opts):
    ptr, index, value = A.to_csr_arrays()
    drop = getattr(opts, "iluc_drop", 0.05)
    rate = getattr(opts, "iluc_rate", 5.0)
    if not np.iscomplexobj(value):
        from lis_tpu import _native
        out = _native.ilut_factor(ptr, index, value, drop, rate)
        if out is not None:
            if getattr(A, "format_name", None) == "dia":
                fast = _maybe_dia_apply(np.asarray(out[0]),
                                        np.asarray(out[1]),
                                        np.asarray(out[2]), A, opts)
                if fast is not None:
                    return fast
            return _plans_from_combined_csr(*out, A.nrows, A.shape)
    rows = _factor_ilut(ptr, index, value, A.nrows, drop, rate)
    return _plans_from_rows(rows, A.nrows, A.shape)


@register_precon("iluc")
def create_iluc(A, opts):
    """Crout ILU (reference lis_precon_iluc.c:67): row-of-U/column-of-L
    factorisation with -iluc_drop / -iluc_rate, distinct from ILUT."""
    ptr, index, value = A.to_csr_arrays()
    drop = getattr(opts, "iluc_drop", 0.05)
    rate = getattr(opts, "iluc_rate", 5.0)
    if not np.iscomplexobj(value):
        from lis_tpu import _native
        out = _native.iluc_factor(ptr, index, value, drop, rate)
        if out is not None:
            if getattr(A, "format_name", None) == "dia":
                fast = _maybe_dia_apply(np.asarray(out[0]),
                                        np.asarray(out[1]),
                                        np.asarray(out[2]), A, opts)
                if fast is not None:
                    return fast
            return _plans_from_combined_csr(*out, A.nrows, A.shape)
    rows = _factor_iluc(ptr, index, value, A.nrows, drop, rate)
    return _plans_from_rows(rows, A.nrows, A.shape)

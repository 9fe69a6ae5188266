"""Distributed Schur-complement SpGEMM (ring over column panels).

Device replacement for the reference's shared-memory Schur kernels
(``/root/reference/src/hif/alg/Schur.hpp:214`` serial, ``:587-700`` OpenMP
row blocks): the SURVEY §2.7 strategy #2 — local ``L_E·D·U_F`` products over
*column-partitioned* ``U_F`` panels with the panels rotated around the device
ring (``ppermute``), so that

- device ``k`` owns row block ``k`` of ``L_E`` / ``C`` and column panel ``k``
  of ``U_F``;
- at ring step ``e`` device ``k`` holds panel ``(k+e) % D`` and computes the
  partial rows ``(L_E·D·U_F)[rows_k, panel_{(k+e)%D}]`` — the per-step
  products are embarrassingly parallel and each step moves only one panel
  per device over the ring (the all-to-all of SURVEY realized as D-1
  neighbor exchanges);
- after D steps every device holds its full output rows.

The per-step product is a pure jitted kernel: gather the ``U_F`` panel rows
selected by the local ``L_E`` ELL block, flatten the (KL·KU) candidates per
row, sort by column (``lax.sort``) and segment-sum equal columns with a
cumulative-sum difference — no scatter, static shapes throughout (the space
caps ``⌈α·nnz⌉`` bound KL/KU, the same property the reference relies on for
its O(α·nnz) guarantee).

The A-tail block ``C`` is merged on host during compression (duplicate
coalescing in ``CSR.from_coo``), matching the reference semantics
``S = Â[p_{m+1:n}, q_{m+1:n}] − L_E·diag(d_B)·U_F``.

Scale note: one ring step materializes ``(nb, KL·KU)`` candidate pairs per
device and the host compresses each step's output before the next panel
rotation, so peak memory is one panel-step, not the whole product.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ds.csr import CSR
from .mesh import make_mesh

__all__ = ["schur_spgemm_ring"]


def _ell_pack(M: CSR, nrows_pad: int, sentinel: int):
    """Row-major ELL pack with padded rows and a sentinel column id."""
    counts = np.diff(M.indptr)
    K = max(int(counts.max()) if M.nrows else 0, 1)
    idx = np.full((nrows_pad, K), sentinel, dtype=np.int32)
    val = np.zeros((nrows_pad, K), dtype=M.data.dtype)
    if M.indices.size:
        rows = np.repeat(np.arange(M.nrows, dtype=np.int64), counts)
        offs = (np.arange(M.indices.size, dtype=np.int64)
                - np.repeat(M.indptr[:-1], counts))
        idx[rows, offs] = M.indices
        val[rows, offs] = M.data
    return idx, val, K


def _panelize_uf(U_F: CSR, D: int, cb: int):
    """Column panels of U_F as (D, m+1, KU) ELL with *local* column ids;
    row m is an all-sentinel row fed by padded L_E entries."""
    m = U_F.nrows
    cols = U_F.indices.astype(np.int64)
    panel = cols // cb
    local = (cols - panel * cb).astype(np.int32)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(U_F.indptr))
    KU = 1
    counts = np.zeros((D, m), dtype=np.int64)
    np.add.at(counts, (panel, rows), 1)
    KU = max(int(counts.max()) if counts.size else 0, 1)
    idx = np.full((D, m + 1, KU), cb, dtype=np.int32)
    val = np.zeros((D, m + 1, KU), dtype=U_F.data.dtype)
    # slot each entry within its (panel, row) run
    order = np.lexsort((local, rows, panel))
    pnl, rws, loc = panel[order], rows[order], local[order]
    dat = U_F.data[order]
    if order.size:
        key = pnl * (m + 1) + rws
        new = np.empty(order.size, dtype=bool)
        new[0] = True
        new[1:] = key[1:] != key[:-1]
        grp_start = np.repeat(np.flatnonzero(new),
                              np.diff(np.append(np.flatnonzero(new),
                                                order.size)))
        slot = np.arange(order.size) - grp_start
        idx[pnl, rws, slot] = loc
        val[pnl, rws, slot] = dat
    return idx, val, KU


def _partial_kernel(le_idx, le_val, d_ext, uf_idx, uf_val, *, cb: int,
                    axis: str):
    """One ring step on one device: masked (col, val) pairs of
    ``-(L_E·D·U_F)[rows_local, panel_local]``, columns local to the panel."""
    le_idx = le_idx[0]          # (nb, KL)
    le_val = le_val[0]
    uf_i = uf_idx[0]            # (m+1, KU)
    uf_v = uf_val[0]
    nb, KL = le_idx.shape
    KU = uf_i.shape[1]
    ld = le_val * d_ext[le_idx]                     # (nb, KL); sentinel -> 0
    cand_c = uf_i[le_idx].reshape(nb, KL * KU)      # sentinel row -> cb
    cand_v = (-(ld[:, :, None] * uf_v[le_idx])).reshape(nb, KL * KU)
    sc, sv = jax.lax.sort((cand_c, cand_v), dimension=-1, num_keys=1)
    # segment-sum runs of equal column via cumsum difference
    W = KL * KU
    pos = jnp.arange(W, dtype=jnp.int32)
    prev = jnp.concatenate(
        [jnp.full((nb, 1), -1, sc.dtype), sc[:, :-1]], axis=1)
    nxt = jnp.concatenate(
        [sc[:, 1:], jnp.full((nb, 1), cb + 1, sc.dtype)], axis=1)
    is_first = sc != prev
    is_last = sc != nxt
    cs = jnp.cumsum(sv, axis=-1)
    cs_excl = cs - sv
    start_pos = jax.lax.cummax(jnp.where(is_first, pos, 0), axis=1)
    base = jnp.take_along_axis(cs_excl, start_pos.astype(jnp.int32), axis=1)
    valid = is_last & (sc < cb)
    out_c = jnp.where(valid, sc, cb).astype(jnp.int32)
    out_v = jnp.where(valid, cs - base, 0.0)
    return out_c[None], out_v[None]


def _rotate_kernel(uf_idx, uf_val, *, axis: str, D: int):
    """Shift the U_F panel one device backward around the ring (device k
    receives panel (k+1)%D, so after e steps it holds panel (k+e)%D)."""
    perm = [(d, (d - 1) % D) for d in range(D)]
    return (jax.lax.ppermute(uf_idx, axis, perm),
            jax.lax.ppermute(uf_val, axis, perm))


def schur_spgemm_ring(C_tail: CSR, L_E: CSR, d: np.ndarray, U_F: CSR,
                      mesh: Optional[Mesh] = None) -> CSR:
    """S = C_tail − L_E·diag(d)·U_F via the ring SpGEMM over ``mesh``'s
    ``rows`` axis.  All inputs and the result are host CSR; device work is
    jitted + shard_mapped, communication is D−1 panel ``ppermute`` steps.

    Exact to fp roundoff vs the host Schur (the per-row segment sums use a
    different but fixed summation order).
    """
    if mesh is None:
        mesh = make_mesh()
    D = mesh.shape["rows"]
    nm, m = L_E.nrows, L_E.ncols
    if nm == 0:
        return C_tail
    nmp = -(-nm // D) * D
    nb = nmp // D
    cb = nmp // D  # panel width (same padded split over the tail columns)

    le_idx_h, le_val_h, KL = _ell_pack(L_E, nmp, sentinel=m)
    uf_idx_h, uf_val_h, KU = _panelize_uf(U_F, D, cb)
    d_ext = np.concatenate([np.asarray(d), np.zeros(1, dtype=L_E.data.dtype)])

    sh3 = NamedSharding(mesh, P("rows", None, None))
    le_idx = jax.device_put(jnp.asarray(le_idx_h.reshape(D, nb, KL)), sh3)
    le_val = jax.device_put(jnp.asarray(le_val_h.reshape(D, nb, KL)), sh3)
    uf_idx = jax.device_put(jnp.asarray(uf_idx_h), sh3)
    uf_val = jax.device_put(jnp.asarray(uf_val_h), sh3)
    d_dev = jnp.asarray(d_ext)

    import functools

    step = jax.jit(jax.shard_map(
        functools.partial(_partial_kernel, cb=cb, axis="rows"),
        mesh=mesh,
        in_specs=(P("rows", None, None), P("rows", None, None), P(),
                  P("rows", None, None), P("rows", None, None)),
        out_specs=(P("rows", None, None), P("rows", None, None)),
        check_vma=False))
    rotate = jax.jit(jax.shard_map(
        functools.partial(_rotate_kernel, axis="rows", D=D),
        mesh=mesh,
        in_specs=(P("rows", None, None), P("rows", None, None)),
        out_specs=(P("rows", None, None), P("rows", None, None)),
        check_vma=False))

    rows_acc, cols_acc, vals_acc = [], [], []
    row_base = np.repeat(np.arange(D, dtype=np.int64) * nb, nb)
    for e in range(D):
        out_c, out_v = step(le_idx, le_val, d_dev, uf_idx, uf_val)
        oc = np.asarray(out_c).reshape(D * nb, -1)
        ov = np.asarray(out_v).reshape(D * nb, -1)
        keep = oc < cb
        if keep.any():
            r, k = np.nonzero(keep)
            # device dev = r // nb holds panel (dev + e) % D at this step
            panel = (r // nb + e) % D
            rows_acc.append(r.astype(np.int64))
            cols_acc.append(panel * cb + oc[r, k].astype(np.int64))
            vals_acc.append(ov[r, k])
        if e < D - 1:
            uf_idx, uf_val = rotate(uf_idx, uf_val)

    # merge the A-tail block on host (duplicates coalesce in from_coo)
    c_rows = np.repeat(np.arange(nm, dtype=np.int64), np.diff(C_tail.indptr))
    rows_acc.append(c_rows)
    cols_acc.append(C_tail.indices.astype(np.int64))
    vals_acc.append(C_tail.data)
    S = CSR.from_coo(nmp, nmp,
                     np.concatenate(rows_acc), np.concatenate(cols_acc),
                     np.concatenate(vals_acc))
    if nmp != nm:
        S = CSR(nm, nm, S.indptr[:nm + 1], S.indices[:S.indptr[nm]],
                S.data[:S.indptr[nm]])
    else:
        S = CSR(nm, nm, S.indptr, S.indices, S.data)
    return S

"""Fully distributed multilevel M-solve.

Composes a distributed level-scheduled trsv with row-sharded E/F SpMV into
one ``shard_map``-ped multilevel solve: the factor operands — the memory
that grows with fill — are sharded over the ``rows`` axis.  Each level's
L/U triangular solve is carried by one of two interchangeable op objects:

* :class:`~.trsv_halo.HaloOp` (default) — the working vector lives
  *distributed* (own slots + exact host-counted halo); cross-device
  dependencies ride per-chunk ``ppermute``/compact-``all_gather`` packages
  sized to the real fan-in, overlapped with the next chunk's local FMA.
* :class:`AGTrsvOp` (fallback; also ``halo=False``) — the replicated
  working vector reassembled per chunk with a tiled ``all_gather``.

This supersedes the replicated M-solve in ``parallel/sharded.py`` for large
factors.  Reference serial recursion being distributed:
``/root/reference/src/hif/alg/prec_solve.hpp:333`` over
``CompressedStorage.hpp:2268`` solves.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..alg.prec import DenseTail, pack_tail, tail_solve
from ..ops.spmv import ELL, ell_from_csr
from ..ops.trsv import build_trsv_schedule
from .exchange import XPlan, build_exchange_plan, xplan_fetch
from .sharded import pad_rows
from .trsv_halo import HaloOp, build_halo_op, halo_op_kernel

__all__ = ["DistPrec", "AGTrsvOp"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class AGTrsvOp:
    """Tiled-all_gather trsv operand (one level's L or U factor).

    With ``sharded`` (the from_host default) the entry/exit index maps
    ``in_rows``/``out_slots`` are row-sharded too: the level-padded slot
    count is a multiple of n (one padded chunk per dependency level), so
    replicating in_rows costs O(slots) per device — measured 52+ bytes per
    matrix row at n=262k (examples/distprec_scale.py).  Each device maps
    its slice and one tiled all_gather reassembles."""

    in_rows: jax.Array     # (nslots,) entry map, sharded or replicated
    cols: jax.Array        # (nchunks, C, K) sharded over axis 1
    vals: jax.Array
    out_slots: jax.Array   # (n_pad,) exit map, sharded or replicated
    nchunks: int
    chunk: int
    n: int
    sharded: bool = False

    def tree_flatten(self):
        return ((self.in_rows, self.cols, self.vals, self.out_slots),
                (self.nchunks, self.chunk, self.n, self.sharded))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def spec(self) -> "AGTrsvOp":
        sh3 = P(None, "rows", None)
        vec = P("rows") if self.sharded else P()
        return AGTrsvOp(vec, sh3, sh3, vec, self.nchunks, self.chunk,
                        self.n, self.sharded)


def ag_op_kernel(op: AGTrsvOp, b: jax.Array) -> jax.Array:
    """shard_map-internal tiled-all_gather trsv (see trsv_sharded)."""
    if op.nchunks == 0:
        return b
    ndev = jax.lax.psum(1, "rows")
    my = jax.lax.axis_index("rows").astype(jnp.int32)
    Cloc = op.chunk // ndev
    nslots = op.nchunks * op.chunk
    b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
    if op.sharded:
        x = _gather_trim(b_ext[op.in_rows], nslots)
    else:
        x = b_ext[op.in_rows]
    x = jnp.concatenate([x, jnp.zeros((1,), dtype=b.dtype)])

    def body(carry, inputs):
        x, c = carry
        cc, vv = inputs
        contrib = (vv * x[cc]).sum(axis=1)
        cur = jax.lax.dynamic_slice(x, (c + my * jnp.int32(Cloc),), (Cloc,))
        new_full = jax.lax.all_gather(cur - contrib, "rows", axis=0,
                                      tiled=True)
        x = jax.lax.dynamic_update_slice(x, new_full, (c,))
        return (x, c + jnp.int32(op.chunk)), None

    (x, _), _ = jax.lax.scan(body, (x, jnp.int32(0)), (op.cols, op.vals))
    if op.sharded:
        return _gather_trim(x[op.out_slots], op.n)
    return x[op.out_slots]


def _trsv_op_kernel(op, b):
    if isinstance(op, HaloOp):
        return halo_op_kernel(op, b)
    return ag_op_kernel(op, b)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DistLevel:
    """Distributed operands of one level; `.spec()` mirrors the pytree with
    PartitionSpecs for shard_map.

    With ``vec_sharded`` (the default built by :meth:`DistPrec.from_host`)
    the per-level vectors ``p/q_inv/s_p/t/d`` are row-sharded (padded to the
    device count): each device stores and computes only its 1/D slice of
    the level's permute+scale work, and one tiled ``all_gather`` per use
    reassembles the working vector — persistent per-device state for these
    vectors drops from O(n) to O(n/D) per level (the 100M-row leg of
    BASELINE config 5; the working vectors themselves remain transient
    O(n) activations)."""

    p: jax.Array
    q_inv: jax.Array
    s_p: jax.Array
    t: jax.Array
    d: jax.Array
    L_op: Union[AGTrsvOp, HaloOp]
    U_op: Union[AGTrsvOp, HaloOp]
    E_idx: jax.Array       # row-sharded ELL of E (rows padded)
    E_val: jax.Array
    F_idx: jax.Array
    F_val: jax.Array
    m: int
    n: int
    E_rows: int            # padded row count of E
    F_rows: int
    vec_sharded: bool = False  # p/q_inv/s_p/t/d row-sharded (padded)
    # inter-level link: fetch THIS level's permuted+scaled input directly
    # from the PREVIOUS level's distributed E-SpMV output (ppermute packages
    # + compact AG instead of a full-vector all_gather; VERDICT r3 #6)
    xin: Optional[XPlan] = None

    _ARRAYS = ("p", "q_inv", "s_p", "t", "d", "L_op", "U_op",
               "E_idx", "E_val", "F_idx", "F_val", "xin")
    _AUX = ("m", "n", "E_rows", "F_rows", "vec_sharded")

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._ARRAYS),
                tuple(getattr(self, f) for f in self._AUX))

    @classmethod
    def tree_unflatten(cls, aux, children):
        kw = dict(zip(cls._ARRAYS, children))
        kw.update(zip(cls._AUX, aux))
        return cls(**kw)

    def spec(self) -> "DistLevel":
        sharded2 = P("rows", None)
        rep = P()
        vec = P("rows") if self.vec_sharded else rep
        vals = dict(p=vec, q_inv=vec, s_p=vec, t=vec, d=vec,
                    L_op=self.L_op.spec(), U_op=self.U_op.spec(),
                    E_idx=sharded2, E_val=sharded2,
                    F_idx=sharded2, F_val=sharded2,
                    xin=None if self.xin is None else self.xin.spec())
        return DistLevel(**vals,
                         **{f: getattr(self, f) for f in self._AUX})


def _dist_spmv(idx, val, x, out_rows):
    """Row-sharded ELL SpMV: local rows -> all_gather -> trim."""
    x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    y_local = (val * x_ext[idx]).sum(axis=1)
    y = jax.lax.all_gather(y_local, "rows", axis=0, tiled=True)
    return y[:out_rows]


def _dist_spmv_local(idx, val, x):
    """Row-sharded ELL SpMV without the output all_gather: each device
    returns only its own row block (consumed by an :class:`XPlan`)."""
    x_ext = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    return (val * x_ext[idx]).sum(axis=1)


def _gather_trim(loc: jax.Array, n: int) -> jax.Array:
    """Reassemble a row-sharded local block into the full (trimmed) vector."""
    return jax.lax.all_gather(loc, "rows", axis=0, tiled=True)[:n]


def _permute_scale(scale_loc, perm_loc, vec, n: int, vec_sharded: bool):
    """``scale * vec[perm]`` — with sharded level vectors each device gathers
    and scales only its slice, then one tiled all_gather reassembles."""
    if not vec_sharded:
        return scale_loc * vec[perm_loc]
    vec_ext = jnp.concatenate([vec, jnp.zeros((1,), dtype=vec.dtype)])
    return _gather_trim(scale_loc * vec_ext[perm_loc], n)


def _div_diag(x: jax.Array, d_loc: jax.Array, m: int, vec_sharded: bool):
    """``x / d`` for the (replicated) trsv output against a possibly
    row-sharded diagonal."""
    if not vec_sharded:
        return x / d_loc
    blk = d_loc.shape[0]
    my = jax.lax.axis_index("rows")
    idx = my * blk + jnp.arange(blk, dtype=jnp.int32)
    xs = jnp.where(idx < m, x[jnp.minimum(idx, m - 1)], jnp.zeros((), x.dtype))
    return _gather_trim(xs / d_loc, m)


def _dist_solve(levels: List[DistLevel], tail: Optional[DenseTail],
                b: jax.Array) -> jax.Array:
    wbs = []
    rhs = b          # replicated inter-level vector (legacy link)
    rhs_loc = None   # distributed alternative (E-output exchange link)
    for i, lvl in enumerate(levels):
        if lvl.xin is not None and rhs_loc is not None:
            # fetch exactly this device's permutation footprint from the
            # previous level's distributed E output, then one all_gather
            # replicates the (already scaled+permuted) working vector
            wb = _gather_trim(lvl.s_p * xplan_fetch(lvl.xin, rhs_loc),
                              lvl.n)
        else:
            wb = _permute_scale(lvl.s_p, lvl.p, rhs, lvl.n, lvl.vec_sharded)
        m = lvl.m
        x1 = _trsv_op_kernel(lvl.L_op, wb[:m])
        x1 = _div_diag(x1, lvl.d, m, lvl.vec_sharded)
        x1 = _trsv_op_kernel(lvl.U_op, x1)
        next_xin = levels[i + 1].xin if i + 1 < len(levels) else None
        if next_xin is not None:
            # keep the E output distributed; the next level fetches its
            # footprint via the exchange plan
            blk = next_xin.blk
            my = jax.lax.axis_index("rows")
            ridx = my * blk + jnp.arange(blk, dtype=jnp.int32)
            nm = lvl.n - m
            wb_rows = jnp.where(
                ridx < nm, wb[m + jnp.minimum(ridx, max(nm - 1, 0))],
                jnp.zeros((), wb.dtype))
            rhs_loc = wb_rows - _dist_spmv_local(lvl.E_idx, lvl.E_val, x1)
            rhs = None
        else:
            rhs = wb[m:] - _dist_spmv(lvl.E_idx, lvl.E_val, x1, lvl.n - m)
            rhs_loc = None
        wbs.append(wb)
    x_tail = tail_solve(tail, rhs)
    for lvl, wb in zip(reversed(levels), reversed(wbs)):
        m = lvl.m
        if lvl.n - m:
            z = wb[:m] - _dist_spmv(lvl.F_idx, lvl.F_val, x_tail, m)
        else:
            z = wb[:m]
        z = _trsv_op_kernel(lvl.L_op, z)
        z = _div_diag(z, lvl.d, m, lvl.vec_sharded)
        z = _trsv_op_kernel(lvl.U_op, z)
        sol = jnp.concatenate([z, x_tail])
        x_tail = _permute_scale(lvl.t, lvl.q_inv, sol, lvl.n, lvl.vec_sharded)
    return x_tail


class DistPrec:
    """Mesh-distributed multilevel preconditioner.

    ``comm_elems`` / ``allgather_elems`` aggregate the host-counted halo
    exchange volume over all halo-carried factors vs what the tiled
    all_gather scheme would have moved for the same factors (per solve,
    per trsv application).
    """

    def __init__(self, mesh: Mesh, levels: List[DistLevel],
                 tail: Optional[DenseTail], comm_elems: int = 0,
                 allgather_elems: int = 0, n_halo: int = 0):
        self.mesh = mesh
        self.levels = levels
        self.tail = tail
        self.comm_elems = comm_elems
        self.allgather_elems = allgather_elems
        self.n_halo = n_halo
        specs = [l.spec() for l in levels]
        tail_spec = None if tail is None else jax.tree_util.tree_map(
            lambda _: P(), tail)
        fn = jax.shard_map(_dist_solve, mesh=mesh,
                           in_specs=(specs, tail_spec, P()), out_specs=P(),
                           check_vma=False)
        self._jit = jax.jit(fn)

    @classmethod
    def from_host(cls, mesh: Mesh, M, dtype=None, chunk: int = 256,
                  halo: bool = True, shard_vectors: bool = True,
                  max_halo_chunks: int = 128) -> "DistPrec":
        """Build from a factorized host :class:`hifir_tpu.api.HIF`.

        ``halo=True`` carries every level's L/U solve with the compact
        per-chunk halo exchange (:mod:`.trsv_halo`); factors it cannot
        carry (single-device mesh, empty factor) fall back to the tiled
        all_gather op.  ``shard_vectors`` row-shards the per-level
        permutation/scaling/diagonal vectors too (O(n/D) instead of O(n)
        persistent state per device, at one extra tiled all_gather per
        use — see :class:`DistLevel`).

        ``max_halo_chunks`` bounds the *unrolled* halo chunk loop: the halo
        op carries chunk-exact ragged metadata, so its trace/compile cost
        and host plan-construction cost grow linearly with the chunk count
        (one chunk per padded dependency level; a 200k-row robust factor
        has thousands — measured 649 s host planning + minutes of XLA
        compile at n=262k, examples/distprec_scale.py).  Factors whose
        schedule exceeds the cap ride the scanned tiled-all_gather op
        instead, whose compile cost is independent of the chunk count.
        """
        dtype = jnp.float64 if dtype is None else dtype
        ndev = mesh.shape["rows"]
        auto_chunk = chunk == "auto"  # per-factor cost-model chunk choice
        C = max(256 if auto_chunk else chunk, ndev)
        C -= C % ndev
        sh3 = NamedSharding(mesh, P(None, "rows", None))
        sh2 = NamedSharding(mesh, P("rows", None))
        sh1 = NamedSharding(mesh, P("rows"))
        rep = NamedSharding(mesh, P())
        comm = ag_comm = n_halo = 0

        def put_vec(arr, pad_val, dt):
            """Pad to a multiple of the device count and row-shard (or
            replicate, with shard_vectors=False)."""
            a = np.asarray(arr)
            if not shard_vectors:
                return jax.device_put(jnp.asarray(a, dt), rep)
            padded = (-len(a)) % ndev
            if padded:
                a = np.concatenate(
                    [a, np.full(padded, pad_val, dtype=a.dtype)])
            return jax.device_put(jnp.asarray(a, dt), sh1)

        def make_op(T, lower):
            nonlocal comm, ag_comm, n_halo
            if halo:
                op = build_halo_op(mesh, T, lower=lower, chunk=C, dtype=dtype,
                                   max_chunks=max_halo_chunks)
                if op is not None:
                    comm += op.comm_elems
                    ag_comm += op.allgather_elems
                    n_halo += 1
                    return op
            s = build_trsv_schedule(T, lower=lower,
                                    chunk="auto" if auto_chunk else C,
                                    dtype=dtype, k_cap="auto",
                                    chunk_multiple=ndev)
            Cop = s.chunk
            if shard_vectors and s.nchunks:
                nslots = s.nchunks * Cop
                # pad the exit map to a device multiple; the sentinel slot
                # nslots reads the appended zero and is trimmed by [:n]
                out = np.asarray(s.out_slots)
                padded = (-len(out)) % ndev
                if padded:
                    out = np.concatenate(
                        [out, np.full(padded, nslots, dtype=out.dtype)])
                return AGTrsvOp(
                    in_rows=jax.device_put(s.in_rows, sh1),
                    cols=jax.device_put(s.cols, sh3),
                    vals=jax.device_put(s.vals, sh3),
                    out_slots=jax.device_put(jnp.asarray(out), sh1),
                    nchunks=s.nchunks, chunk=Cop, n=s.n, sharded=True)
            return AGTrsvOp(
                in_rows=jax.device_put(s.in_rows, rep),
                cols=jax.device_put(s.cols, sh3),
                vals=jax.device_put(s.vals, sh3),
                out_slots=jax.device_put(s.out_slots, rep),
                nchunks=s.nchunks, chunk=Cop, n=s.n)

        levels = []
        prev_E_rows = None
        for prec in M.precs:
            m, n = prec.m, prec.n
            Ee = ell_from_csr(pad_rows(prec.E, ndev), dtype=dtype)
            Fe = ell_from_csr(pad_rows(prec.F, ndev), dtype=dtype)
            # inter-level E-output exchange plan (levels >= 2): this level's
            # per-device permutation footprint, fetched from the previous
            # level's row-block-distributed E-SpMV output
            xin = None
            if (shard_vectors and ndev > 1 and prev_E_rows is not None
                    and prev_E_rows >= n):
                p_pad = np.asarray(prec.p)
                padded = (-len(p_pad)) % ndev
                if padded:
                    p_pad = np.concatenate(
                        [p_pad, np.full(padded, n, dtype=p_pad.dtype)])
                xin = build_exchange_plan(
                    mesh, n, prev_E_rows // ndev,
                    p_pad.reshape(ndev, -1))
                comm += xin.comm_elems
                ag_comm += xin.allgather_elems
            prev_E_rows = Ee.nrows
            levels.append(DistLevel(
                p=put_vec(prec.p, n, jnp.int32),
                q_inv=put_vec(prec.q_inv, n, jnp.int32),
                s_p=put_vec(prec.s[prec.p], 0.0, dtype),
                t=put_vec(prec.t, 0.0, dtype),
                d=put_vec(prec.d, 1.0, dtype),
                L_op=make_op(prec.L_B, True),
                U_op=make_op(prec.U_B, False),
                E_idx=jax.device_put(Ee.indices, sh2),
                E_val=jax.device_put(Ee.values, sh2),
                F_idx=jax.device_put(Fe.indices, sh2),
                F_val=jax.device_put(Fe.values, sh2),
                m=m, n=n, E_rows=Ee.nrows, F_rows=Fe.nrows,
                vec_sharded=shard_vectors, xin=xin))
        tail = pack_tail(M.precs[-1], dtype)
        return cls(mesh, levels, tail, comm, ag_comm, n_halo)

    def solve(self, b) -> jax.Array:
        """x = M^{-1} b; b and x replicated across the mesh."""
        return self._jit(self.levels, self.tail, jnp.asarray(b))

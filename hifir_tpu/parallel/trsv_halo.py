"""Distributed level-scheduled trsv with compact per-chunk halo exchange.

Replaces the per-chunk full-vector tiled ``all_gather`` of
:mod:`.trsv_sharded` (the BASELINE north-star item: "partitioned triangular
solve with halo exchange of vector segments via ppermute overlapped with
local compute"; the serial kernel it distributes is the reference
``solve_as_strict_lower``, ``/root/reference/src/hif/ds/CompressedStorage.hpp:2268``).

Layout
------
Chunks of the level schedule are split across the ``rows`` mesh axis exactly
as in :mod:`.trsv_sharded` (device k owns slot slice ``[c*C + k*Cloc,
c*C + (k+1)*Cloc)`` of every chunk c), but the solution now lives
*distributed*: device k keeps only its own slices — ``nchunks*Cloc``
entries — plus a halo region holding exactly the foreign slots its rows
actually read (host-counted at build time).

The chunk loop is **unrolled** (nchunks is static), so every chunk carries
its own exact metadata instead of a scan-wide maximum:

* the dependency gather is trimmed to that chunk's real max fan-in ``K_c``
  (levels near the bottom of the schedule have tiny fan-in);
* the exchange is split per chunk into up to three legs, each host-sized
  to the exact halo it must carry (zero-width legs are elided entirely —
  frequent for upper factors of banded orderings):

  - ring-neighbor deps ride two ``ppermute`` package sends (point-to-point;
    for RCM/banded factors this is nearly all of the halo);
  - the far remainder rides one ``all_gather`` of a *compact* package per
    device (only the slots some non-neighbor device reads, width =
    per-chunk max over producers) instead of the whole ``C - Cloc``
    remainder.

Packages are sent right after the producing chunk's local FMA completes;
consumers first touch them one chunk later at the earliest, so XLA's async
collectives overlap the exchange with the next chunk's independent gather/FMA
work.  ``comm_elems`` / ``allgather_elems`` record the host-counted exchange
volume of this scheme vs the tiled-all_gather scheme; tests assert the
reduction.

Entry/exit remain single collectives (gather b, reassemble x) — the
O(n)-per-device *working* state of the old scheme is what this removes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.trsv import build_trsv_schedule

__all__ = ["HaloOp", "build_halo_op", "halo_op_kernel", "halo_trsv_apply"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HaloOp:
    """Per-device placed halo-trsv operand (a pytree; shard_map-able).

    Array children carry a leading device axis sharded over ``rows``; the
    per-chunk tuples are ragged (chunk-exact widths/fan-ins), which is why
    the apply loop is unrolled rather than scanned.
    """

    in_rows: jax.Array          # (D, own_len) int32 rows feeding own slots
    out_slots: jax.Array        # (n,) int32 slot of each row (replicated)
    gcols: Tuple[jax.Array, ...]   # per chunk (D, Cloc, K_c) int32 LOCAL coords
    gvals: Tuple[jax.Array, ...]   # per chunk (D, Cloc, K_c)
    sends: Tuple[Tuple[jax.Array, ...], ...]  # per chunk: see ``meta``
    # -- static --
    meta: Tuple[tuple, ...]     # per chunk (off_l, Wl, off_r, Wr, off_ag,
    #   Wag): widths of the from-left / from-right ppermute packages and the
    #   compact all_gather block, with their halo-region offsets; ``sends``
    #   holds the corresponding (D, W) own-coordinate arrays for the
    #   nonzero widths, in that order
    nchunks: int
    Cloc: int
    own_len: int
    buf_len: int
    D: int
    n: int
    comm_elems: int             # host-counted exchanged elements (all devs)
    allgather_elems: int        # what the tiled all_gather scheme would move

    def tree_flatten(self):
        return ((self.in_rows, self.out_slots, self.gcols, self.gvals,
                 self.sends),
                (self.meta, self.nchunks, self.Cloc, self.own_len,
                 self.buf_len, self.D, self.n, self.comm_elems,
                 self.allgather_elems))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def spec(self) -> "HaloOp":
        """Mirror pytree with PartitionSpecs (for shard_map in_specs)."""
        return HaloOp(
            in_rows=P("rows", None), out_slots=P(),
            gcols=tuple(P("rows", None, None) for _ in self.gcols),
            gvals=tuple(P("rows", None, None) for _ in self.gvals),
            sends=tuple(tuple(P("rows", None) for _ in s)
                        for s in self.sends),
            meta=self.meta, nchunks=self.nchunks, Cloc=self.Cloc,
            own_len=self.own_len, buf_len=self.buf_len, D=self.D, n=self.n,
            comm_elems=self.comm_elems,
            allgather_elems=self.allgather_elems)


def build_halo_op(mesh: Mesh, T, lower: bool, chunk: int = 256,
                  dtype=None, max_chunks: Optional[int] = None
                  ) -> Optional[HaloOp]:
    """Build the per-chunk halo schedule for ``(I + strict(T))^{-1}``.

    Returns ``None`` when the factor is empty, the mesh has one device, or
    the schedule has more than ``max_chunks`` chunks (the apply unrolls the
    chunk loop, so host planning and XLA compile scale linearly with the
    chunk count — callers fall back to the scanned all_gather op).
    """
    D = mesh.shape["rows"]
    C = max(chunk, D)
    C -= C % D
    sched = build_trsv_schedule(T, lower=lower, chunk=C, dtype=dtype)
    nchunks = sched.nchunks
    if nchunks == 0 or D == 1:
        return None
    if max_chunks is not None and nchunks > max_chunks:
        return None
    Cloc = C // D
    nslots = nchunks * C
    n = sched.n

    cols = np.asarray(sched.cols)          # (nchunks, C, K) global slot ids
    vals = np.asarray(sched.vals)
    K = cols.shape[2]
    own_len = nchunks * Cloc

    # ownership / local own coordinate of every global slot
    slot = np.arange(nslots, dtype=np.int64)
    owner = (slot % C) // Cloc
    own_coord = (slot // C) * Cloc + (slot % C) - owner * Cloc

    # (D, nchunks, Cloc, K) device-major dependency view
    dep = cols.reshape(nchunks, D, Cloc, K).transpose(1, 0, 2, 3)
    dvals = vals.reshape(nchunks, D, Cloc, K).transpose(1, 0, 2, 3)
    pad = dep >= nslots  # sentinel
    dep_owner = np.where(pad, -1, owner[np.minimum(dep, nslots - 1)])
    me = np.arange(D)[:, None, None, None]
    foreign = (~pad) & (dep_owner != me)

    # need[k][c]: sorted unique foreign slots device k reads that chunk c
    # produced (the exchange for chunk c happens right after c's FMA)
    need = []
    for k in range(D):
        f = np.unique(dep[k][foreign[k]])     # ascending unique slots
        cut = np.searchsorted(f // C, np.arange(nchunks + 1))
        need.append([f[cut[c]:cut[c + 1]] for c in range(nchunks)])

    # transport choice + halo offset assignment per chunk: ring-1 neighbor
    # deps ride point-to-point ppermute packages; only the far remainder
    # rides a compact all_gather (union of what anyone far reads)
    meta = []
    halo_off = own_len
    comm = 0
    send_plans = []               # per chunk: tuple of (D, W) send coords
    # loc_extra[k]: dict slot -> local halo coordinate on device k
    loc_extra = [dict() for _ in range(D)]
    for c in range(nchunks):
        nd = [need[k][c] for k in range(D)]
        if all(len(s) == 0 for s in nd):
            meta.append((0, 0, 0, 0, 0, 0))
            send_plans.append(())
            continue
        ow = [owner[s] if len(s) else np.empty(0, np.int64) for s in nd]
        fl = [nd[k][ow[k] == k - 1] for k in range(D)]   # from left neighbor
        fr = [nd[k][ow[k] == k + 1] for k in range(D)]   # from right neighbor
        far = [nd[k][(ow[k] != k - 1) & (ow[k] != k + 1)] for k in range(D)]
        Wl = max(len(s) for s in fl)
        Wr = max(len(s) for s in fr)
        union = [np.unique(np.concatenate(
            [far[k][owner[far[k]] == o] for k in range(D)]))
            for o in range(D)]
        Wag = max(len(u) for u in union)
        # a pure compact all_gather (ring-1 deps folded into the union) can
        # move fewer elements than the ppermute+all_gather mix when the far
        # part dominates: pick the cheaper plan by host count
        union_all = [np.unique(np.concatenate(
            [nd[k][ow[k] == o] for k in range(D)])) for o in range(D)]
        Wag_all = max(len(u) for u in union_all)
        if D * Wag_all < Wl + Wr + D * Wag:
            fl = [s[:0] for s in fl]
            fr = [s[:0] for s in fr]
            far, union = nd, union_all
            Wl = Wr = 0
            Wag = Wag_all
        off_l = halo_off
        off_r = off_l + Wl
        off_ag = off_r + Wr
        halo_off = off_ag + D * Wag
        meta.append((off_l, Wl, off_r, Wr, off_ag, Wag))
        plan = []
        if Wl:
            # device j sends rightward what j+1 needs from j; consumer k
            # maps its from-left set by rank
            send_r = np.full((D, Wl), -1, dtype=np.int64)
            for k in range(D):
                if k + 1 < D and len(fl[k + 1]):
                    send_r[k, :len(fl[k + 1])] = own_coord[fl[k + 1]]
                for r, s in enumerate(fl[k]):
                    loc_extra[k][s] = off_l + r
            plan.append(send_r)
            comm += (D - 1) * Wl
        if Wr:
            send_l = np.full((D, Wr), -1, dtype=np.int64)
            for k in range(D):
                if k - 1 >= 0 and len(fr[k - 1]):
                    send_l[k, :len(fr[k - 1])] = own_coord[fr[k - 1]]
                for r, s in enumerate(fr[k]):
                    loc_extra[k][s] = off_r + r
            plan.append(send_l)
            comm += (D - 1) * Wr
        if Wag:
            send = np.full((D, Wag), -1, dtype=np.int64)
            for o in range(D):
                if len(union[o]):
                    send[o, :len(union[o])] = own_coord[union[o]]
                rank = {s: r for r, s in enumerate(union[o])}
                for k in range(D):
                    for s in far[k][owner[far[k]] == o]:
                        loc_extra[k][s] = off_ag + o * Wag + rank[s]
            plan.append(send)
            comm += D * (D - 1) * Wag
        send_plans.append(tuple(plan))

    buf_len = halo_off + 1
    LPAD = buf_len - 1

    # per-device local coordinate of every dependency
    loc = np.full((D, nslots + 1), LPAD, dtype=np.int64)
    for k in range(D):
        mine = owner == k
        loc[k, :nslots][mine] = own_coord[mine]
        if loc_extra[k]:
            ks = np.fromiter(loc_extra[k].keys(), dtype=np.int64)
            vs = np.fromiter(loc_extra[k].values(), dtype=np.int64)
            loc[k, ks] = vs

    sh2 = NamedSharding(mesh, P("rows", None))
    sh3 = NamedSharding(mesh, P("rows", None, None))
    rep = NamedSharding(mesh, P())

    gcols, gvals, sends = [], [], []
    for c in range(nchunks):
        # trim to the chunk's real fan-in
        Kc = max(int((~pad[:, c]).sum(axis=2).max()), 1)
        dk = np.where(pad[:, c, :, :Kc], nslots, dep[:, c, :, :Kc])
        lc = np.take_along_axis(loc, dk.reshape(D, -1), axis=1) \
            .reshape(D, Cloc, Kc)
        gcols.append(jax.device_put(jnp.asarray(lc.astype(np.int32)), sh3))
        gvals.append(jax.device_put(jnp.asarray(dvals[:, c, :, :Kc]), sh3))
        sends.append(tuple(
            jax.device_put(jnp.asarray(
                np.where(s < 0, LPAD, s).astype(np.int32)), sh2)
            for s in send_plans[c]))

    in_rows = np.asarray(sched.in_rows).reshape(nchunks, D, Cloc) \
        .transpose(1, 0, 2).reshape(D, own_len)

    return HaloOp(
        in_rows=jax.device_put(jnp.asarray(in_rows.astype(np.int32)), sh2),
        out_slots=jax.device_put(sched.out_slots, rep),
        gcols=tuple(gcols), gvals=tuple(gvals), sends=tuple(sends),
        meta=tuple(meta), nchunks=nchunks, Cloc=Cloc, own_len=own_len,
        buf_len=buf_len, D=D, n=n, comm_elems=comm,
        allgather_elems=nchunks * D * (C - Cloc))


def halo_op_kernel(op: HaloOp, b: jax.Array) -> jax.Array:
    """shard_map-internal apply: solve (I + strict(T)) x = b.

    ``b`` replicated; the working vector distributed (own slices + halo);
    the result replicated (single exit all_gather).
    """
    D, Cloc = op.D, op.Cloc
    right = [(d, d + 1) for d in range(D - 1)]
    left = [(d, d - 1) for d in range(1, D)]
    in_rows = op.in_rows[0]

    b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
    x = jnp.zeros((op.buf_len,), dtype=b.dtype)
    x = jax.lax.dynamic_update_slice(x, b_ext[in_rows], (0,))

    off = 0
    for c in range(op.nchunks):
        cc, vv = op.gcols[c][0], op.gvals[c][0]
        contrib = (vv * x[cc]).sum(axis=1)
        cur = jax.lax.dynamic_slice(x, (off,), (Cloc,))
        x = jax.lax.dynamic_update_slice(x, cur - contrib, (off,))
        off_l, Wl, off_r, Wr, off_ag, Wag = op.meta[c]
        plan = iter(op.sends[c])
        if Wl:
            recv = jax.lax.ppermute(x[next(plan)[0]], "rows", right)
            x = jax.lax.dynamic_update_slice(x, recv, (off_l,))
        if Wr:
            recv = jax.lax.ppermute(x[next(plan)[0]], "rows", left)
            x = jax.lax.dynamic_update_slice(x, recv, (off_r,))
        if Wag:
            pkg = x[next(plan)[0]]
            allp = jax.lax.all_gather(pkg, "rows", axis=0, tiled=True)
            x = jax.lax.dynamic_update_slice(x, allp, (off_ag,))
        off += Cloc

    own = x[:op.own_len].reshape(op.nchunks, Cloc)
    full = jax.lax.all_gather(own, "rows", axis=1, tiled=True)  # (nchunks, C)
    return full.reshape(-1)[op.out_slots]


def halo_trsv_apply(op: HaloOp, b: jax.Array) -> jax.Array:
    """Standalone jitted apply of one halo-trsv operator over its mesh."""
    mesh = op.in_rows.sharding.mesh
    fn = jax.shard_map(halo_op_kernel, mesh=mesh,
                       in_specs=(op.spec(), P()), out_specs=P(),
                       check_vma=False)
    return jax.jit(fn)(op, jnp.asarray(b))

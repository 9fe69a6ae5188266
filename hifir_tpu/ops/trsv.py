"""Level-scheduled sparse triangular solve on the accelerator.

This is the make-or-break kernel of the M-solve path (SURVEY.md §7.3.3),
replacing the inherently sequential reference trsv
(``/root/reference/src/hif/ds/CompressedStorage.hpp:1358,1451``) with a
static-shape formulation that XLA compiles for the accelerator:

1. **Host schedule** (built once at factorize time): compute the dependency
   levels of the triangular factor; rows within a level are independent.
2. **Chunk alignment**: rows are laid out level-by-level into fixed-size
   chunks of C rows; each level is padded up to a chunk boundary, so a chunk
   never contains intra-chunk dependencies.  Total padding is bounded by
   (#levels * C).
3. **Slot-ordered storage, scatter-free**: the solution vector is kept in
   *slot order* (the schedule order); dependency column ids are remapped to
   slot ids on host.  Each scan step is then gather + FMA +
   ``dynamic_update_slice`` of a contiguous chunk — no scatter at all, so
   no step pays for scatters with (possibly duplicate) dynamic indices.
   Entry/exit are single gathers between row and slot order.

The same machinery solves the strict upper factor by scheduling on reversed
dependencies.  Multiple RHS vectorize with ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TrsvSchedule", "TrsvDense", "TrsvBlockDense",
           "build_trsv_schedule", "build_trsv_dense",
           "build_trsv_block_dense", "trsv_apply", "trsv_apply_mrhs"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TrsvSchedule:
    """Chunked level schedule of a unit-diagonal triangular factor."""

    in_rows: jax.Array   # (nslots,) int32: row feeding each slot (pad -> n)
    cols: jax.Array      # (nchunks, C, K) int32 slot ids of deps (pad -> nslots)
    vals: jax.Array      # (nchunks, C, K)
    out_slots: jax.Array  # (n,) int32: slot holding each row's solution
    n: int               # static
    nchunks: int         # static
    chunk: int           # static
    nlevels: int         # static

    def tree_flatten(self):
        return ((self.in_rows, self.cols, self.vals, self.out_slots),
                (self.n, self.nchunks, self.chunk, self.nlevels))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TrsvDense:
    """Explicit dense inverse of a unit-diagonal triangular factor.

    For small deep factors the level-scheduled scan is latency-bound: each
    dependency level is a serialized gather->update chain (one scan step,
    see ``_STEP_ELEMS``), so a 1.9k-row factor with 105 levels costs >100
    step latencies.  The apply here is ONE dense matmul:
    x = (I + strict(T))^{-1} b materialized once at pack time.  This is numerically safe for HIF factors
    specifically because the inverse-based kappa condition control bounds
    ||(I+T)^{-1}|| <= kappa (3..5) BY CONSTRUCTION (ref Crout.hpp:486,
    thresholds.hpp:49) — the explicit inverse cannot blow up."""

    inv: jax.Array   # (n, n)
    n: int

    def tree_flatten(self):
        return ((self.inv,), (self.n,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TrsvBlockDense:
    """Blocked explicit-inverse triangular apply for mid-size factors.

    Rows in natural order are already dependency-safe for a lower factor
    (upper: reverse block order), so no level schedule is needed: the factor
    splits into B row blocks of width W; each block's diagonal triangle is
    inverted densely (dense matmul apply — safe for HIF factors, see
    :class:`TrsvDense`) and its off-diagonal part stays sparse (sliced
    ELL gathered from the already-computed prefix).  The apply is B
    (SpMV + matmul + dynamic_update_slice) steps — e.g. 7 for a 14k-row
    factor that the level schedule covered with 234 chunks."""

    invs: Tuple[jax.Array, ...]   # per block (W, W) inverse (padded)
    offs: tuple                   # per block SlicedELL (W x n_pad)
    starts: Tuple[int, ...]       # row start of each block, PROCESS order
    n: int                        # true size
    W: int                        # block width (last block padded)

    def tree_flatten(self):
        return ((self.invs, self.offs), (self.starts, self.n, self.W))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)


def build_trsv_block_dense(T, lower: bool, W: int = 2048,
                           dtype=None) -> TrsvBlockDense:
    """Build the blocked explicit-inverse apply for ``(I + strict(T))``."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    from ..ds.csr import CSR
    from .spmv import sliced_ell_from_csr

    n = T.nrows
    zdt = np.dtype(T.data.dtype if dtype is None else dtype)
    S = T.to_scipy().tocsr()
    S = (sp.tril(S, -1) if lower else sp.triu(S, 1)).tocsr()
    nblk = max(1, -(-n // W))
    npad = nblk * W
    order = range(nblk) if lower else range(nblk - 1, -1, -1)
    invs, offs, starts = [], [], []
    eyeW = np.eye(W)
    for b in order:
        lo, hi = b * W, min((b + 1) * W, n)
        w = hi - lo
        blk = S[lo:hi, lo:hi].toarray()
        Mb = np.eye(w) + (np.tril(blk, -1) if lower else np.triu(blk, 1))
        inv = sla.solve_triangular(Mb, np.eye(w, dtype=Mb.dtype),
                                   lower=lower, unit_diagonal=True)
        if w < W:  # pad to W with identity (padded x entries stay zero)
            invp = eyeW.astype(inv.dtype).copy()
            invp[:w, :w] = inv
            inv = invp
        # off-diagonal part: cols outside the block, already computed when
        # this block runs (prefix for lower, suffix for upper)
        off = (S[lo:hi, :lo] if lower else S[lo:hi, hi:]).tocsr()
        # re-home into a (W, npad) operator gathering from the full vector
        offp = sp.csr_matrix((off.data, off.indices + (0 if lower else hi),
                              np.concatenate([off.indptr,
                                              [off.indptr[-1]] * (W - w)])),
                             shape=(W, npad))
        offs.append(sliced_ell_from_csr(CSR.from_scipy(offp), dtype=zdt))
        invs.append(jnp.asarray(inv.astype(zdt)))
        starts.append(lo)
    return TrsvBlockDense(tuple(invs), tuple(offs), tuple(starts), n, W)


def _block_dense_apply(bd: TrsvBlockDense, b: jax.Array) -> jax.Array:
    from .spmv import ell_matvec, ell_matvec_mrhs

    mrhs = b.ndim == 2
    pad = bd.W * len(bd.starts) - bd.n
    if pad:
        zshape = (pad, b.shape[1]) if mrhs else (pad,)
        x = jnp.concatenate([b, jnp.zeros(zshape, dtype=b.dtype)])
    else:
        x = b
    mv = ell_matvec_mrhs if mrhs else ell_matvec
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    for inv, off, lo in zip(bd.invs, bd.offs, bd.starts):
        if mrhs:
            seg = jax.lax.dynamic_slice(x, (lo, 0), (bd.W, x.shape[1]))
        else:
            seg = jax.lax.dynamic_slice(x, (lo,), (bd.W,))
        seg = seg - mv(off, x)
        seg = mm(inv, seg)
        x = jax.lax.dynamic_update_slice(x, seg, (lo, 0) if mrhs else (lo,))
    return x[:bd.n]


def build_trsv_dense(T, lower: bool, dtype=None) -> TrsvDense:
    """Materialize (I + strict(T))^{-1} on host (LAPACK trtri-grade cost,
    n^3/3 flops — gate callers on n)."""
    import scipy.linalg as sla

    n = T.nrows
    zdt = T.data.dtype if dtype is None else dtype
    if n == 0:
        return TrsvDense(jnp.zeros((0, 0), zdt), 0)
    M = T.to_scipy().toarray().astype(np.complex128 if np.iscomplexobj(T.data)
                                      else np.float64)
    M = (np.tril(M, -1) if lower else np.triu(M, 1)) + np.eye(n)
    inv = sla.solve_triangular(M, np.eye(n, dtype=M.dtype), lower=lower,
                               unit_diagonal=True)
    return TrsvDense(jnp.asarray(inv.astype(zdt)), n)


def _compute_levels(n, indptr, indices, lower: bool) -> np.ndarray:
    from ..pre import _native

    lev = _native.trsv_levels(n, indptr, indices, lower)
    if lev is not None:
        return lev
    lev = np.zeros(n, dtype=np.int64)
    rng = range(n) if lower else range(n - 1, -1, -1)
    for i in rng:
        mx = -1
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            dep = j < i if lower else j > i
            if dep and lev[j] > mx:
                mx = lev[j]
        lev[i] = mx + 1
    return lev


def _segment_gather(starts, lens):
    """Flat positions of concatenated segments [starts_i, starts_i + lens_i)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    seg_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.repeat(starts, lens)
            + np.arange(total, dtype=np.int64) - np.repeat(seg_off, lens))


def _cumsum0(a):
    return np.concatenate([[0], np.cumsum(a)])


# Cost of one scan step in gathered-element units: step latency over the
# marginal cost per gathered element.  Measured on an NVIDIA H100 80GB HBM3
# at a 700 W power limit (chip_smoke.scan_step_costs, f64): 6.7-7.2 us per
# step, 0.12-0.15 ns per element at 65,536 elements per step (the widest
# chunk * K the cost model picks) -> 45k-59k.
_STEP_ELEMS = 50_000


def _packed_slot_count(dcount, lev, chunk, cap):
    """Total padded slots of the schedule if rows wider than ``cap`` split.

    Mirrors the packer below without building arrays: partial nodes land at
    (level, stage) of their owner, combines one stage later, recursively;
    each occupied (level, stage) bucket pads to a chunk boundary — exactly
    the effective-level compaction the real schedule performs.
    """
    L = int(lev.max()) + 1 if lev.size else 1
    d = dcount.astype(np.int64)
    stage_counts = [np.bincount(lev[d <= cap], minlength=L).astype(np.int64)]
    wl, wd = lev[d > cap], d[d > cap]
    s = 0
    while wl.size:
        if len(stage_counts) <= s + 1:
            stage_counts.append(np.zeros(L, np.int64))
        g = -(-wd // cap)
        stage_counts[s] += np.bincount(
            wl, weights=g, minlength=L).astype(np.int64)
        done = g <= cap
        stage_counts[s + 1] += np.bincount(wl[done], minlength=L)
        wl, wd = wl[~done], g[~done]
        s += 1
    total = 0
    for arr in stage_counts:
        nz = arr[arr > 0]
        total += int((-(-nz // chunk) * chunk).sum())
    return total


def _schedule_cost(slots, K, chunk):
    """Memory + step cost of a (slots, K) schedule, in element units.

    Memory and gather work both scale with slots*K; each scan step
    additionally pays a latency floor, charged at _STEP_ELEMS element
    equivalents per chunk so that splitting never wins on tiny factors where
    extra steps dominate any memory saving.
    """
    nchunks = slots // chunk
    return slots * K + nchunks * max(_STEP_ELEMS, chunk * K)


def _choose_k_cap(dcount, lev, chunk):
    """Pick the deps-per-slot cap minimizing the schedule cost model.

    The dense (nslots, K) layout pays K = max row degree on EVERY slot; one
    wide row inflates the whole schedule (measured 25x factor memory at 262k
    rows).  Splitting rows wider than ``cap`` into partial-sum slots trades
    K for extra slots and scan steps.  Evaluate the actual packed slot count
    (padding and extra stage levels included) for a power-of-two cap grid
    and keep the cheapest; return ``None`` (unsplit) unless packing beats
    the unsplit cost by >=30% — the margin keeps heavy-tail regimes packing
    (that IS the target case) while narrow factors stay one-slot-per-row.
    """
    cap, _ = _best_cap_and_cost(dcount, lev, chunk)
    return cap


def _best_cap_and_cost(dcount, lev, chunk):
    kmax = int(dcount.max()) if dcount.size else 0
    if kmax <= 4:
        K = max(kmax, 1)
        return None, _schedule_cost(
            _packed_slot_count(dcount, lev, chunk, max(K, 1)), K, chunk)
    base = _schedule_cost(_packed_slot_count(dcount, lev, chunk, kmax),
                          kmax, chunk)
    caps = []
    cap = 4
    while cap < kmax:
        caps.append(cap)
        cap *= 2
    best_cap, best_cost = None, base
    for cap in reversed(caps):  # descending: ties keep the larger cap
        cost = _schedule_cost(_packed_slot_count(dcount, lev, chunk, cap),
                              cap, chunk)
        if cost < best_cost:
            best_cap, best_cost = cap, cost
    if best_cap is not None and best_cost > 0.7 * base:
        return None, base
    return best_cap, best_cost


def _choose_chunk(dcount, lev, multiple: int, upper: int):
    """Joint (chunk, k_cap) choice minimizing the schedule cost model.

    Deep factors have thousands of tiny dependency levels: a big chunk pays
    a full chunk of padding per level (the dominant schedule-memory term at
    scale), while a small chunk multiplies scan steps on shallow fat
    factors.  Scan a power-of-two chunk grid (each a multiple of
    ``multiple``, capped at ``upper``) with the best cap per chunk and keep
    the cheapest pair.
    """
    c = multiple
    while c < 8:
        c *= 2
    best = (c, None, float("inf"))
    while c <= max(upper, multiple):
        cap, cost = _best_cap_and_cost(dcount, lev, c)
        if cost < best[2]:
            best = (c, cap, cost)
        c *= 2
    return best[0], best[1]


def build_trsv_schedule(T, lower: bool, chunk: int = 256, dtype=None,
                        k_cap=None, chunk_multiple: int = 1) -> TrsvSchedule:
    """Build the device schedule for ``(I + strict(T))^{-1}``.

    ``T`` is a host CSR whose strict lower (or upper) triangle is the factor.

    ``k_cap`` packs the schedule: rows with more than ``k_cap`` dependencies
    are split into partial-sum slots (init 0, accumulating ``-sum(v*x)``)
    scheduled in earlier sub-stages of the same dependency level; the row's
    own slot then combines the partials with coefficient -1.  This bounds the
    padded inner dimension K at ``k_cap`` instead of the max row degree, so
    one dense row no longer inflates every slot.  ``k_cap="auto"`` picks the
    memory-minimizing cap; ``None`` keeps the unsplit layout.  The scan
    kernels are unchanged — packing is purely a host-side schedule transform.
    """
    n = T.nrows
    indptr, indices, data = T.indptr, T.indices, T.data
    zdt = data.dtype if dtype is None else dtype
    if n == 0:
        c0 = 256 if chunk == "auto" else chunk
        return TrsvSchedule(jnp.zeros((0,), jnp.int32),
                            jnp.zeros((0, c0, 1), jnp.int32),
                            jnp.zeros((0, c0, 1), zdt),
                            jnp.zeros((0,), jnp.int32), 0, 0, c0, 0)

    # strict dependency entries (vectorized); the pool is row-grouped so a
    # node's dependency list is one contiguous (start, len) slice of it
    rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = (indices < rows_of) if lower else (indices > rows_of)
    dep_rows = rows_of[keep]
    pool_ids = indices[keep].astype(np.int64)   # node ids (rows are nodes)
    pool_vals = dep_vals = data[keep].astype(zdt, copy=False)
    dcount = np.bincount(dep_rows, minlength=n)
    dstart = _cumsum0(dcount)

    lev = _compute_levels(n, indptr, indices, lower)

    if chunk == "auto":
        # per-factor chunk: pick (chunk, cap) jointly from the cost model
        # (chunk respects ``chunk_multiple``, e.g. the mesh device count)
        chunk, auto_cap = _choose_chunk(dcount, lev, max(chunk_multiple, 1),
                                        upper=1024)
        if k_cap == "auto":
            k_cap = auto_cap
    elif k_cap == "auto":
        k_cap = _choose_k_cap(dcount, lev, chunk)

    # ---- node table: rows first, then partial-sum nodes from splitting ----
    node_start = dstart[:-1].copy()
    node_len = dcount.astype(np.int64).copy()
    node_row = np.arange(n, dtype=np.int64)      # owner row (init b[row])
    node_init = np.arange(n, dtype=np.int64)     # in_rows value (n = init 0)
    node_stage = np.zeros(n, dtype=np.int64)
    if k_cap is not None and node_len.size and int(node_len.max()) > k_cap:
        cap = int(k_cap)
        pool_parts = [pool_ids]
        val_parts = [pool_vals]
        pool_off = pool_ids.size
        starts = [node_start]
        lens = [node_len]
        rows = [node_row]
        inits = [node_init]
        stages = [node_stage]
        nnodes = n
        # wide nodes this layer: split each into ceil(len/cap) partial nodes
        # over contiguous slices of its current dep list; the node itself is
        # rewritten to combine the partials (val -1) one stage later
        wide = np.flatnonzero(node_len > cap)
        w_start, w_len = node_start[wide], node_len[wide]
        w_row = node_row[wide]
        layer = 0
        while wide.size:
            g = -(-w_len // cap)
            npart = int(g.sum())
            p_owner = np.repeat(np.arange(wide.size), g)
            p_idx = (np.arange(npart, dtype=np.int64)
                     - np.repeat(_cumsum0(g)[:-1], g))
            starts.append(w_start[p_owner] + p_idx * cap)
            lens.append(np.minimum(cap, w_len[p_owner] - p_idx * cap))
            rows.append(w_row[p_owner])
            inits.append(np.full(npart, n, dtype=np.int64))   # init 0
            stages.append(np.full(npart, layer, dtype=np.int64))
            p_node = nnodes + np.arange(npart, dtype=np.int64)
            nnodes += npart
            # rewrite the wide nodes: deps = their partials, coefficient -1
            pool_parts.append(p_node)
            val_parts.append(np.full(npart, -1, dtype=zdt))
            node_start_new = pool_off + _cumsum0(g)[:-1]
            pool_off += npart
            if layer == 0:
                node_start[wide] = node_start_new
                node_len[wide] = g
                node_stage[wide] = 1
                combine_ids = wide
            else:
                starts[0][combine_ids] = node_start_new
                lens[0][combine_ids] = g
                stages[0][combine_ids] = layer + 1
            # recurse if a combine still has > cap partials
            deep = g > cap
            combine_ids = combine_ids[deep]
            w_start = node_start_new[deep]
            w_len = g[deep]
            w_row = w_row[deep] if layer == 0 else rows[0][combine_ids]
            wide = combine_ids
            layer += 1
        pool_ids = np.concatenate(pool_parts)
        pool_vals = np.concatenate(val_parts)
        node_start = np.concatenate(starts)
        node_len = np.concatenate(lens)
        node_row = np.concatenate(rows)
        node_init = np.concatenate(inits)
        node_stage = np.concatenate(stages)

    nnodes = node_row.size
    # schedule key: (level of owner row, stage); compact to effective levels
    max_stage = int(node_stage.max()) + 1 if nnodes else 1
    key = lev[node_row] * max_stage + node_stage
    eff = np.unique(key)
    nlev = eff.size
    nlev_map = np.searchsorted(eff, key)

    # nodes sorted by effective level; pad each level to a chunk boundary
    node_order = np.argsort(nlev_map, kind="stable")
    lev_sizes = np.bincount(nlev_map, minlength=nlev)
    padded_sizes = -(-lev_sizes // chunk) * chunk
    total_slots = int(padded_sizes.sum())
    all_init = np.full(total_slots, n, dtype=np.int64)
    out_start = _cumsum0(padded_sizes)[:-1]
    pos_in_level = (np.arange(nnodes, dtype=np.int64)
                    - _cumsum0(lev_sizes)[:-1][nlev_map[node_order]])
    slot_of = np.empty(nnodes, dtype=np.int64)
    slots = out_start[nlev_map[node_order]] + pos_in_level
    all_init[slots] = node_init[node_order]
    slot_of[node_order] = slots

    nchunks = total_slots // chunk
    K = max(int(node_len.max()) if nnodes else 0, 1)
    cols2d = np.full((total_slots, K), total_slots, dtype=np.int32)
    vals2d = np.zeros((total_slots, K), dtype=zdt)

    lens_s = node_len[node_order]
    flat = _segment_gather(node_start[node_order], lens_s)
    out_slot = np.repeat(slots, lens_s)
    out_off = (np.arange(flat.size, dtype=np.int64)
               - np.repeat(_cumsum0(lens_s)[:-1], lens_s))
    cols2d[out_slot, out_off] = slot_of[pool_ids[flat]]
    vals2d[out_slot, out_off] = pool_vals[flat]

    # row -> slot holding its final value (partials are internal only)
    out_slots = slot_of[:n]

    return TrsvSchedule(jnp.asarray(all_init.astype(np.int32)),
                        jnp.asarray(cols2d.reshape(nchunks, chunk, K)),
                        jnp.asarray(vals2d.reshape(nchunks, chunk, K)),
                        jnp.asarray(out_slots.astype(np.int32)),
                        n, nchunks, chunk, nlev)


def trsv_apply(sched, b: jax.Array) -> jax.Array:
    """Solve (I + strict(T)) x = b on device via the chunked level scan
    (or one dense matmul for :class:`TrsvDense` factors)."""
    if isinstance(sched, TrsvDense):
        return jnp.matmul(sched.inv, b,
                          precision=jax.lax.Precision.HIGHEST)
    if isinstance(sched, TrsvBlockDense):
        return _block_dense_apply(sched, b)
    if sched.nchunks == 0:
        return b
    C = sched.chunk
    b_ext = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
    x = b_ext[sched.in_rows]                       # slot order, pads read 0
    x = jnp.concatenate([x, jnp.zeros((1,), dtype=b.dtype)])  # sentinel slot

    def body(carry, inputs):
        x, c = carry
        cols, vals = inputs
        g = x[cols]                                # (C, K)
        contrib = (vals * g).sum(axis=1)
        cur = jax.lax.dynamic_slice(x, (c,), (C,))
        x = jax.lax.dynamic_update_slice(x, cur - contrib, (c,))
        return (x, c + C), None

    (x, _), _ = jax.lax.scan(body, (x, 0), (sched.cols, sched.vals))
    return x[sched.out_slots]


def trsv_apply_mrhs(sched, B: jax.Array) -> jax.Array:
    """Solve with multiple RHS, B of shape (n, nrhs)."""
    if isinstance(sched, TrsvDense):
        return jnp.matmul(sched.inv, B,
                          precision=jax.lax.Precision.HIGHEST)
    if isinstance(sched, TrsvBlockDense):
        return _block_dense_apply(sched, B)
    if sched.nchunks == 0:
        return B
    C = sched.chunk
    nrhs = B.shape[1]
    B_ext = jnp.concatenate([B, jnp.zeros((1, nrhs), dtype=B.dtype)])
    x = B_ext[sched.in_rows]
    x = jnp.concatenate([x, jnp.zeros((1, nrhs), dtype=B.dtype)])

    def body(carry, inputs):
        x, c = carry
        cols, vals = inputs
        g = x[cols]                                # (C, K, nrhs)
        contrib = jnp.einsum("ck,ckj->cj", vals, g,
                             precision=jax.lax.Precision.HIGHEST)
        cur = jax.lax.dynamic_slice(x, (c, 0), (C, nrhs))
        x = jax.lax.dynamic_update_slice(x, cur - contrib, (c, 0))
        return (x, c + C), None

    (x, _), _ = jax.lax.scan(body, (x, 0), (sched.cols, sched.vals))
    return x[sched.out_slots]

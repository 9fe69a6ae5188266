"""On-card smoke check of the HIF main path on one NVIDIA GPU.

Drives what a user runs — host factorize (native C++), ``HIF.to_device``,
the jitted device apply and the device GMRES — on BASELINE config 2: the
1M-row 2-D Poisson system ``poisson2d(1024)`` with the robust default
``Options()``.  Every device kernel of that path is compared with the plain
host reference (``ds/csr.py``, ``alg/prec_solve_np.py``) at its real width.

    python chip_smoke.py               # one GPU, phases 1-9
    python chip_smoke.py --four        # only the distributed apply, 4 GPUs
    python chip_smoke.py --trace DIR   # also profile one scan-level apply

Prints one line per phase (wall time and compile time apart) and, as the
last line, ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero without that line; so does a machine where JAX
finds no GPU (there is no CPU fallback).  One process drives the card(s);
the ``nvidia-smi`` and ``make`` children never touch JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hifir_tpu.alg.prec import DevicePrec, tail_solve  # noqa: E402
from hifir_tpu.api import HIF  # noqa: E402
from hifir_tpu.models import poisson2d, saddle_point_stokes  # noqa: E402
from hifir_tpu.ops.spmv import ell_matvec, sliced_ell_from_csr  # noqa: E402
from hifir_tpu.ops.trsv import (TrsvSchedule, build_trsv_schedule,  # noqa: E402
                                trsv_apply)
from hifir_tpu.options import Options  # noqa: E402

TOL = {"float64": 1e-10, "float32": 1e-4}
NX = 1024                 # BASELINE config 2: n = 1,048,576
MRHS = 64
# lowering + XLA compile (trace events nest for nested jits, so they are
# left out rather than counted twice)
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


class CompileClock:
    """Sums JAX's lowering and backend-compile durations, so a phase's
    compile time is reported apart from its wall time."""

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.total += duration

    def close(self):
        jax.monitoring.unregister_event_duration_listener(self._on)


class Phase:
    """Context manager printing ``[name] wall=..s compile=..s key=value``."""

    def __init__(self, clock: CompileClock, name: str):
        self.clock, self.name, self.kv = clock, name, {}

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), self.clock.total
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            wall = time.perf_counter() - self.t0
            comp = self.clock.total - self.c0
            extra = " ".join(f"{k}={v}" for k, v in self.kv.items())
            print(f"[{self.name}] wall={wall:.2f}s compile={comp:.2f}s "
                  f"{extra}".rstrip(), flush=True)
        return False


def rel_err(dev, host) -> float:
    """max|dev - host| / max|host| (the normalisation bench.py uses)."""
    dev = np.asarray(dev, dtype=np.float64)
    host = np.asarray(host, dtype=np.float64)
    if host.size == 0:
        return 0.0
    return float(np.abs(dev - host).max() / max(np.abs(host).max(), 1e-300))


def timed(fn, *args, reps: int = 3):
    """(out, first-call seconds, steady seconds): every call ends in
    ``block_until_ready``; steady is the min over ``reps`` warm calls."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def tree_bytes(tree) -> int:
    return int(sum(x.nbytes for x in jax.tree_util.tree_leaves(tree)))


def peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


# -- phase 1 ----------------------------------------------------------------
def nvidia_smi() -> list[str]:
    """Card name and power limit per GPU; run before JAX touches a card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"unavailable ({e})"]
    if r.returncode:
        return [f"unavailable (exit {r.returncode})"]
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def phase_env(cards: list[str]) -> dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise CheckFailed(f"no GPU: JAX platform is {dev.platform!r}; this "
                          "check has no CPU fallback")
    check(not cards[0].startswith("unavailable"),
          f"nvidia-smi {cards[0]}")
    from hifir_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    for line in cards:
        print(f"nvidia-smi: {line}", flush=True)
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    print(f"[env] device_kind={dev.device_kind} count={info['count']} "
          f"jax={jax.__version__} compile_cache={cache}", flush=True)
    return info


# -- phase 2 ----------------------------------------------------------------
def phase_native(clock: CompileClock) -> None:
    """Build the native host library from the tracked sources and require
    it (and its AMD ordering): no silent fall-back to the Python anchors."""
    with Phase(clock, "native") as ph:
        native_dir = os.path.join(ROOT, "hifir_tpu", "native")
        try:
            r = subprocess.run(["make", "-j8", "-C", native_dir,
                                "libhifir_tpu.so"],
                               capture_output=True, text=True, timeout=600)
        except OSError as e:
            raise CheckFailed(f"native build could not start: {e}") from e
        check(r.returncode == 0,
              "native build failed (g++ is required):\n" + r.stderr[-3000:])
        from hifir_tpu.pre import _native

        _native._LIB, _native._TRIED = None, False
        check(_native.has_crout(), "native Crout kernel not loaded")
        P = poisson2d(4)
        check(_native.amd(P.nrows, P.indptr, P.indices) is not None,
              "native AMD ordering not loaded")
        ph.kv.update(crout="loaded", amd="loaded",
                     openmp="yes" if _native.built_with_openmp() else "no")


# -- phase 3 ----------------------------------------------------------------
def phase_factorize(clock: CompileClock, A, opts: Options) -> HIF:
    with Phase(clock, "factorize") as ph:
        t0 = time.perf_counter()
        M = HIF().factorize(A, opts)
        ph.kv.update(n=A.nrows, nnz=A.nnz,
                     seconds=f"{time.perf_counter() - t0:.2f}", fill=f"{M.nnz() / A.nnz:.3f}", levels=M.levels(),
                     level_sizes=",".join(f"{p.m}/{p.n}" for p in M.precs))
    return M


# -- phase 4 ----------------------------------------------------------------
def operand_bytes(dp: DevicePrec) -> dict:
    """Host-to-device bytes of a pack, by operand kind."""
    out = collections.Counter()
    for lvl in dp.levels:
        for op in (lvl.L, lvl.U):
            out[type(op).__name__] += tree_bytes(op)
        out["SlicedELL"] += tree_bytes(lvl.E) + tree_bytes(lvl.F)
        out["vectors"] += tree_bytes((lvl.p, lvl.q_inv, lvl.s_p, lvl.t,
                                      lvl.d))
    out["DenseTail"] += tree_bytes(dp.tail)
    return dict(out)


def phase_pack(clock: CompileClock, M: HIF, dtype, dense_inv="auto"
               ) -> DevicePrec:
    name = np.dtype(dtype).name
    with Phase(clock, f"pack {name}") as ph:
        if dense_inv == "auto":
            dp = M.to_device(dtype=dtype)            # the user entry point
        else:
            dp = DevicePrec.from_host(M.precs, dtype=dtype,
                                      dense_inv=dense_inv)
        jax.block_until_ready(dp.operands())
        by_kind = operand_bytes(dp)
        ph.kv.update(bytes=sum(by_kind.values()),
                     **{f"bytes_{k}": v for k, v in sorted(by_kind.items())},
                     peak_bytes_in_use=peak_bytes(jax.devices()[0]))
    return dp


# -- phase 5 ----------------------------------------------------------------
def describe(op) -> str:
    if isinstance(op, TrsvSchedule):
        return (f"TrsvSchedule(chunks={op.nchunks},C={op.chunk},"
                f"K={op.cols.shape[-1]})")
    return type(op).__name__


def phase_kernels(clock: CompileClock, M: HIF, dp: DevicePrec,
                  seed: int = 0) -> list:
    """Each level's L/U operator, E/F SpMV and the dense tail on the device
    against the host reference on the same inputs."""
    dt = np.dtype(dp.levels[0].d.dtype if dp.levels else np.float64)
    tol = TOL[dt.name]
    rng = np.random.default_rng(seed)
    trsv = jax.jit(trsv_apply)
    spmv = jax.jit(ell_matvec)
    tail = jax.jit(tail_solve)
    results = []
    with Phase(clock, f"kernels {dt.name}") as ph:
        for i, (prec, lvl) in enumerate(zip(M.precs, dp.levels)):
            m, n = prec.m, prec.n
            xm = rng.standard_normal(m)
            xs = rng.standard_normal(n - m)
            cases = [
                ("L", lvl.L, trsv, xm, prec.L_B.solve_as_strict_lower),
                ("U", lvl.U, trsv, xm, prec.U_B.solve_as_strict_upper),
                ("E", lvl.E, spmv, xm, prec.E.matvec),
                ("F", lvl.F, spmv, xs, prec.F.matvec),
            ]
            for side, op, fn, x, ref in cases:
                dev = fn(op, jnp.asarray(x, dt))
                err = rel_err(dev, ref(x))
                kind = (describe(op) if side in "LU"
                        else f"SlicedELL({op.nrows}x{op.ncols})")
                print(f"  level {i} {side} {kind} err={err:.3e} "
                      f"tol={tol:.0e}", flush=True)
                check(err <= tol, f"level {i} {side} err {err:.3e} > {tol}")
                results.append((i, side, err))
        last = M.precs[-1]
        if last.dense_solver is not None:
            y = rng.standard_normal(last.n - last.m)
            err = rel_err(tail(dp.tail, jnp.asarray(y, dt)),
                          last.dense_solver.solve(y, 0))
            print(f"  tail {dp.tail.kind} n={y.size} rank={dp.tail.rank} "
                  f"err={err:.3e} tol={tol:.0e}", flush=True)
            check(err <= tol, f"dense tail err {err:.3e} > {tol}")
            results.append((len(M.precs), "tail", err))
        ph.kv.update(kernels=len(results),
                     max_err=f"{max(e for *_, e in results):.3e}", tol=tol)
    return results


# -- phase 6 ----------------------------------------------------------------
def phase_apply(clock: CompileClock, M: HIF, dp: DevicePrec, nrhs: int = MRHS,
                seed: int = 1) -> dict:
    dt = np.dtype(dp.levels[0].d.dtype if dp.levels else np.float64)
    tol = TOL[dt.name]
    rng = np.random.default_rng(seed)
    n = dp.n
    with Phase(clock, f"apply {dt.name}") as ph:
        b = rng.standard_normal(n)
        x, first, steady = timed(dp.solve, jnp.asarray(b, dt))
        err = rel_err(x, M.solve(b))
        check(err <= tol, f"solve err {err:.3e} > {tol}")
        B = rng.standard_normal((n, nrhs))
        X, first_m, steady_m = timed(dp.solve_mrhs, jnp.asarray(B, dt))
        cols = np.sort(rng.choice(nrhs, size=min(4, nrhs), replace=False))
        err_m = rel_err(np.asarray(X)[:, cols], M.solve_mrhs(B[:, cols]))
        check(err_m <= tol, f"solve_mrhs err {err_m:.3e} > {tol}")
        out = {"solve_s": steady, "mrhs_s": steady_m}
        ph.kv.update(solve_err=f"{err:.3e}", mrhs_err=f"{err_m:.3e}",
                     tol=tol, solve_ms=f"{steady * 1e3:.3f}",
                     solve_first_ms=f"{first * 1e3:.1f}",
                     mrhs=nrhs, mrhs_ms=f"{steady_m * 1e3:.3f}",
                     mrhs_ms_per_rhs=f"{steady_m / nrhs * 1e3:.4f}",
                     peak_bytes_in_use=peak_bytes(jax.devices()[0]))
    return out


# -- phase 7 ----------------------------------------------------------------
def phase_gmres(clock: CompileClock, A, M: HIF, dp64: DevicePrec,
                restart: int = 30, rtol: float = 1e-6) -> dict:
    from hifir_tpu.solvers import gmres_hif, gmres_hif_device

    b = A.matvec(np.ones(A.nrows))
    bn = np.linalg.norm(b)
    with Phase(clock, "gmres host") as ph:
        _, flag_h, it_h = gmres_hif(A, M, b, restart=restart, rtol=rtol)
        ph.kv.update(flag=flag_h, iters=it_h)
    check(flag_h == 0, "host GMRES did not converge")
    Aell = sliced_ell_from_csr(A)
    with Phase(clock, "gmres device") as ph:
        x, flag, it = gmres_hif_device(Aell, dp64, jnp.asarray(b),
                                       restart=restart, rtol=rtol)
        x = np.asarray(x)
        t0 = time.perf_counter()                 # second solve: warm
        gmres_hif_device(Aell, dp64, jnp.asarray(b), restart=restart,
                         rtol=rtol)[0].block_until_ready()
        run = time.perf_counter() - t0
        res = float(np.linalg.norm(b - A.matvec(x)) / bn)
        ph.kv.update(flag=flag, iters=it, host_iters=it_h,
                     true_rel_res=f"{res:.3e}", res_limit="2e-6",
                     run_s=f"{run:.3f}",
                     ms_per_iter=f"{run / max(it, 1) * 1e3:.3f}")
    check(flag == 0, "device GMRES did not converge")
    check(res <= 2e-6, f"device GMRES true residual {res:.3e} > 2e-6")
    check(abs(it - it_h) <= 0.1 * it_h,
          f"device GMRES {it} iterations vs host {it_h} (outside 10%)")
    return {"iters": it, "host_iters": it_h, "res": res, "run_s": run}


# -- phase 8 ----------------------------------------------------------------
def phase_ir(clock: CompileClock, nx: int = 64, steps: int = 10,
             seed: int = 2) -> float:
    """Mixed-precision IR on the saddle-point system: f32 device M,
    f64 host residuals; the median contraction must be < 0.5."""
    with Phase(clock, "ir") as ph:
        A = saddle_point_stokes(nx)
        M = HIF().factorize(A, Options(verbose=0))
        dp = M.to_device(dtype=jnp.float32)
        bb = np.random.default_rng(seed).standard_normal(A.nrows)
        x = np.zeros(A.nrows)
        rn = [np.linalg.norm(bb)]
        for _ in range(steps):
            r = bb - A.matvec(x)
            dx = np.asarray(dp.solve_mrhs(jnp.asarray(r, jnp.float32)[:, None]))
            x = x + dx[:, 0].astype(np.float64)
            rn.append(np.linalg.norm(bb - A.matvec(x)))
        # the median over the steps before f32 stagnation
        ratios = [rn[i + 1] / rn[i] for i in range(steps) if rn[i] > 0]
        contraction = float(np.median(ratios[:5]))
        ph.kv.update(n=A.nrows, contraction=f"{contraction:.4f}",
                     limit=0.5, rel_res=f"{rn[-1] / rn[0]:.3e}")
    check(contraction < 0.5, f"IR contraction {contraction:.3f} >= 0.5")
    return contraction


# -- phase 9 ----------------------------------------------------------------
def largest_schedule(dp: DevicePrec):
    """(level, side, schedule) of the scan level with the most chunks, or
    None when no level runs the scan."""
    best = None
    for i, lvl in enumerate(dp.levels):
        for side, op in (("L", lvl.L), ("U", lvl.U)):
            if isinstance(op, TrsvSchedule) and op.nchunks and (
                    best is None or op.nchunks > best[2].nchunks):
                best = (i, side, op)
    return best


def chain_schedule(n: int, dtype) -> TrsvSchedule:
    """Schedule of a unit lower bidiagonal factor with chunk 8: n dependent
    levels, one scan step each, 8 one-dependency rows per step — a step
    whose gather work is negligible, so its time is the step latency."""
    from hifir_tpu.ds.csr import CSR

    rows = np.arange(1, n)
    T = CSR.from_coo(n, n, rows, rows - 1, np.full(n - 1, 0.5))
    return build_trsv_schedule(T, lower=True, chunk=8, dtype=dtype)


def wide_schedule(levels: int, width: int, k: int, dtype,
                  seed: int = 0) -> TrsvSchedule:
    """Schedule of ``levels`` dependency levels of ``width`` rows, each row
    reading ``k`` random rows of the level before, one scan step per level:
    steps whose time is dominated by the gathered elements."""
    from hifir_tpu.ds.csr import CSR

    rng = np.random.default_rng(seed)
    n = levels * width
    rows = np.repeat(np.arange(width, n), k)
    lo = (rows // width - 1) * width
    cols = lo + rng.integers(0, width, size=rows.size)
    T = CSR.from_coo(n, n, rows, cols, np.full(rows.size, 1.0 / (2 * k)))
    return build_trsv_schedule(T, lower=True, chunk=width, dtype=dtype)


def scan_step_costs(dtype, chain: int = 4096, wide=(32, 32768, 8),
                    reps: int = 5) -> dict:
    """Step latency (chain schedule: one tiny step per level) and marginal
    cost per gathered element (wide schedule: latency subtracted), on the
    same jitted ``trsv_apply`` the solves run."""
    trsv = jax.jit(trsv_apply)
    cs_ = chain_schedule(chain, dtype)
    _, _, tc = timed(trsv, cs_, jnp.ones((chain,), dtype), reps=reps)
    lat = tc / cs_.nchunks
    ws = wide_schedule(*wide, dtype)
    _, _, tw = timed(trsv, ws, jnp.ones((ws.n,), dtype), reps=reps)
    per_step = ws.chunk * ws.cols.shape[-1]
    per_elem = (tw / ws.nchunks - lat) / per_step
    return {"step_latency_us": lat * 1e6, "chain_steps": cs_.nchunks,
            "wide_step_us": tw / ws.nchunks * 1e6,
            "wide_elems_per_step": per_step,
            "ns_per_elem": per_elem * 1e9,
            "step_elems": lat / per_elem if per_elem > 0 else float("inf")}


def phase_probe(clock: CompileClock, dp: DevicePrec,
                chain: int = 4096, wide=(32, 32768, 8),
                trace_dir: str | None = None, reps: int = 5) -> dict:
    """Scan-step cost on the card: the largest packed schedule (us per
    chunk, ns per gathered element), then the step latency and the marginal
    per-element cost from synthetic schedules; their ratio is the
    ``_STEP_ELEMS`` of the schedule cost model (ops/trsv.py)."""
    found = largest_schedule(dp)
    check(found is not None, "no TrsvSchedule level to probe")
    i, side, op = found
    dt = op.vals.dtype
    trsv = jax.jit(trsv_apply)
    b = jnp.asarray(np.random.default_rng(3).standard_normal(op.n), dt)
    with Phase(clock, "probe scan") as ph:
        _, _, t = timed(trsv, op, b, reps=reps)
        elems = op.nchunks * op.chunk * op.cols.shape[-1]
        ph.kv.update(level=i, side=side, op=describe(op),
                     ms=f"{t * 1e3:.3f}",
                     us_per_chunk=f"{t / op.nchunks * 1e6:.3f}",
                     ns_per_elem=f"{t / elems * 1e9:.4f}")
        out = scan_step_costs(dt, chain, wide, reps)
        out["us_per_chunk"] = t / op.nchunks * 1e6
        ph.kv.update(chain_steps=out["chain_steps"],
                     step_latency_us=f"{out['step_latency_us']:.3f}",
                     wide_step_us=f"{out['wide_step_us']:.3f}",
                     wide_elems_per_step=out["wide_elems_per_step"],
                     marginal_ns_per_elem=f"{out['ns_per_elem']:.5f}",
                     step_elems=f"{out['step_elems']:.0f}")
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            with jax.profiler.TraceAnnotation("scan_level_apply"):
                jax.block_until_ready(trsv(op, b))
        print(f"[trace] scan level {i}{side} written to {trace_dir}",
              flush=True)
    return out


def block_ell(A, bs: int, dtype, max_bytes: float):
    """Dense (bs x bs) blocks of a host CSR in block-row ELL form:
    (blocks (nbr, KB, bs, bs), block cols (nbr, KB)); None over budget."""
    nbr, nbc = -(-A.nrows // bs), -(-A.ncols // bs)
    rows = np.repeat(np.arange(A.nrows), np.diff(A.indptr))
    key = (rows // bs) * nbc + A.indices // bs
    ukey, inv = np.unique(key, return_inverse=True)
    ubr, ubc = ukey // nbc, ukey % nbc
    counts = np.bincount(ubr, minlength=nbr)
    kb = max(int(counts.max()) if counts.size else 1, 1)
    nbytes = nbr * kb * bs * bs * np.dtype(dtype).itemsize
    if nbytes > max_bytes:
        return None, nbytes
    pos = np.arange(ukey.size) - np.concatenate([[0], np.cumsum(counts)])[ubr]
    blocks = np.zeros((nbr, kb, bs, bs), dtype)
    blocks[ubr[inv], pos[inv], rows % bs, A.indices % bs] = A.data
    bcols = np.full((nbr, kb), nbc, np.int32)
    bcols[ubr, pos] = ubc
    return (jnp.asarray(blocks), jnp.asarray(bcols)), nbytes


def block_ell_matmul(blocks, bcols, X, nrows: int):
    """Y = A X in the dense-block form: one gather of X's block rows and
    one batched einsum, no hand kernel."""
    bs, R = blocks.shape[-1], X.shape[1]
    nbc = -(-X.shape[0] // bs)        # block column nbc is the zero pad
    Xp = jnp.zeros(((nbc + 1) * bs, R), X.dtype)
    Xb = Xp.at[:X.shape[0]].set(X).reshape(-1, bs, R)
    Y = jnp.einsum("rkij,rkjs->ris", blocks, Xb[bcols],
                   precision=jax.lax.Precision.HIGHEST)
    return Y.reshape(-1, R)[:nrows]


def phase_spmv_forms(clock: CompileClock, M: HIF, nrhs: int = MRHS,
                     block_sizes=(8, 32), max_bytes: float = 4e9) -> list:
    """E/F of the level with the most E/F entries at mrhs: sliced ELL
    against XLA's dense-block einsum form, f32, warm, block_until_ready."""
    from hifir_tpu.ops.spmv import ell_matvec_mrhs

    i = int(np.argmax([p.E.nnz + p.F.nnz for p in M.precs]))
    prec = M.precs[i]
    rng = np.random.default_rng(4)
    ell = jax.jit(ell_matvec_mrhs)
    rows = []
    with Phase(clock, "probe spmv") as ph:
        for name, S in (("E", prec.E), ("F", prec.F)):
            if S.nnz == 0:
                continue
            X = jnp.asarray(rng.standard_normal((S.ncols, nrhs)), jnp.float32)
            op = sliced_ell_from_csr(S, dtype=np.float32)
            y_ell, _, t_ell = timed(ell, op, X)
            print(f"  level {i} {name} {S.nrows}x{S.ncols} nnz={S.nnz} "
                  f"sliced_ell ms={t_ell * 1e3:.3f} bytes={tree_bytes(op)}",
                  flush=True)
            rows.append((name, "sliced_ell", t_ell))
            for bs in block_sizes:
                blk, nbytes = block_ell(S, bs, np.float32, max_bytes)
                if blk is None:
                    print(f"  level {i} {name} block bs={bs} skipped: "
                          f"{nbytes} bytes of blocks", flush=True)
                    continue
                fn = jax.jit(block_ell_matmul, static_argnums=3)
                y_blk, _, t_blk = timed(fn, *blk, X, S.nrows)
                err = rel_err(y_blk, y_ell)
                check(err <= TOL["float32"], f"block form err {err:.3e}")
                print(f"  level {i} {name} block bs={bs} ms={t_blk * 1e3:.3f}"
                      f" bytes={nbytes} err={err:.2e}", flush=True)
                rows.append((name, f"block{bs}", t_blk))
        ph.kv.update(level=i, mrhs=nrhs)
    return rows


# -- --four -------------------------------------------------------------------
def run_four(clock: CompileClock, nx: int = NX, ndev: int = 4) -> None:
    """DistPrec and the sharded IR step over ``ndev`` devices, against the
    single-device f64 apply."""
    from hifir_tpu.parallel import (DistPrec, make_mesh, make_sharded_ir_step,
                                    shard_ell_rows)

    devs = jax.devices()
    check(len(devs) >= ndev, f"--four needs {ndev} devices, "
                             f"JAX sees {len(devs)}")
    phase_native(clock)
    A = poisson2d(nx)
    M = phase_factorize(clock, A, Options(verbose=0))
    n = A.nrows
    b = np.random.default_rng(5).standard_normal(n)
    with Phase(clock, "single-device f64 reference") as ph:
        dp = M.to_device(dtype=jnp.float64)
        x_ref = np.asarray(dp.solve(jnp.asarray(b)))
        ph.kv.update(err_vs_host=f"{rel_err(x_ref, M.solve(b)):.3e}")
    with Phase(clock, f"distprec {ndev}") as ph:
        mesh = make_mesh(ndev, rhs=1)
        dpp = DistPrec.from_host(mesh, M)
        x, first, steady = timed(dpp.solve, jnp.asarray(b))
        err = rel_err(x, x_ref)
        holders = set()
        for leaf in jax.tree_util.tree_leaves(dpp.levels):
            holders |= {s.device for s in leaf.addressable_shards}
        peaks = [peak_bytes(d) for d in devs[:ndev]]
        ph.kv.update(err=f"{err:.3e}", tol=TOL["float64"],
                     halo_ops=dpp.n_halo, solve_ms=f"{steady * 1e3:.3f}",
                     shard_devices=len(holders),
                     peak_bytes_in_use=",".join(map(str, peaks)))
    check(err <= TOL["float64"], f"DistPrec err {err:.3e}")
    check(holders == set(devs[:ndev]),
          f"shards on {len(holders)} devices, expected {ndev}")
    check(all(p is not None and p > 0 for p in peaks),
          f"a device holds nothing: peak bytes {peaks}")
    with Phase(clock, f"sharded ir step {ndev}") as ph:
        Ae = shard_ell_rows(mesh, A)
        levels, tail = dp.operands()
        step = make_sharded_ir_step(mesh, n)
        nrhs = 2
        npad = Ae.nrows
        B = np.zeros((npad, nrhs))
        B[:n] = np.random.default_rng(6).standard_normal((n, nrhs))
        X = step(Ae.indices, Ae.values, levels, tail,
                 jnp.zeros((npad, nrhs)), jnp.asarray(B))
        X = np.asarray(X)
        r0 = max(np.linalg.norm(B[:n, k]) for k in range(nrhs))
        r1 = max(np.linalg.norm(B[:n, k] - A.matvec(X[:n, k]))
                 for k in range(nrhs))
        ph.kv.update(res_before=f"{r0:.3e}", res_after=f"{r1:.3e}")
    check(np.all(np.isfinite(X)), "sharded IR step is not finite")
    check(r1 < r0, "sharded IR step did not lower the residual")


# -- default ------------------------------------------------------------------
def run_default(clock: CompileClock, nx: int = NX, trace_dir=None) -> None:
    phase_native(clock)
    A = poisson2d(nx)
    M = phase_factorize(clock, A, Options(verbose=0))
    dp32 = phase_pack(clock, M, jnp.float32)
    dp64 = phase_pack(clock, M, jnp.float64)
    for dp in (dp64, dp32):
        phase_kernels(clock, M, dp)
    apply64 = phase_apply(clock, M, dp64)
    phase_apply(clock, M, dp32)
    g = phase_gmres(clock, A, M, dp64)
    print(f"[gmres] preconditioner apply {apply64['solve_s'] * 1e3:.3f} ms "
          f"(f64, single RHS, warm); device GMRES "
          f"{g['run_s'] / max(g['iters'], 1) * 1e3:.3f} ms per iteration",
          flush=True)
    phase_ir(clock)
    phase_probe(clock, dp64, trace_dir=trace_dir)
    phase_spmv_forms(clock, M)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed apply on 4 GPUs")
    ap.add_argument("--trace", metavar="DIR",
                    help="write a profile of one scan-level apply to DIR")
    args = ap.parse_args(argv)
    cards = nvidia_smi()                       # before JAX touches a card
    try:
        info = phase_env(cards)
    except CheckFailed as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    clock = CompileClock()
    try:
        if args.four:
            run_four(clock)
        else:
            run_default(clock, trace_dir=args.trace)
    finally:
        clock.close()
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

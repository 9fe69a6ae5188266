"""Batched multilevel M-solve throughput on one GPU.

Measures the HIF preconditioner application (the inner loop of every Krylov
solve; BASELINE.json metric "M-solve (trsv+IR) nnz/s/chip") on a 2-D Poisson
system (BASELINE.json config 2, cut to 256^2): factorize on the host (native
C++ deferred-Crout kernels), pack to the device as level-scheduled trsv
schedules + sliced-ELL, and apply to a batch of right-hand sides in f32 with
an f64-residual correctness check (the mixed-precision mode mirroring the
reference ``lhfsdApply``).

Baseline: the same preconditioner applied by the serial host path (native C++
trsv + SpMV — the reference library's execution model, measured on the same
machine).  vs_baseline = device per-RHS throughput / host per-RHS throughput.

Every device time ends in ``block_until_ready``.  Needs a GPU (exits non-zero
otherwise) and one process per card.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "extras"}.
"""

import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def min_time(fn, reps: int = 7):
    """Min wall time of ``fn()`` over ``reps`` calls (min is robust to
    scheduler noise on a shared host)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: no GPU (JAX platform {dev.platform!r}); no CPU fallback")
        return 2
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from hifir_tpu.api import HIF
    from hifir_tpu.models import poisson2d, saddle_point_stokes
    from hifir_tpu.options import Options
    from hifir_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kind = dev.device_kind
    NX = 256
    NRHS = 128
    A = poisson2d(NX)
    n = A.nrows
    opts = Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                   kappa_d=5, verbose=0)
    # min-of-3: a single-shot factorize time on a shared host is noise
    fact_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        M = HIF().factorize(A, opts)
        fact_times.append(time.perf_counter() - t0)
    t_fact = min(fact_times)
    nnz_m = M.nnz()
    fact_thr = A.nnz / t_fact  # north-star "factorization nnz/s"
    log(f"n={n} nnz(A)={A.nnz} factorize min-of-3 {t_fact:.2f}s "
        f"(all: {', '.join(f'{t:.2f}' for t in fact_times)}; "
        f"{fact_thr / 1e6:.2f} Mnnz/s) fill {nnz_m / A.nnz:.2f} "
        f"levels {M.levels()}")

    # --- host baseline: serial single-RHS M-solve (native C++ kernels) -----
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    xh = M.solve(b)
    host_per_rhs = min_time(lambda: M.solve(b))
    host_thr = nnz_m / host_per_rhs
    log(f"host M-solve: {host_per_rhs * 1e3:.2f} ms/RHS "
        f"({host_thr / 1e6:.1f} Mnnz/s)")

    # --- device batched solve -----------------------------------------------
    dp = M.to_device(dtype=jnp.float32)
    B = jnp.asarray(rng.standard_normal((n, NRHS)), jnp.float32)
    X = dp.solve_mrhs(B).block_until_ready()          # compile + warm
    dev_total = min_time(lambda: dp.solve_mrhs(B).block_until_ready())
    dev_per_rhs = dev_total / NRHS
    dev_thr = nnz_m / dev_per_rhs
    log(f"{kind} M-solve mrhs={NRHS} f32: {dev_total * 1e3:.2f} ms total, "
        f"{dev_per_rhs * 1e3:.4f} ms/RHS ({dev_thr / 1e6:.1f} Mnnz/s/RHS)")

    # --- frozen-operator headline leg ---------------------------------------
    # The fresh-factorize throughput moves when the *factorization* changes
    # (better ordering -> lower fill -> mechanically lower nnz/s) even if the
    # solve kernels are unchanged.  The headline therefore times a
    # checked-in, frozen preconditioner (benchdata/frozen_prec.npz,
    # examples/make_bench_fixture.py), comparable across changes.
    frozen = None
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "benchdata", "frozen_prec.npz")
    if os.path.exists(fx):
        from hifir_tpu.utils.serialize import load_prec

        Mf = load_prec(fx)
        nf = Mf.precs[0].n
        nnz_f = Mf.nnz()
        bf = rng.standard_normal(nf)
        Mf.solve(bf)
        frozen_host_thr = nnz_f / min_time(lambda: Mf.solve(bf))
        dpf = Mf.to_device(dtype=jnp.float32)
        Bf = jnp.asarray(rng.standard_normal((nf, NRHS)), jnp.float32)
        Xf = dpf.solve_mrhs(Bf).block_until_ready()
        tf = min_time(lambda: dpf.solve_mrhs(Bf).block_until_ready())
        b0 = np.asarray(Bf[:, 0], np.float64)
        relf = (np.abs(np.asarray(Xf[:, 0], np.float64) - Mf.solve(b0)).max()
                / max(np.abs(Mf.solve(b0)).max(), 1e-300))
        frozen = {"ms_per_rhs": tf / NRHS * 1e3,
                  "thr": nnz_f / (tf / NRHS),
                  "host_thr": frozen_host_thr, "rel": relf}
        log(f"FROZEN M-solve on {kind} (n={nf}, nnz(M)={nnz_f}, "
            f"mrhs={NRHS}): {tf * 1e3:.3f} ms/solve, "
            f"{frozen['ms_per_rhs'] * 1e3:.2f} us/RHS "
            f"({frozen['thr'] / 1e9:.3f} Gnnz/s/RHS); host "
            f"{frozen_host_thr / 1e6:.1f} Mnnz/s; rel diff {relf:.2e}")
        if not relf < 1e-4:
            raise SystemExit(f"frozen device solve deviates from host: "
                             f"{relf:.2e} >= 1e-4")
    else:
        log("frozen fixture missing (benchdata/frozen_prec.npz) — skipping")

    # --- correctness 1: device f32 solve vs host f64 solve ------------------
    b0 = np.asarray(B[:, 0], dtype=np.float64)
    xr = M.solve(b0)
    rel_dev = (np.abs(np.asarray(X[:, 0], dtype=np.float64) - xr).max()
               / max(np.abs(xr).max(), 1e-300))
    log(f"device-vs-host M-solve rel diff (f32 pack): {rel_dev:.2e}")
    if not rel_dev < 1e-4:
        raise SystemExit(f"device solve deviates from host: {rel_dev:.2e} "
                         ">= 1e-4")

    # --- correctness 2: mixed f32-M / f64-residual IR must contract ---------
    # BASELINE.json config 3 is a saddle-point system with static deferring
    # and mixed-precision IR (the reference's ``lhfsdApply``): factorize the
    # generated Stokes-type saddle-point operator with robust defaults (its
    # zero pressure diagonals exercise the static deferral) and require a
    # healthy Richardson contraction (< 0.5/step median).  The robust-params
    # factorize of the Poisson system is timed here too (min-of-2).
    rob_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        Mr = HIF().factorize(A, Options(verbose=0))
        rob_times.append(time.perf_counter() - t0)
    fact_thr_robust = A.nnz / min(rob_times)
    log(f"robust factorize min-of-2 {min(rob_times):.2f}s "
        f"(all: {', '.join(f'{t:.2f}' for t in rob_times)}; "
        f"{fact_thr_robust / 1e6:.2f} Mnnz/s) fill {Mr.nnz() / A.nnz:.2f}")

    Asp = saddle_point_stokes(64)
    Msp = HIF().factorize(Asp, Options(verbose=0))
    dpr = Msp.to_device(dtype=jnp.float32)
    nsp = Asp.nrows
    x = np.zeros(nsp)
    bb = rng.standard_normal(nsp)
    rnorms = [np.linalg.norm(bb)]
    for _ in range(10):
        r = bb - Asp.matvec(x)
        dx = np.asarray(dpr.solve_mrhs(jnp.asarray(r, jnp.float32)[:, None]))
        x = x + dx[:, 0].astype(np.float64)
        rnorms.append(np.linalg.norm(bb - Asp.matvec(x)))
    rel = rnorms[-1] / rnorms[0]
    # median per-step contraction over the steps before f32 stagnation
    steps = [rnorms[i + 1] / rnorms[i] for i in range(10) if rnorms[i] > 0]
    contraction = float(np.median(steps[:5]))
    log(f"mixed-precision IR (saddle-point robust M, n={nsp}): residual "
        f"{rel:.2e} after 10 steps, median contraction/step "
        f"{contraction:.3f}")
    if not contraction < 0.5:
        raise SystemExit(f"IR contraction {contraction:.3f} >= 0.5")

    if frozen is not None:
        headline = frozen["thr"]
        headline_vs = frozen["thr"] / frozen["host_thr"]
        metric = "hif_msolve_frozen_throughput_per_device"
    else:
        headline, headline_vs = dev_thr, dev_thr / host_thr
        metric = "hif_msolve_throughput_per_device"
    print(json.dumps({
        "metric": metric,
        "value": headline,
        "unit": "nnz/s",
        "vs_baseline": headline_vs,
        "device": {"platform": dev.platform, "kind": kind,
                   "count": len(jax.devices())},
        "extras": {
            "frozen_us_per_rhs": (None if frozen is None
                                  else frozen["ms_per_rhs"] * 1e3),
            "fresh_ms_per_rhs": dev_per_rhs * 1e3,
            "fresh_nnz_per_s": dev_thr,
            "fresh_vs_host": dev_thr / host_thr,
            "factorize_nnz_per_s": fact_thr,
            "factorize_robust_nnz_per_s": fact_thr_robust,
            "fill_ratio": nnz_m / A.nnz,
            "ir_contraction_per_step": contraction,
            "ir_rel_residual_10_steps": rel,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``safe_exploration_tpu_torch/csrc``,
holds each against its plain PyTorch version, drives the port's paths
(the batched lane SQP safe-MPC on the pendulum at H=5, B=512, with GP refits
through the kernels; the batched lane CEM at H=5, B=256, M=64, scoring
through the cem_score and gp_predict kernels; the episodic closed loop of
``runtime.main --config pendulum_episode``, also at n_max 2048 where the
refits take cholesky_hbm; the lane fleet of ``runtime.main --config
pendulum_batch_sqp``, 256 per-lane models refitted by model-batched
kernels; BASELINE config 2, the cart-pole, through ``--config
cartpole_batch_sqp`` (128 lanes, 4-D states, the array-form tube and a
performance trajectory) and ``--config cartpole_episode``; the
single-instance safe-MPC NLP behind ``--config pendulum_episode_sqp`` and
``--config cartpole_episode_sqp``; BASELINE config 5, the 6-D planar
quadrotor, through ``--config quadrotor_batch_sqp`` and ``--config
quadrotor_episode``; the risk-priced objective of ``--config
cartpole_risk_sqp``; BASELINE config 4, the sparse (inducing-point) GP,
through ``--config pendulum_large_sparse`` and ``--config
pendulum_episode_sparse``, the lane SQP and the lane CEM on it; BASELINE
config 3 as registered, ``--config pendulum_batch``: the stacked fleet of
256 per-lane models, the portable CEM on a lane axis scored by the
model-batched cem_score, O(n^2) appends) and checks the GPU against the
CPU in f64.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]
    python3 chip_smoke.py --phases nlp,episode-sqp   # a partial run

Phases (any failure exits non-zero, without the final ``ok`` line):
  1. device   card name and power limit (nvidia-smi), CUDA and torch versions
  2. build    nvcc for every kernel source, all at once
  3. kernels  every kernel against its plain version at the main path's shapes
              (e=2, n=128), at n=512 and at a ragged n=200, in f32 and f64:
              gram (also at n=2048; exactly symmetric), cholesky (its
              shared-memory tier to n=224 f32 / 160 f64
              and its blocked tier above), trsm's three entries (trsm_lower
              at m=1, 7, n; solve_psd at m=1; tri_inv_lower, zero above the
              diagonal); NaN from a bad pivot in each Cholesky tier; CUDA-
              event ms, device ms per CUDA kernel (profiler) and bound at the
              least work of the Gram, beta (solve_psd), K^-1's solve
              (tri_inv_lower) and cholesky at n=128, 512 and 2048, each
              beside its torch.linalg call where one exists
     batch-kernels  the model-batched gram (a leading axis of L models in
              one launch) against gram_plain, f32 and f64, at L = 256, e = 2,
              n = 128 (the fleet refit) and L = 2, n = 2048, with per-lane
              and shared masks, exactly symmetric; the fleet refit's
              cholesky, solve_psd and tri_inv_lower at its shape (512
              matrices of n = 128) against f64 plain, each matrix within
              2e-4 (f32) / 1e-10 (f64), zero above the diagonal; those
              kernels timed there: CUDA-event and device ms, plain,
              library, bound; the same checks and times at the cart-pole
              fleet's shape (L = 128, e = 4, d = 5, n = 128: 512 Grams)
              and the quadrotor fleet's (L = 64, e = 6, d = 8, n = 96: 384
              Grams, a partial 64-wide tile), each Gram held against
              gram_plain matrix by matrix; the episodes' single models at
              n = 512 (e = 4, d = 5 and e = 6, d = 8) held the same way
     cem      gp_predict (its prepared call against the plain version on
              the same prepared posterior) and cem_score against their
              plain versions at n = 64 (H 5) and 128 (H 3, pendulum_batch's
              shape), L = 16,384 and a ragged 1,000, f32 and f64, with and
              without the Jacobian, z_scale on and off, tracking and
              exploration; CUDA-event times of kernel and plain version;
              both kernels' calls with a prepared object (as the CEM path
              calls them), the preparation alone and the call without one,
              and their device times (profiler); gp_predict at the
              quadrotor's e = 6, d = 8 (DMAX), n = 512, with and without
              the Jacobian, at L = 16,384, 1,000 and 64, f32 and f64, and
              timed at L = 16,384
  4. path     build_experiment at the headline budget, a GP refit, two batched
              get_action_batch calls around a plant step and an ssm_update
              (a second refit); launch counts are zeroed just before and read
              just after
  5. parity   the refit factors and the first get_action_batch in f64 at B=16
              on the GPU (kernels) and on the CPU (plain versions)
  6. cem      the lane CEM (bench.py's bench_cem_solves configuration: n_max
              64 with 48 points, B=256, M=64, 12 elites, 4 iterations), a
              refit and two get_action_batch calls around a plant step and
              an ssm_update, launch counts zeroed just before and read just
              after; then one solve per cem_gp_impl ("auto", "pallas", "xla")
              twice each in alternating order, same generator seed
  7. cemparity  f64, B=16: one get_action_batch on the GPU (kernels) and on
              the CPU (plain versions) with the draws of one CPU generator
     stacked-kernels  (run after cem-kernels) the model-batched cem_score
              (B models, each scoring its own M lanes, one launch) against
              its plain version at pendulum_batch's shape, B 256, n 128, H 3,
              M 64, 40 and 1, distinct per-lane models, tracking and
              exploration, f32 and f64; the B = 1 stack equal to the shared
              call; CUDA-event, device and plain ms and the bound (f32)
     batch-stacked  BASELINE config 3 as registered: run_experiment on
              pendulum_batch (256 lanes, n_max 128, 24 initial points, 120
              fit steps, 20 steps of the portable CEM on a lane axis, M 64,
              12 elites, 4 iterations, H 3, one O(n^2) append per lane a
              step), f32: the series, the step's split into plan, predict
              and append, the busy share, the lanes whose model turned
              non-finite, cem_score's launches (6 a step)
     batch-stacked-parity  f64, 8 lanes, 3 steps: GPU against CPU on one
              set of draws (counts and flags equal, trajectories and final
              factors 1e-9)
  8. batch    the fleet CLI's run_experiment on pendulum_batch_sqp at full
              width (256 lanes, n_max 128, 5 of its 20 steps, 2 of its 4
              episodes),
              f32: per-episode series, steps/s, fit / calibration / unstack
              refit times, the batched refit's split beside one lane's,
              launches (one per refit kernel per refit), the model's
              self-pair distance (exactly 0) and its l_mu against the CPU's;
              one fleet step's solve under the profiler (busy share)
  9. batch-parity  f64, 8 lanes, 3 steps, 2 episodes: GPU against CPU on one
              set of draws
     cartpole-batch  the same for cartpole_batch_sqp as registered (128
              lanes, n_max 128, 40 initial points, n_safe 6, n_perf 10,
              r_shared 2, the SQP at 4 x 3), 2 of its 4 episodes and 2 of
              its 16 steps an episode, f32: the same series, times, step
              split, busy share and gates
     cartpole-batch-parity  f64, 2 lanes, 1 step, 2 episodes of
              cartpole_batch_sqp: GPU against CPU on one set of draws
 10. hbm      cholesky_hbm against its plain version at n = 1300, 2048 and
              4096 (e=2, f32 within 3e-4 of the f64 factor, f64 at 1e-9), NaN
              on an indefinite input, trsm's entries at n = 2048
              (tri_inv_lower, solve_psd, trsm_lower at m = 1 and n); CUDA-
              event times of cholesky_hbm, cholesky_blocked (called past its
              wrapper's limit), cholesky_ex and the plain version at 1024,
              2048 and 4096, and cholesky_hbm's device time per kernel
              (profiler)
 11. episode  the episodic CLI's run_experiment on the card: (a)
              pendulum_episode (1 of its 6 episodes, 15 of its 50 steps),
              (b) the same with
              n_max 2048, 1,024 initial points, 60 hyperparameter steps;
              launch counts zeroed just before each run and read just after;
              per-episode series and fit / calibration / refit times, and the
              final model's refit split (gram / cholesky / beta / K^-1 solve
              / matmul, CUDA events)
 12. episode-parity  f64, one episode of 3 steps at n_max 2048: GPU against
              CPU on one set of draws
 13. cartpole-episode  cartpole_episode as registered (portable CEM, 192
              samples, n_safe 10, n_perf 10, n_max 512), 1 of its 6
              episodes, 10 of its 50 steps, f32: series, seconds per step,
              the refit split and
              launches
 14. nlp      one single-instance NLP solve (solvers/sqp.py, the planner of
              pendulum_episode_sqp: Gauss-Newton AL at 12 x 6 + 3 polish,
              H = 5) on that run's first model, on the CPU in f64 and on the
              card in f64 and f32: k_ff, lam and g of the card's f64 solve
              within 1e-9 of the CPU's, feasible flags equal, no host read
              inside a card solve (sync debug mode "error"); ms per solve,
              CUDA kernels per solve and per Gauss-Newton step
 15. episode-sqp  the episodic CLI's run_experiment for
              pendulum_episode_sqp (1 of its 6 episodes, NLP_PEND_STEPS of
              its 50 steps) and cartpole_episode_sqp (n_safe 10 + n_perf
              10, r_shared 2; 1 of its 6 episodes, NLP_CART_STEPS of its 50
              steps), f32: the gates and prints of the episode phase
 16. episode-sqp-parity  f64, pendulum_episode_sqp for one episode of 3
              steps (3 hyperparameter steps): GPU against CPU on one set of
              draws
 17. quadrotor-batch  the fleet phase for quadrotor_batch_sqp (64 lanes,
              n_max 96, 40 initial points, n_safe 3 + n_perf 5, r_shared
              1, 4 x 3, 2 episodes of 2 of its 8 steps), f32, with its
              gates
 18. quadrotor-batch-parity  f64, 2 lanes, 1 step, 2 episodes of
              quadrotor_batch_sqp: GPU against CPU on one set of draws
 19. quadrotor-episode  quadrotor_episode (portable CEM, 256 samples, n_safe
              5 + n_perf 12, n_max 512), 1 of its 6 episodes and 25 of its
              50 steps, f32: the episode phase's gates and prints
 20. quadrotor-cem  one batched lane-CEM solve (cem_backend "lanes", B 64)
              on quadrotor_episode's first model: "auto" (gp_predict at
              d = 8 with the Jacobian) against "xla" in f32, the card's f64
              against the CPU's on 8 lanes
 21. risk     cartpole_risk_sqp's NLP planner solved once as in ``nlp`` (cut
              to 5 safety stages and a 4 x 3 + 3 budget), then the lane SQP
              under the risk objective at cartpole_batch_sqp's width (128
              lanes), f32 and f64, the card's f64 against the CPU's on 4
              lanes; f64 gates 1e-9 (NLP) and RISK_LANE_TOL (lane SQP)
 22. episode-risk  one episode of cartpole_risk_sqp cut to 1 step: the
              episode phase's gates
 23. sparse-kernels  gp_predict (with and without the Jacobian) and
              cem_score on a sparse posterior (m inducing rows, alpha and
              Kuu^-1 - Sigma^-1, no mask) at m = 256 (cem_score's streamed-W
              tier) and m = 32, d 3, e 2, L 16,384 and 1,000, f32 and f64,
              against their plain versions (the f32 variance relative to
              sf2); f32 times at the CEM path's shapes
 24. sparse-refit  sparse_gp_refit at n 10,240, m 256, d 7, e 2 (CUDA
              events, f32 and f64) and sparse_gp_predict; the card's f64
              factors against the CPU's at 1e-9, the f32 factors finite
 25. sparse-batch  the lane SQP on bench_sparse_solves' model (N 10,240, m
              256, c_safety 1.8) at B 512, H 5, f32: two get_action_batch
              calls around a plant step and an ssm_update (solves/s,
              feasible_frac, 0 violations); f64 on 16 lanes card vs CPU
              (factors 1e-9, flags equal, k_ff 1e-4)
 26. sparse-cem  the lane CEM on that model at B 256, M 64: "auto" (both
              kernels launched, counts zeroed just before) against "xla",
              flags equal on every lane; the busy share; f64 card vs CPU on
              16 lanes (flags equal, k_ff 1e-9)
 27. episode-sparse  pendulum_large_sparse as registered (n_max 10,240, m
              256, 1,024 initial points, 60 fit steps, the NLP) for 1 of its
              6 episodes and 2 of its 50 steps, pendulum_episode_sparse
              (portable CEM, m 32) for 1 episode of 10 steps: wall, fit s, s
              a step, feasibility, 0 violations; then f64 card vs CPU of
              pendulum_episode_sparse, 3 steps at n_max 64 (counts equal,
              floats and factors 1e-9)

The second-to-last lines are one JSON object ``{"kernels": [...]}`` and the
card's name and power limit; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense, no sparsity), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

E = 2          # GP output dims on the pendulum path
N_PATH = 128   # n_max of the headline path
D_IN = 3       # pendulum state + action
N_CEM = 64     # n_max of the CEM path (bench.py bench_cem_solves)
B_CEM = 256    # CEM instances
M_CEM = 64     # CEM samples per instance: L = M * B scoring lanes
H_CEM = 5      # CEM horizon
CEM_FEAS_JAX = 0.273  # cem_feasible_frac the JAX package records (BENCH_r05)


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    FAILURES.append(msg)


FAILURES: list[str] = []


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return smi


def phase_build() -> None:
    from safe_exploration_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def _trsm_bytes(n: int, m: int, sz: int) -> int:
    """L's lower triangle read once, B read once, X written once, for the E
    matrices."""
    return E * (n * (n + 1) // 2 + 2 * n * m) * sz


def _square_from_tri_bytes(n: int, sz: int) -> int:
    """A lower triangle read once and an n x n result written once, for the
    E matrices: the least traffic of the Cholesky and of L^-1."""
    return E * (n * (n + 1) // 2 + n * n) * sz


def _gram_args(rng, n, dtype, device):
    x = rng.uniform(-1.0, 1.0, (n, D_IN))
    mask = (np.arange(n) < n - 7).astype(np.float64)   # ragged valid prefix
    log_ls = rng.normal(-0.5, 0.3, (E, D_IN))
    log_sf = np.array([-3.0, -2.5])
    log_noise = np.array([-4.0, -3.8])
    return [torch.tensor(a, dtype=dtype, device=device)
            for a in (x, mask, log_ls, log_sf, log_noise)]


def phase_kernels(seed: int) -> dict:
    """Correctness at every shape and dtype (cholesky's two tiers; trsm's
    three entries: trsm_lower at m = 1 (the vector kernel), 7 and n,
    solve_psd at m = 1, tri_inv_lower), NaN from a bad pivot in each
    Cholesky tier, then the refit kernels' times."""
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        cholesky_plain,
        gram_plain,
        rbf_gram_masked,
        solve_psd,
        tri_inv_lower,
        trsm_lower,
        trsm_plain,
    )

    rng = np.random.default_rng(seed)
    errs = {"gram": 0.0, "cholesky": 0.0, "trsm": 0.0}
    # the Gram alone at run (b)'s shape: its tiles over the lower triangle
    # and their mirrors against the plain version, exactly symmetric
    for dtype in (torch.float32, torch.float64):
        args = _gram_args(rng, N_HBM, dtype, "cuda")
        k = rbf_gram_masked(*args)
        e_g = _rel(k, gram_plain(*args))
        sym = bool(torch.equal(k, k.mT))
        tol_g = 1e-10 if dtype == torch.float64 else 1e-5
        print(f"[kernels] {str(dtype)[6:]} e={E} n={N_HBM}: gram rel {e_g:.2e}"
              f" (tol {tol_g:g}), exactly symmetric {sym}", flush=True)
        if not (e_g <= tol_g and sym):
            _fail(f"gram disagrees with plain or is not symmetric at {dtype} "
                  f"n={N_HBM}")
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        for n in (N_PATH, 200, 512):
            args = _gram_args(rng, n, dtype, "cuda")
            args64 = [a.double() for a in args]
            k = rbf_gram_masked(*args)
            kp = gram_plain(*args)
            e_g = _rel(k, kp)
            sym = bool(torch.equal(k, k.mT))
            k64 = gram_plain(*args64)
            l = cholesky_blocked(k64.to(dtype))
            l64 = cholesky_plain(k64)
            e_c = _rel(l, l64)
            upper_zero = bool((torch.triu(l, 1) == 0).all())
            y = torch.tensor(rng.normal(size=(E, n, 1)), device="cuda")
            b7 = torch.tensor(rng.normal(size=(E, n, 7)), device="cuda")
            eye = torch.eye(n, dtype=torch.float64, device="cuda").expand(E, n, n)
            eye = eye.contiguous()
            lt = l64.to(dtype)
            pairs = [(trsm_lower(lt, b.to(dtype), tr), trsm_plain(l64, b, tr))
                     for b, tr in ((y, False), (y, True), (b7, False),
                                   (b7, True), (eye, False))]
            pairs.append((solve_psd(lt, y.to(dtype)),
                          trsm_plain(l64, trsm_plain(l64, y), True)))
            linv = tri_inv_lower(lt)
            pairs.append((linv, pairs[-2][1]))
            upper_zero &= bool((torch.triu(linv, 1) == 0).all())
            e_t = max(_rel(x, xp) for x, xp in pairs)
            a_t = max(_abs(x, xp) for x, xp in pairs)
            tol_g, tol_ct = (1e-10, 1e-10) if f64 else (1e-5, 2e-4)
            print(f"[kernels] {str(dtype)[6:]} e={E} n={n}: gram rel {e_g:.2e} "
                  f"(tol {tol_g:g}), symmetric {sym}, cholesky rel {e_c:.2e}, "
                  f"trsm (trsm_lower m=1/7/n, solve_psd, tri_inv_lower) rel "
                  f"{e_t:.2e} (tol {tol_ct:g}), zeros above the diagonal "
                  f"{upper_zero}", flush=True)
            if not (e_g <= tol_g and sym and e_c <= tol_ct and e_t <= tol_ct
                    and upper_zero):
                _fail(f"kernel disagrees with plain at {dtype} n={n}")
            if dtype == torch.float32 and n == N_PATH:
                errs = {"gram": _abs(k, kp), "cholesky": _abs(l, l64),
                        "trsm": a_t}
    # a bad pivot in each Cholesky tier (f32 to n 224, f64 to 160 in shared
    # memory; the blocked tier above)
    nan_ok = True
    for dtype, n, at in ((torch.float32, 200, 150), (torch.float64, 100, 40),
                         (torch.float64, 200, 150), (torch.float32, 512, 300)):
        bad = gram_plain(*_gram_args(rng, n, torch.float64, "cuda"))
        bad[:, at, at] = -1.0
        l_bad = cholesky_blocked(bad.to(dtype))
        nan_ok &= bool(torch.isfinite(l_bad[:, :at, :at]).all()) and bool(
            torch.isnan(l_bad[:, at:, at]).all()) and bool(
            torch.isnan(l_bad[:, -1, -1]).all())
    print(f"[kernels] indefinite input -> NaN from the bad pivot on, finite "
          f"before it, in both tiers: {nan_ok}", flush=True)
    if not nan_ok:
        _fail("cholesky does not give NaN on an indefinite input")

    return {"errs": errs, "timings": _refit_kernel_times(rng)}


def _lib_solve(l, b, transpose=False):
    """torch.linalg's triangular solve, the library yardstick of trsm."""
    if transpose:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def _refit_solves(l, y):
    """The refit's two solve calls through the kernels: beta = K^-1 y
    (forward and transposed solve, m = 1) and L^-1 for K^-1."""
    from safe_exploration_tpu_torch.ops.kernels import (
        solve_psd,
        tri_inv_lower,
    )

    return {"beta": lambda: solve_psd(l, y),
            "kinv": lambda: tri_inv_lower(l)}


def _refit_kernel_times(rng) -> dict:
    """CUDA-event ms per call of the refit's kernels at n = 128 (the SQP
    path), 512 (episodic run (a)) and 2048 (run (b)), e = 2, f32 and f64,
    each beside its torch.linalg call, its device ms per CUDA kernel
    (profiler, f32 only) and its bound at the least work: the Gram its
    inputs read once and e n^2 values written; beta 2 n^2 flops
    and L's triangle, y and beta moved once; K^-1's solve n^3 / 3 flops
    (L^-1 is triangular) and the triangle read, n^2 words written; the
    Cholesky the same (the blocked kernel at 128 and 512; cholesky_hbm
    keeps 2048). Plain versions are timed at the path shape only. Keys
    ``<dtype>_n<n>``; ``N_PATH`` f32 also under the int key, as the kernels
    line reads it."""
    from safe_exploration_tpu_torch.models.gp import refit_cholesky
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        cholesky_plain,
        gram_plain,
        rbf_gram_masked,
        trsm_plain,
    )

    out = {}
    for n in (N_PATH, 512, N_HBM):
        for dt in (torch.float32, torch.float64):
            sz = torch.finfo(dt).bits // 8
            args = _gram_args(rng, n, dt, "cuda")
            k = rbf_gram_masked(*args)
            l = refit_cholesky(n)(k)
            y = torch.tensor(rng.normal(size=(E, n, 1)), dtype=dt,
                             device="cuda")
            eye = torch.eye(n, dtype=dt, device="cuda").expand(E, n, n)
            eye = eye.contiguous()
            solves = _refit_solves(l, y)
            reps = {N_PATH: 50, 512: 20}.get(n, 5)
            path = dt == torch.float32 and n == N_PATH
            t = {
                "beta": dict(
                    fn=solves["beta"],
                    library=lambda: _lib_solve(l, _lib_solve(l, y), True),
                    plain=lambda: trsm_plain(l, trsm_plain(l, y), True),
                    bound=_bound_ms(_trsm_bytes(n, 1, sz), E * 2 * n * n,
                                    dt)),
                "kinv": dict(
                    fn=solves["kinv"], library=lambda: _lib_solve(l, eye),
                    plain=lambda: trsm_plain(l, eye),
                    bound=_bound_ms(_square_from_tri_bytes(n, sz),
                                    E * n ** 3 / 3, dt)),
            }
            if n <= 512:
                t["cholesky"] = dict(
                    fn=lambda: cholesky_blocked(k),
                    library=lambda: torch.linalg.cholesky_ex(k),
                    plain=lambda: cholesky_plain(k),
                    bound=_bound_ms(_square_from_tri_bytes(n, sz),
                                    E * n ** 3 / 3, dt))
            in_bytes = (n * D_IN + n + E * D_IN + 2 * E) * sz
            t["gram"] = dict(
                fn=lambda: rbf_gram_masked(*args), library=None,
                plain=lambda: gram_plain(*args),
                bound=_bound_ms(in_bytes + E * n * n * sz,
                                E * n * n * (2 * D_IN + 7), dt))
            res = {}
            for name, c in t.items():
                # each profiler run costs seconds: f32 only (the paths' type)
                dev_ms, by_kernel = (_device_ms(c["fn"]) if dt == torch.float32
                                     else (None, {}))
                r = {"ms": _time_ms(c["fn"], reps),
                     "library_ms": (None if c["library"] is None
                                    else _time_ms(c["library"], reps)),
                     "plain_ms": _time_ms(c["plain"], 3) if path else None,
                     "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
                     "bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                res[name] = r
                lib = ("null" if r["library_ms"] is None
                       else f"{r['library_ms']:.4f}")
                plain = ("" if r["plain_ms"] is None
                         else f", plain {r['plain_ms']:.4f} ms")
                dev = ("" if dev_ms is None else f" (device {dev_ms:.4f}: "
                       f"{ {k2: round(v, 4) for k2, v in by_kernel.items()} })")
                print(f"[kernels] time {str(dt)[6:]} n={n} {name}: kernel "
                      f"{r['ms']:.4f} ms{dev}, library {lib} ms{plain}, bound "
                      f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
            out[f"{str(dt)[6:]}_n{n}"] = res
            if path:
                # the kernels line's trsm: one refit's solves (beta and L^-1)
                res["trsm"] = {
                    key: (res["beta"][key] + res["kinv"][key]
                          if key in ("ms", "library_ms", "plain_ms",
                                     "device_ms") else None)
                    for key in res["beta"]}
                res["trsm"]["bound_ms"], res["trsm"]["bound_by"] = _bound_ms(
                    _trsm_bytes(n, 1, sz) + E * n * n * sz,  # L read once
                    E * 2 * n * n + E * n ** 3 / 3, dt)
                out[n] = res
    return out


def _make_data(rng, n_data, dtype, device, exp):
    """Transitions with bench.py's distributions (x in +-[0.3, 1.0], u in
    +-1) and numpy process noise; residuals against the prior (a, b)."""
    from safe_exploration_tpu_torch.envs import env_step

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    xs = t(rng.uniform(-1.0, 1.0, (n_data, 2)) * [0.3, 1.0])
    us = t(rng.uniform(-1.0, 1.0, (n_data, 1)))
    _, x_next = env_step(exp["env"], xs, us,
                         noise=t(rng.standard_normal((n_data, 2))))
    resid = x_next - (xs @ exp["a"].T + us @ exp["b"].T)
    return xs, us, resid


def _bench_ssm(exp, xs, us, resid, dtype, device, n_max=N_PATH):
    """bench.py's model: GP-SSM on raw inputs, l_mu 0.05, l_sigma 0.02,
    log_noise -4, then log_sf = -3 for every dim and a refit."""
    from safe_exploration_tpu_torch.models import gp_refit, make_gp_ssm

    def full(v):
        return torch.full((2,), v, dtype=dtype, device=device)

    ssm = make_gp_ssm(exp["kern_types"], xs, us, resid, n_max=n_max,
                      l_mu=full(0.05), l_sigma=full(0.02), log_noise=-4.0)
    params = tuple({**p, "log_sf": torch.tensor(-3.0, dtype=dtype,
                                                device=device)}
                   for p in ssm.gp.params)
    return ssm.replace(gp=gp_refit(ssm.gp.replace(params=params)))


def _headline_exp(dtype, device):
    from safe_exploration_tpu_torch.runtime.config import (
        ExperimentConfig,
        build_experiment,
    )

    cfg = ExperimentConfig(solver="sqp", n_safe=5, n_max=N_PATH, sqp_outer=14,
                           sqp_inner=3, sqp_polish=6, sqp_rescue=4)
    return build_experiment(cfg, dtype=dtype, device=device)


def _time_rollout(exp, ssm, x0, warm, dev) -> dict:
    """Host-clock time of one packed tube rollout and of its linearization
    (what every Gauss-Newton and polish step pays) at the path's shapes."""
    from safe_exploration_tpu_torch.solvers import sqp_lanes as sl

    cfg, k_fb, a, b = sl.SqpConfig(n_safe=5), exp["k_fb"], exp["a"], exp["b"]
    s_lift = torch.cat([torch.eye(2, dtype=x0.dtype, device=x0.device),
                        k_fb], 0)
    bmat = s_lift.T @ s_lift
    u = torch.movedim(warm.reshape(x0.shape[0], -1), 0, -1).contiguous()

    def roll(v, k=1):
        return sl._rollout_y_lanes(ssm, v, x0.T.repeat(1, k), k_fb, a, b, cfg,
                                   bmat)

    def linearize():
        return roll(u), sl._lane_jacobian(roll, u, roll(u).shape[0])

    out = {}
    for key, fn in (("rollout_ms", lambda: roll(u)),
                    ("linearize_ms", linearize)):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        _sync(dev)
        out[key] = (time.perf_counter() - t0) / 3 * 1e3
    return out


def _sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def _violations(exp, x: torch.Tensor) -> int:
    spec = exp["env"].spec
    return int(((x @ spec.h_mat_obs.T) > spec.h_obs).any(dim=1).sum())


def _refit_wrappers():
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        rbf_gram_masked,
        solve_psd,
        tri_inv_lower,
    )

    return (rbf_gram_masked, cholesky_blocked, solve_psd, tri_inv_lower)


def phase_path(seed: int, batch: int = 512, dev: str = "cuda") -> dict:
    from safe_exploration_tpu_torch.envs import env_step
    from safe_exploration_tpu_torch.models import gp_refit, ssm_bucketed, ssm_update
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS

    dtype = torch.float32
    rng = np.random.default_rng(seed)
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    exp = _headline_exp(dtype, dev)
    xs, us, resid = _make_data(rng, 64, dtype, dev, exp)
    ssm = _bench_ssm(exp, xs, us, resid, dtype, dev)
    _sync(dev)
    t0 = time.perf_counter()
    gp_refit(ssm.gp)
    _sync(dev)
    refit_ms = (time.perf_counter() - t0) * 1e3
    plan = ssm_bucketed(ssm)
    x0 = torch.tensor(rng.uniform(-1.0, 1.0, (batch, 2)) * [0.15, 0.4],
                      dtype=dtype, device=dev)
    state = exp["init_state_batch"](batch)

    t0 = time.perf_counter()
    u1, state, info1 = exp["get_action_batch"](state, plan, x0)
    _sync(dev)
    t_first = time.perf_counter() - t0
    _, x1 = env_step(exp["env"], x0, u1,
                     noise=torch.tensor(rng.standard_normal((batch, 2)),
                                        dtype=dtype, device=dev))
    k_new = 8
    resid1 = x1[:k_new] - (x0[:k_new] @ exp["a"].T + u1[:k_new] @ exp["b"].T)
    ssm = ssm_update(ssm, x0[:k_new], u1[:k_new], resid1)
    plan = ssm_bucketed(ssm)
    _sync(dev)
    t0 = time.perf_counter()
    u2, state, info2 = exp["get_action_batch"](state, plan, x1)
    _sync(dev)
    t_second = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in _refit_wrappers()}
    _, x2 = env_step(exp["env"], x1, u2,
                     noise=torch.tensor(rng.standard_normal((batch, 2)),
                                        dtype=dtype, device=dev))

    res_split = _time_rollout(exp, plan, x1, info2["warm_next"], dev)

    feas = [float(i["feasible"].float().mean()) for i in (info1, info2)]
    viol = _violations(exp, x1) + _violations(exp, x2)
    outs = [u1, u2, x1, x2, info1["warm_next"], info2["warm_next"],
            info1["cost"], info2["cost"], *(getattr(state, f.name) for f in
                                            state.__dataclass_fields__.values())]
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    res = {
        "feasible_frac": feas,
        "solves_per_s": batch / t_second,
        "first_call_s": t_first,
        "second_call_s": t_second,
        "refit_ms": refit_ms,
        "violations": viol,
        "finite": finite,
        "launches": launches,
        "n_points_after_update": int(ssm.gp.mask.sum()),
        **res_split,
    }
    print(f"[path] one tube rollout at B={batch}: plain "
          f"{res_split['rollout_ms']:.1f} ms, linearized (rollout + lane "
          f"Jacobian) {res_split['linearize_ms']:.1f} ms", flush=True)
    print(f"[path] B={batch} H=5 f32: feasible_frac per step {feas}, "
          f"solves/s {res['solves_per_s']:.2f} (second call {t_second:.2f} s; "
          f"first {t_first:.2f} s), refit {refit_ms:.3f} ms, violations {viol}, "
          f"finite {finite}, launches {launches}", flush=True)
    if not finite:
        _fail("non-finite output on the path")
    if viol:
        _fail(f"{viol} state-constraint violations")
    if min(feas) < 0.85:
        _fail(f"feasible_frac {feas} below 0.85")
    for name, count in launches.items():
        if count == 0:
            _fail(f"kernel {name} was not launched on the path")
    return res


def phase_parity(seed: int, batch: int = 16) -> dict:
    """f64 at B=16: refit factors and the first get_action_batch on the GPU
    (kernels) against the CPU (plain versions)."""
    dtype = torch.float64
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(seed + 1)
        exp = _headline_exp(dtype, dev)
        xs, us, resid = _make_data(rng, 64, dtype, dev, exp)
        from safe_exploration_tpu_torch.models import ssm_bucketed

        ssm = _bench_ssm(exp, xs, us, resid, dtype, dev)
        x0 = torch.tensor(rng.uniform(-1.0, 1.0, (batch, 2)) * [0.15, 0.4],
                          dtype=dtype, device=dev)
        state = exp["init_state_batch"](batch)
        t0 = time.perf_counter()
        u, _, info = exp["get_action_batch"](state, ssm_bucketed(ssm), x0)
        out[dev] = dict(gp=ssm.gp, u=u, info=info,
                        s=time.perf_counter() - t0)
    g, c = out["cuda"], out["cpu"]
    factors = {f: _rel(getattr(g["gp"], f), getattr(c["gp"], f))
               for f in ("chol", "beta", "kinv")}
    feas_equal = bool(torch.equal(g["info"]["feasible"].cpu(),
                                  c["info"]["feasible"]))
    kff = _rel(g["info"]["warm_next"], c["info"]["warm_next"])
    res = {"factors_rel": factors, "feasible_equal": feas_equal,
           "k_ff_rel": kff, "gpu_s": g["s"], "cpu_s": c["s"],
           "feasible_frac": float(c["info"]["feasible"].double().mean())}
    print(f"[parity] f64 B={batch}: factors rel {factors}, feasible equal "
          f"{feas_equal} (frac {res['feasible_frac']}), k_ff rel {kff:.2e} "
          f"(GPU {g['s']:.1f} s, CPU {c['s']:.1f} s)", flush=True)
    if max(factors.values()) > 1e-9:
        _fail(f"refit factors differ GPU vs CPU: {factors}")
    if not feas_equal:
        _fail("feasible flags differ GPU vs CPU")
    if kff > 1e-4:
        _fail(f"k_ff differs GPU vs CPU: {kff}")
    return res


def _cem_model(seed: int, n: int, z_scale: bool) -> dict:
    """A pendulum GP-SSM with n_max n and n - 7 points and bench.py's
    hyperparameters (log_sf -3, log_noise -4), built in f64 on the CPU and
    handed over as numpy arrays."""
    from safe_exploration_tpu_torch.models import gp_refit, make_gp_ssm
    from safe_exploration_tpu_torch.models.convert import gpssm_to_numpy

    rng = np.random.default_rng(seed)
    k = n - 7
    x = torch.tensor(rng.uniform(-1.0, 1.0, (k, 2)) * [0.3, 1.0])
    u = torch.tensor(rng.uniform(-1.0, 1.0, (k, 1)))
    w = torch.tensor(rng.normal(size=(3, 2)))
    y = 0.02 * torch.sin(3.0 * torch.cat([x, u], 1) @ w)
    def full(v):
        return torch.full((2,), v, dtype=torch.float64)

    ssm = make_gp_ssm(("rbf", "rbf"), x, u, y, n_max=n, l_mu=full(0.05),
                      l_sigma=full(0.02), log_noise=-4.0,
                      z_scale=(torch.tensor([0.5, 2.0, 1.0], dtype=torch.float64)
                               if z_scale else None))
    params = tuple({**p, "log_sf": torch.tensor(-3.0, dtype=torch.float64)}
                   for p in ssm.gp.params)
    return gpssm_to_numpy(ssm.replace(gp=gp_refit(ssm.gp.replace(
        params=params))))


def _cem_plant(dtype, device):
    """(k_fb, a, b, bmat) and the polytopes of the pendulum, and its target."""
    from safe_exploration_tpu_torch.envs import linearize_discretize, make_pendulum
    from safe_exploration_tpu_torch.ops.linalg import dlqr

    env = make_pendulum(dtype=dtype, device=device)
    a, b = linearize_discretize(env)
    eye = torch.eye(2, dtype=dtype, device=device)
    k_fb = -dlqr(a, b, eye, torch.eye(1, dtype=dtype, device=device))[0]
    s_lift = torch.cat([eye, k_fb], 0)
    spec = env.spec
    return ([k_fb, a, b, s_lift.T @ s_lift],
            [spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe],
            spec.target)


def _gp_prep_ops(n: int, e: int = E, d: int = D_IN) -> int:
    """Operations of the posterior made once per call: the scaled support
    rows x/ls and c_j = log sf2 - |x_j/ls|^2 / 2 (3 d + 2 per row and dim)."""
    return e * n * (3 * d + 2)


def _gp_lane_ops(n: int, jac: bool, d: int = D_IN) -> int:
    """Operations of the posterior per lane and output dim, counted as the
    least the function needs (an FMA is 2, an add, multiply, divide, sqrt,
    exp or compare 1): z' = z/ls and |z'|^2 / 2 (3 d + 1); per support row
    the exponent c_j - |z'|^2 / 2 + x_j/ls . z' and its exp (2 d + 2); the
    mean (2 n); the quadratic form k^T K^-1 k on the symmetric K^-1, one
    FMA per entry of its lower triangle with the off-diagonal sum doubled
    (n^2 + 3 n), and the floor (2); with the Jacobian, X^T (kv w) -
    z sum(kv w) over ls^2 (2 n d + 3 d)."""
    return (n * n + n * (2 * d + 7) + 3 * d + 3
            + (2 * n * d + 3 * d if jac else 0))


def _tube_ops(t_len: int, m_obs: int, m_safe: int) -> int:
    """Operations of the n_s = 2, n_u = 1 tube per lane, past the posterior,
    with the tracking cost, counted as in :func:`_gp_lane_ops` on symmetric
    2x2 shapes: the point step (12) and Q_0 = 2 c^2 (var + noise) (4); per
    ellipsoid stage the next centre (12), H = a + J_x + (b + J_u) k (14),
    H Q H^T (21), the closed-form lambda_max(Q S^T S) and its root (18), the
    remainder radii (12) and the two diagonal Minkowski sums (40); per
    polytope row its margin added into viol (14); the cost (8 T + 5)."""
    return (16 + 117 * (t_len - 1) + 14 * (t_len * m_obs + m_safe)
            + 8 * t_len + 5)


def phase_cem_kernels(seed: int) -> dict:
    """gp_predict (its prepared call against the plain version on the same
    prepared posterior) and cem_score against their plain versions at every
    shape, dtype and option, then times at the CEM path's shapes (f32)."""
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.ops.kernels import (
        gp_predict_prepared,
        posterior_plain,
        prepare_posterior,
        prepare_tube_score,
        tube_score_lanes,
        tube_score_plain,
        tube_score_prepared,
    )
    from safe_exploration_tpu_torch.solvers.sqp_lanes import _gp_predict_lanes

    rng = np.random.default_rng(seed + 10)
    consts, polys, target = _cem_plant(torch.float64, "cuda")

    def gp_ssm(arr, dtype):
        return gpssm_from_numpy(arr, ("rbf", "rbf"), device="cuda",
                                dtype=dtype)

    def score_args(arr, u, x0, dtype, kind):
        ssm = gpssm_from_numpy(arr, ("rbf", "rbf"), device="cuda", dtype=dtype)
        t = {"dtype": dtype, "device": "cuda"}
        return (ssm, torch.tensor(u, **t), torch.tensor(x0, **t), *consts,
                *polys, 2.0, u.shape[0], kind,
                {"target": target} if kind == "tracking" else {})

    def up64(arr):
        """The f32-rounded model as f64 values: the plain result the f32
        kernel is held to is computed from the same inputs."""
        def rnd(v):
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                return v.astype(np.float32).astype(np.float64)
            return v

        return {**{k: rnd(v) for k, v in arr.items()},
                "params": [{k: rnd(v) for k, v in p.items()}
                           for p in arr["params"]]}

    worst = {"gp_predict": 0.0, "cem_score": 0.0}
    # bench_cem_solves' shape (n_max 64, H 5) and pendulum_batch's (128, 3)
    for n, horizon in ((N_CEM, H_CEM), (128, 3)):
        for z_scale in (True, False):
            arr = _cem_model(seed + n, n, z_scale)
            for L in (M_CEM * B_CEM, 1000):
                zz = rng.uniform(-1.0, 1.0, (D_IN, L))
                u = 0.4 * rng.standard_normal((horizon, L))
                x0 = rng.uniform(-1.0, 1.0, (2, L)) * np.array([[0.15], [0.4]])
                for dtype in (torch.float32, torch.float64):
                    f64 = dtype == torch.float64
                    post = prepare_posterior(gp_ssm(arr, dtype))
                    z = torch.tensor(zz, dtype=dtype, device="cuda")
                    errs = []
                    for jac in (False, True):
                        out = gp_predict_prepared(post, z, want_jac=jac)
                        ref = posterior_plain(post, z, want_jac=jac)
                        errs.append(max(_rel(o, r) for o, r in zip(out, ref)))
                    e_gp = max(errs)
                    e_cs = 0.0
                    for kind in ("tracking", "exploration"):
                        out = tube_score_lanes(*score_args(arr, u, x0, dtype,
                                                           kind))
                        ref = tube_score_plain(*score_args(
                            arr if f64 else up64(arr), u.astype(np.float32)
                            if not f64 else u, x0.astype(np.float32)
                            if not f64 else x0, torch.float64, kind))
                        e_cs = max(e_cs, *(_rel(o, r) for o, r in zip(out, ref)))
                    tol_gp, tol_cs = (1e-10, 1e-10) if f64 else (3e-5, 2e-4)
                    print(f"[cem-kernels] {str(dtype)[6:]} n={n} H={horizon} "
                          f"L={L} z_scale={z_scale}: gp_predict rel "
                          f"{e_gp:.2e} (tol {tol_gp:g}), cem_score rel "
                          f"{e_cs:.2e} (tol "
                          f"{tol_cs:g})", flush=True)
                    if e_gp > tol_gp or e_cs > tol_cs:
                        _fail(f"CEM kernel disagrees with plain at {dtype} n={n}"
                              f" L={L} z_scale={z_scale}")
                    if not f64:
                        worst["gp_predict"] = max(worst["gp_predict"], e_gp)
                        worst["cem_score"] = max(worst["cem_score"], e_cs)

    # times and max_abs_err at the path's shapes, f32: the final B-lane
    # passes call gp_predict at L = B with the Jacobian ("pallas" runs it at
    # L = M B), on the posterior prepared once per solve; every CEM
    # iteration calls cem_score at L = M B
    dt, sz = torch.float32, 4
    arr = _cem_model(seed, N_CEM, False)
    timings, abs_err = {}, {}
    for L in (B_CEM, M_CEM * B_CEM):
        ssm = gp_ssm(arr, dt)
        post = prepare_posterior(ssm)
        z = torch.tensor(rng.uniform(-1.0, 1.0, (D_IN, L)), dtype=dt,
                         device="cuda")
        out = gp_predict_prepared(post, z, want_jac=True)
        ref = posterior_plain(post, z, want_jac=True)
        if L == B_CEM:
            abs_err["gp_predict"] = max(_abs(o, r) for o, r in zip(out, ref))
        n_bytes = sz * (N_CEM * D_IN + E * N_CEM + E * N_CEM ** 2
                        + E * (D_IN + 1) + D_IN * L + 2 * E * L + E * D_IN * L)
        ops = _gp_prep_ops(N_CEM) + E * L * _gp_lane_ops(N_CEM, True)
        r = dict(
            ms=_time_ms(lambda: gp_predict_prepared(post, z, want_jac=True),
                        20),
            prepare_ms=_time_ms(lambda: prepare_posterior(ssm), 20),
            unprepared_ms=_time_ms(lambda: _gp_predict_lanes(
                ssm, z, want_jac=True, impl="pallas"), 20),
            plain_ms=_time_ms(lambda: posterior_plain(post, z, want_jac=True),
                              5),
            library_ms=None, bound=_bound_ms(n_bytes, ops, dt))
        r["device_ms"], r["device_ms_by_kernel"] = _device_ms(
            lambda: gp_predict_prepared(post, z, want_jac=True))
        timings[f"gp_predict_L{L}"] = r
    L = M_CEM * B_CEM
    u = 0.4 * rng.standard_normal((H_CEM, L)).astype(np.float32)
    x0 = (rng.uniform(-1.0, 1.0, (2, L)) * [[0.15], [0.4]]).astype(np.float32)
    args = score_args(arr, u, x0, dt, "tracking")
    # the path's call: the model prepared once per solve (prepare_tube_score),
    # then scored; tube_score_lanes prepares on every call
    prep = prepare_tube_score(args[0], *args[3:])
    out = tube_score_prepared(prep, *args[1:3])
    ref = tube_score_plain(*score_args(up64(arr), u, x0, torch.float64,
                                       "tracking"))
    abs_err["cem_score"] = max(_abs(o, r) for o, r in zip(out, ref))
    ops = (_gp_prep_ops(N_CEM) + E * L * (_gp_lane_ops(N_CEM, False) + (
        H_CEM - 1) * _gp_lane_ops(N_CEM, True))
        + L * _tube_ops(H_CEM, len(polys[1]), len(polys[3])))
    n_bytes = sz * (N_CEM * D_IN + E * N_CEM + E * N_CEM ** 2
                    + (H_CEM + 2) * L + 2 * L)
    timings["cem_score"] = dict(
        ms=_time_ms(lambda: tube_score_prepared(prep, *args[1:3]), 20),
        unprepared_ms=_time_ms(lambda: tube_score_lanes(*args), 20),
        prepare_ms=_time_ms(lambda: prepare_tube_score(args[0], *args[3:]),
                            20),
        plain_ms=_time_ms(lambda: tube_score_plain(*args), 3),
        library_ms=None, bound=_bound_ms(n_bytes, ops, dt))
    (timings["cem_score"]["device_ms"],
     timings["cem_score"]["device_ms_by_kernel"]) = _device_ms(
        lambda: tube_score_prepared(prep, *args[1:3]))
    quad = _quad_gp_predict(rng, seed)
    abs_err["gp_predict_quadrotor"] = quad.pop("max_abs_err")
    worst["gp_predict_quadrotor"] = quad.pop("worst_rel_f32")
    timings["gp_predict_quadrotor"] = quad
    for name, r in timings.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        extra = (f" (device {r['device_ms']:.4f}: "
                 f"{ {k: round(v, 4) for k, v in r['device_ms_by_kernel'].items()} }"
                 f"; without a prepared object {r['unprepared_ms']:.4f} ms"
                 f", the prepare alone {r['prepare_ms']:.4f} ms)")
        print(f"[cem-kernels] time f32 {r.get('shape', f'n={N_CEM}')} {name}: "
              f"kernel {r['ms']:.4f} "
              f"ms{extra}, plain {r['plain_ms']:.4f} ms, library null (no one "
              f"PyTorch call computes it), bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})", flush=True)
    return {"worst_rel_f32": worst, "errs": abs_err, "timings": timings}


# quadrotor_episode's lane CEM (``--set cem_backend=lanes``, the batched
# planner at the quadrotor): B instances of M = 256 samples score on one
# lane axis; its posterior is a 6-output GP over d = 8 inputs (gp_lanes.cuh's
# DMAX) at n_max 512, with the mean Jacobian for the tube and the perf
# trajectory's covariance recursion
B_QCEM, M_QCEM, N_QEP = 64, 256, 512


def _quad_model(seed: int, n: int, k: int) -> dict:
    """A quadrotor GP-SSM (6 outputs over the 6 states and 2 thrusts, the
    env's input normalization, log noise -4.5 as quadrotor_batch_sqp) with
    n_max n and k points spread over the operating box, built in f64 on the
    CPU and handed over as numpy arrays."""
    from safe_exploration_tpu_torch.envs import make_quadrotor
    from safe_exploration_tpu_torch.models import make_gp_ssm
    from safe_exploration_tpu_torch.models.convert import gpssm_to_numpy

    spec = make_quadrotor(dtype=torch.float64, device="cpu").spec
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1.0, 1.0, (k, 6))) * spec.norm_x
    u = torch.tensor(rng.uniform(-1.0, 1.0, (k, 2))) * spec.norm_u
    w = torch.tensor(rng.normal(size=(8, 6)))
    z = torch.cat([x / spec.norm_x, u / spec.norm_u], 1)
    y = 0.01 * torch.sin(2.0 * z @ w)
    full = torch.full((6,), 0.05, dtype=torch.float64)
    ssm = make_gp_ssm(("rbf",) * 6, x, u, y, n_max=n, l_mu=full,
                      l_sigma=0.4 * full, log_noise=-4.5,
                      z_scale=torch.cat([spec.norm_x, spec.norm_u]))
    return gpssm_to_numpy(ssm)


def _quad_gp_predict(rng, seed: int) -> dict:
    """gp_predict at the quadrotor's shapes (e 6, d 8 = DMAX, n 512) against
    its plain version on the same prepared posterior, with and without the
    Jacobian, in f32 (the n <= 128 checks' 3e-5 scaled by n / 128) and f64
    (1e-10), at the wide scoring pass's L = M B = 16,384, a ragged 1,000
    and the final passes' B = 64; then the f32 times with the Jacobian at
    L = 16,384: CUDA-event ms of the prepared call, the plain version's,
    the bound at the least work, device ms."""
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.ops.kernels import (
        gp_predict_prepared,
        posterior_plain,
        prepare_posterior,
    )

    from safe_exploration_tpu_torch.solvers.sqp_lanes import _gp_predict_lanes

    e, d, n, wide = 6, 8, N_QEP, M_QCEM * B_QCEM
    arr = _quad_model(seed + 5, n, n - 12)
    # queries over the operating box in raw coordinates (the env's norm_x,
    # norm_u)
    box = np.array([0.75, 1.2, 0.75, 1.2, 0.45, 2.25, 1.5, 1.5])[:, None]
    worst, out = 0.0, {}
    for L in (wide, 1000, B_QCEM):
        zz = rng.uniform(-1.0, 1.0, (d, L)) * box
        for dtype in (torch.float32, torch.float64):
            post = prepare_posterior(gpssm_from_numpy(
                arr, ("rbf",) * e, device="cuda", dtype=dtype))
            z = torch.tensor(zz, dtype=dtype, device="cuda")
            errs, abs_errs = [], []
            for jac in (False, True):
                got = gp_predict_prepared(post, z, want_jac=jac)
                ref = posterior_plain(post, z, want_jac=jac)
                errs.append(max(_rel(o, r) for o, r in zip(got, ref)))
                abs_errs.append(max(_abs(o, r) for o, r in zip(got, ref)))
            f64 = dtype == torch.float64
            # the f32 tolerance of the n <= 128 checks above, scaled by the
            # n-term sums' length (their f32 rounding grows with n)
            tol = 1e-10 if f64 else 3e-5 * n / 128
            print(f"[cem-kernels] {str(dtype)[6:]} quadrotor e={e} d={d} "
                  f"n={n} L={L}: gp_predict rel {max(errs):.2e} without / "
                  f"with the Jacobian {errs} (tol {tol:g})", flush=True)
            if max(errs) > tol:
                _fail(f"gp_predict disagrees with plain at {dtype} e={e} "
                      f"d={d} n={n} L={L}: {errs}")
            if not f64:
                worst = max(worst, max(errs))
                if L == wide:
                    out["max_abs_err"] = abs_errs[1]
    dt, sz = torch.float32, 4
    ssm = gpssm_from_numpy(arr, ("rbf",) * e, device="cuda", dtype=dt)
    post = prepare_posterior(ssm)
    z = torch.tensor(rng.uniform(-1.0, 1.0, (d, wide)) * box, dtype=dt,
                     device="cuda")
    n_bytes = sz * (n * d + e * n + e * n * n + e * (d + 1) + d * wide
                    + 2 * e * wide + e * d * wide)
    ops = _gp_prep_ops(n, e, d) + e * wide * _gp_lane_ops(n, True, d)
    out.update(
        shape=f"quadrotor e={e} d={d} n={n} L={wide}",
        ms=_time_ms(lambda: gp_predict_prepared(post, z, want_jac=True), 20),
        plain_ms=_time_ms(lambda: posterior_plain(post, z, want_jac=True), 3),
        prepare_ms=_time_ms(lambda: prepare_posterior(ssm), 20),
        unprepared_ms=_time_ms(lambda: _gp_predict_lanes(
            ssm, z, want_jac=True, impl="pallas"), 20),
        library_ms=None, bound=_bound_ms(n_bytes, ops, dt), worst_rel_f32=worst)
    out["device_ms"], out["device_ms_by_kernel"] = _device_ms(
        lambda: gp_predict_prepared(post, z, want_jac=True))
    return out


def _cem_exp(dtype, dev, gp_impl="auto"):
    from safe_exploration_tpu_torch.runtime.config import (
        ExperimentConfig,
        build_experiment,
    )

    cfg = ExperimentConfig(solver="cem", n_safe=H_CEM, n_max=N_CEM,
                           cem_samples=M_CEM, cem_elites=12, cem_iterations=4,
                           cem_gp_impl=gp_impl)
    return build_experiment(cfg, dtype=dtype, device=dev)


def _cem_path_wrappers():
    """The kernels the CEM path runs: all but the large-matrix Cholesky
    (its n_max 64 refits take cholesky_blocked) and the general-m trsm
    (the refit takes solve_psd and tri_inv_lower)."""
    from safe_exploration_tpu_torch.ops.kernels import (
        KERNEL_WRAPPERS,
        cholesky_hbm,
        trsm_lower,
    )

    return [w for w in KERNEL_WRAPPERS if w not in (cholesky_hbm, trsm_lower)]


def phase_cem_path(seed: int, batch: int = B_CEM, dev: str = "cuda") -> dict:
    """The lane CEM end to end, then the cem_gp_impl A/B in one process."""
    from safe_exploration_tpu_torch.envs import env_step
    from safe_exploration_tpu_torch.models import ssm_bucketed, ssm_update
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS

    dtype = torch.float32
    rng = np.random.default_rng(seed + 2)
    exp = _cem_exp(dtype, dev)
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    xs, us, resid = _make_data(rng, 48, dtype, dev, exp)
    ssm = _bench_ssm(exp, xs, us, resid, dtype, dev, n_max=N_CEM)
    plan0 = ssm_bucketed(ssm)
    x0 = torch.tensor(rng.uniform(-1.0, 1.0, (batch, 2)) * [0.15, 0.4],
                      dtype=dtype, device=dev)
    noise = [torch.tensor(rng.standard_normal((batch, 2)), dtype=dtype,
                          device=dev) for _ in range(2)]
    state = exp["init_state_batch"](batch)
    _sync(dev)
    t0 = time.perf_counter()
    u1, state, info1 = exp["get_action_batch"](state, plan0, x0)
    _sync(dev)
    t_first = time.perf_counter() - t0
    _, x1 = env_step(exp["env"], x0, u1, noise=noise[0])
    k_new = 8
    resid1 = x1[:k_new] - (x0[:k_new] @ exp["a"].T + u1[:k_new] @ exp["b"].T)
    ssm = ssm_update(ssm, x0[:k_new], u1[:k_new], resid1)
    plan = ssm_bucketed(ssm)
    _sync(dev)
    t0 = time.perf_counter()
    u2, state, info2 = exp["get_action_batch"](state, plan, x1)
    _sync(dev)
    t_second = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in _cem_path_wrappers()}
    _, x2 = env_step(exp["env"], x1, u2, noise=noise[1])
    feas = [float(i["feasible"].float().mean()) for i in (info1, info2)]
    viol = _violations(exp, x1) + _violations(exp, x2)
    outs = [u1, u2, x1, x2, info1["warm_next"], info2["warm_next"],
            info1["cost"], info2["cost"], info1["violation"],
            info2["violation"], info1["p_traj"], info2["p_traj"]]
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    print(f"[cem] B={batch} M={M_CEM} H={H_CEM} f32 auto: feasible_frac per "
          f"step {feas} (the JAX package records {CEM_FEAS_JAX} on its own "
          f"draws), solves/s {batch / t_second:.1f} (second call "
          f"{t_second * 1e3:.1f} ms; first {t_first * 1e3:.1f} ms), violations "
          f"{viol}, finite {finite}, launches {launches}", flush=True)
    if not finite:
        _fail("non-finite output on the CEM path")
    if viol:
        _fail(f"{viol} state-constraint violations on the CEM path")
    for name, count in launches.items():
        if count == 0:
            _fail(f"kernel {name} was not launched on the CEM path")

    # the cem_gp_impl A/B: the first step again, per impl, in turns
    exps = {impl: _cem_exp(dtype, dev, impl) for impl in ("auto", "pallas",
                                                           "xla")}
    ab = {impl: {"s": []} for impl in exps}
    for impl in ("auto", "pallas", "xla", "xla", "pallas", "auto"):
        e = exps[impl]
        for w in KERNEL_WRAPPERS:
            w.launches = 0
        st = e["init_state_batch"](batch)
        _sync(dev)
        t0 = time.perf_counter()
        u, _, info = e["get_action_batch"](st, plan0, x0)
        _sync(dev)
        r = ab[impl]
        r["s"].append(time.perf_counter() - t0)
        r["launches"] = {w.__name__: w.launches for w in _cem_path_wrappers()}
        r["flags"] = info["feasible"].cpu()
        _, xn = env_step(e["env"], x0, u, noise=noise[0])
        r["violations"] = _violations(e, xn)
        r["finite"] = bool(torch.isfinite(u).all())
    for impl, r in ab.items():
        r["solves_per_s"] = batch / float(np.median(r["s"]))
        r["feasible_frac"] = float(r["flags"].float().mean())
        print(f"[cem] A/B {impl}: solves/s {r['solves_per_s']:.1f} (solve s "
              f"{[round(x, 4) for x in r['s']]}), feasible_frac "
              f"{r['feasible_frac']:.4f}, violations {r['violations']}, "
              f"launches {r['launches']}", flush=True)
        if r["violations"] or not r["finite"]:
            _fail(f"cem_gp_impl={impl}: violations or non-finite controls")
    split = _cem_split(exps["auto"], plan0, x0, batch, dev)
    agree = int((ab["auto"]["flags"] == ab["xla"]["flags"]).sum())
    for r in ab.values():
        del r["flags"]
    print(f"[cem] auto vs xla feasible flags agree on {agree} of {batch} lanes "
          f"(gate {int(np.ceil(0.95 * batch))})", flush=True)
    if agree < 0.95 * batch:
        _fail(f"auto and xla feasible flags agree on only {agree} lanes")
    return {"feasible_frac": feas, "solves_per_s": batch / t_second,
            "first_call_s": t_first, "second_call_s": t_second,
            "violations": viol, "finite": finite, "launches": launches,
            "feasible_frac_jax_recorded": CEM_FEAS_JAX, "ab": ab,
            "auto_xla_flags_agree": agree, **split}


def _cem_split(exp, plan, x0, batch, dev, label: str = "cem") -> dict:
    """Where an "auto" solve's time goes: the host time of one final B-lane
    scoring pass (tube rollout through gp_predict, margins, cost; a solve
    runs two), and the device's busy share over one solve from
    torch.profiler's per-kernel device times."""
    from safe_exploration_tpu_torch.ops.kernels import prepare_posterior
    from safe_exploration_tpu_torch.solvers import sqp_lanes as sl
    from safe_exploration_tpu_torch.solvers.cem_lanes import _TubeCfg

    k_fb, a, b = (exp[k] for k in ("k_fb", "a", "b"))
    s_lift = torch.cat([torch.eye(2, dtype=x0.dtype, device=dev), k_fb])
    bmat = s_lift.T @ s_lift
    spec = exp["env"].spec
    polys = (spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe)
    u = torch.zeros((H_CEM, batch), dtype=x0.dtype, device=dev)
    x0_cols = x0.T.contiguous()
    post = prepare_posterior(plan)

    def final_pass():
        y = sl._rollout_y_lanes(plan, u, x0_cols, k_fb, a, b,
                                _TubeCfg(H_CEM, exp["cfg"].c_safety, 0), bmat,
                                impl="pallas", post=post)
        sl._dist_lanes(y, H_CEM, 2, *polys)
        sl._cost_lanes("tracking", {"target": spec.target}, y, u,
                       H_CEM, 2, 1)

    final_pass()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        final_pass()
    _sync(dev)
    pass_ms = (time.perf_counter() - t0) / 3 * 1e3

    warm = torch.zeros((batch, H_CEM, 1), dtype=x0.dtype, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        exp["batch_planner"](plan, x0, warm)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host operator's self device time repeats
    # its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    # device ms per launch of the two kernels (the wrappers' CUDA-event times
    # in the kernels phase also hold their host-side argument preparation)
    per_launch = {
        name: sum(getattr(e, "self_device_time_total", 0.0) for e in events
                  if f"{name}_kernel" in e.key) / 1e3 / max(1, sum(
                      e.count for e in events if f"{name}_kernel" in e.key))
        for name in ("cem_score", "gp_predict")}
    busy = device_ms / wall_ms
    print(f"[{label}] where an auto solve's time goes: one final B-lane scoring "
          f"pass {pass_ms:.2f} ms (a solve runs two); under the profiler the "
          f"solve took {wall_ms:.2f} ms with {device_ms:.3f} ms of device time "
          f"(busy share {busy:.3f}, idle {1 - busy:.3f}); device ms per "
          f"launch {per_launch}", flush=True)
    return {"final_pass_ms": pass_ms, "profiled_solve_ms": wall_ms,
            "device_ms": device_ms, "device_busy_share": busy,
            "device_ms_per_launch": per_launch}


def phase_cem_parity(seed: int, batch: int = 16) -> dict:
    """f64, B=16: one get_action_batch of the lane CEM on the GPU (kernels)
    and on the CPU (plain versions), both with the draws of one seeded CPU
    generator."""
    from functools import partial

    from safe_exploration_tpu_torch.models import ssm_bucketed
    from safe_exploration_tpu_torch.solvers.safempc import (
        SafeMPCConfig,
        make_safempc_batch,
    )

    dtype = torch.float64
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(seed + 3)
        exp = _cem_exp(dtype, dev)
        xs, us, resid = _make_data(rng, 48, dtype, dev, exp)
        ssm = _bench_ssm(exp, xs, us, resid, dtype, dev, n_max=N_CEM)
        x0 = torch.tensor(rng.uniform(-1.0, 1.0, (batch, 2)) * [0.15, 0.4],
                          dtype=dtype, device=dev)
        gen = torch.Generator().manual_seed(seed)
        init, step = make_safempc_batch(
            exp["env"], SafeMPCConfig(n_safe=H_CEM, c_safety=exp["cfg"].c_safety),
            partial(exp["batch_planner"], generator=gen), warm_len=H_CEM)
        t0 = time.perf_counter()
        u, _, info = step(init(batch), ssm_bucketed(ssm), x0)
        out[dev] = dict(u=u, info=info, s=time.perf_counter() - t0)
    g, c = out["cuda"], out["cpu"]
    feas_equal = bool(torch.equal(g["info"]["feasible"].cpu(),
                                  c["info"]["feasible"]))
    warm = _rel(g["info"]["warm_next"], c["info"]["warm_next"])
    u_rel = _rel(g["u"], c["u"])
    res = {"feasible_equal": feas_equal, "warm_next_rel": warm, "u_rel": u_rel,
           "feasible_frac": float(c["info"]["feasible"].double().mean()),
           "gpu_s": g["s"], "cpu_s": c["s"]}
    print(f"[cem-parity] f64 B={batch}: feasible equal {feas_equal} (frac "
          f"{res['feasible_frac']}), warm_next rel {warm:.2e} (tol 1e-6), u rel "
          f"{u_rel:.2e} (GPU {g['s']:.2f} s, CPU {c['s']:.2f} s)", flush=True)
    if not feas_equal:
        _fail("CEM feasible flags differ GPU vs CPU")
    if warm > 1e-6:
        _fail(f"CEM warm_next differs GPU vs CPU: {warm}")
    return res


N_HBM = 2048   # n_max of the large-GP episodic run (b): the HBM tier's shape


def _spd_cuda(n: int, seed: int) -> torch.Tensor:
    """(E, n, n) f64 m m^T + n I on the card (the matrices of
    tests/test_pallas.py), from a seeded CUDA generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randn((E, n, n), generator=g, dtype=torch.float64,
                    device="cuda")
    return m @ m.mT + n * torch.eye(n, dtype=torch.float64, device="cuda")


def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    """|a - b| <= tol + tol |b| elementwise (the rtol = atol gate of
    tests/test_pallas.py for the f32 Pallas Cholesky)."""
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def _blocked_direct(a: torch.Tensor) -> torch.Tensor:
    """cholesky.cu called past its wrapper's n <= 1024 limit, for the
    crossover timing only."""
    from safe_exploration_tpu_torch.ops.kernels import _build
    from safe_exploration_tpu_torch.ops.kernels._common import (
        INT, VP, is_f64, stream_ptr)

    n = a.shape[-1]
    out = torch.empty_like(a)
    fn = _build.load("cholesky", "cholesky_blocked", (VP, VP, INT, INT, INT,
                                                      VP))
    code = fn(a.data_ptr(), out.data_ptr(), a.numel() // (n * n), n,
              is_f64(a), stream_ptr(a))
    if code:
        raise RuntimeError(f"cholesky_blocked: cudaError {code}")
    return out


def _device_ms(fn) -> tuple[float, dict]:
    """Device ms of one call of ``fn``, in all and per CUDA kernel (the
    kernel's name up to its template arguments), from torch.profiler's
    device-side events over 3 calls after a warm-up (not the host
    operators, whose self device time repeats their kernels'): a kernel's
    mean time per launch times its launches per call (its count over the
    3 calls, rounded), so an event the profiler drops does not count as a
    launch that took no time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].strip().split(" ")[-1]
        name = name.split("::")[-1] or e.key[:40]
        total[name] = total.get(name, 0.0) + e.self_device_time_total
        count[name] = count.get(name, 0) + e.count
    by = {k: total[k] / count[k] * max(1, round(count[k] / 3)) / 1e3
          for k in total if count[k]}
    return sum(by.values()), by


def phase_hbm_kernels(seed: int) -> dict:
    """cholesky_hbm against its plain version at n = 1300 (ragged), 2048 and
    4096 with e = 2 in f32 (within 3e-4 of the f64 plain factor) and f64
    (1e-9); NaN on an indefinite input; CUDA-event times of the kernel, its
    plain version, cholesky_ex and cholesky_blocked (called directly) at
    1024, 2048 and 4096; trsm's entries against their plain versions at run
    (b)'s refit shape n = 2048: tri_inv_lower (K^-1), solve_psd (beta, m =
    1) and trsm_lower at m = 1 and m = n."""
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        cholesky_hbm,
        cholesky_hbm_plain,
        solve_psd,
        tri_inv_lower,
        trsm_lower,
        trsm_plain,
    )

    res = {"checks": {}}
    for n in (1300, N_HBM, 4096):
        a64 = _spd_cuda(n, seed + n)
        ref = cholesky_hbm_plain(a64)
        for dtype in (torch.float32, torch.float64):
            l = cholesky_hbm(a64.to(dtype))
            upper_zero = bool((torch.triu(l, 1) == 0).all())
            if dtype == torch.float64:
                err = _rel(l, ref)
                ok = err <= 1e-9
                gate = "rel <= 1e-9"
            else:
                err = _abs(l, ref)
                ok = _close(l, ref, 3e-4)
                gate = "|d| <= 3e-4 + 3e-4 |ref|"
            res["checks"][f"{str(dtype)[6:]}_n{n}"] = err
            print(f"[hbm] {str(dtype)[6:]} e={E} n={n}: cholesky_hbm vs plain "
                  f"(f64) {err:.2e} ({gate}: {ok}), zeros above the diagonal "
                  f"{upper_zero}", flush=True)
            if not (ok and upper_zero):
                _fail(f"cholesky_hbm disagrees with plain at {dtype} n={n}")
            if dtype == torch.float32 and n == N_HBM:
                res["max_abs_err"] = err
    bad = _spd_cuda(1300, seed)
    bad[:, 700, 700] = -1.0
    nan_ok = True
    for dtype in (torch.float32, torch.float64):
        l = cholesky_hbm(bad.to(dtype))
        nan_ok &= bool(torch.isfinite(l[:, :700, :700]).all()) and bool(
            torch.isnan(l[:, 700:, 700]).all()) and bool(
            torch.isnan(l[:, -1, -1]).all())
    print(f"[hbm] indefinite input -> NaN from the bad pivot on, finite "
          f"before it (f32, f64): {nan_ok}", flush=True)
    if not nan_ok:
        _fail("cholesky_hbm does not give NaN on an indefinite input")

    # trsm's entries at the shape every run-(b) refit gives them
    l64 = cholesky_hbm_plain(_spd_cuda(N_HBM, seed + 1))
    eye = torch.eye(N_HBM, dtype=torch.float64, device="cuda").expand(
        E, N_HBM, N_HBM).contiguous()
    y = torch.randn((E, N_HBM, 1), dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    x_ref = trsm_plain(l64, eye)
    z_ref = trsm_plain(l64, y)
    refs = {"tri_inv_lower": x_ref, "trsm_lower_eye": x_ref,
            "solve_psd": trsm_plain(l64, z_ref, True), "trsm_lower_m1": z_ref,
            "trsm_lower_m1_t": trsm_plain(l64, y, True)}
    e_t = {}
    for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
        lt, yt = l64.to(dtype), y.to(dtype)
        linv = tri_inv_lower(lt)
        outs = {"tri_inv_lower": linv, "trsm_lower_eye": trsm_lower(
                    lt, eye.to(dtype)), "solve_psd": solve_psd(lt, yt),
                "trsm_lower_m1": trsm_lower(lt, yt),
                "trsm_lower_m1_t": trsm_lower(lt, yt, True)}
        errs_d = {k: _rel(v, refs[k]) for k, v in outs.items()}
        upper_zero = bool((torch.triu(linv, 1) == 0).all())
        e_t[str(dtype)[6:]] = errs_d
        if max(errs_d.values()) > tol or not upper_zero:
            _fail(f"trsm entries disagree with plain at {dtype} n={N_HBM}: "
                  f"{errs_d}, L^-1 zero above the diagonal {upper_zero}")
    print(f"[hbm] trsm entries at n={N_HBM} vs plain (f64): rel {e_t} (tol "
          f"f32 2e-4, f64 1e-10)", flush=True)
    res["trsm_2048_rel"] = e_t

    # crossover: cholesky_blocked (direct) against cholesky_hbm, with the
    # plain version and cholesky_ex beside them
    times = {}
    for n in (1024, N_HBM, 4096):
        for dtype in (torch.float32, torch.float64):
            a = _spd_cuda(n, seed + 2).to(dtype)
            sz = a.element_size()
            bound = _bound_ms(_square_from_tri_bytes(n, sz), E * n ** 3 / 3,
                              dtype)
            t = {"hbm_ms": _time_ms(lambda: cholesky_hbm(a), 10),
                 "blocked_ms": _time_ms(lambda: _blocked_direct(a), 10),
                 "library_ms": _time_ms(lambda: torch.linalg.cholesky_ex(a),
                                        10),
                 "plain_ms": _time_ms(lambda: cholesky_hbm_plain(a), 1),
                 "bound_ms": bound[0], "bound_by": bound[1]}
            t["hbm_device_ms"], t["hbm_device_ms_by_kernel"] = _device_ms(
                lambda: cholesky_hbm(a))
            if n == 1024:
                t["blocked_wrapper_ms"] = _time_ms(lambda: cholesky_blocked(a),
                                                   10)
            times[f"{str(dtype)[6:]}_n{n}"] = t
            print(f"[hbm] time {str(dtype)[6:]} e={E} n={n}: cholesky_hbm "
                  f"{t['hbm_ms']:.4f} ms (device {t['hbm_device_ms']:.4f}: "
                  f"{ {k: round(v, 4) for k, v in t['hbm_device_ms_by_kernel'].items()} }), "
                  f"cholesky_blocked {t['blocked_ms']:.4f} ms, cholesky_ex "
                  f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.2f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})",
                  flush=True)
    a = _spd_cuda(N_HBM, seed + 3).float()
    l = cholesky_hbm(a)
    t_trsm = _time_ms(lambda: trsm_lower(l, eye.float()), 5)
    print(f"[hbm] time f32 trsm_lower n=m={N_HBM} (general m, L^-1 against "
          f"the identity): {t_trsm:.3f} ms", flush=True)
    res["times"] = times
    res["trsm_2048_ms"] = t_trsm
    return res


def _refit_split(gp) -> dict:
    """CUDA-event ms of one gp_refit of ``gp`` and of each of its parts on
    the same state, with the refit's own inputs and Cholesky choice
    (``refit_inputs``): gram, cholesky, beta, K^-1's solve and the L^-T
    L^-1 matmul."""
    from safe_exploration_tpu_torch.models.gp import gp_refit, refit_inputs
    from safe_exploration_tpu_torch.ops.kernels import rbf_gram_masked

    args, chol, ym = refit_inputs(gp)
    k = rbf_gram_masked(*args)
    l = chol(k)
    solves = _refit_solves(l, ym)
    linv = solves["kinv"]()
    parts = {"gram": lambda: rbf_gram_masked(*args), "cholesky": lambda: chol(k),
             "beta": solves["beta"], "kinv_solve": solves["kinv"],
             "matmul": lambda: linv.transpose(-1, -2) @ linv,
             "refit": lambda: gp_refit(gp)}
    reps = 20 if gp.n_max <= 512 else 5
    return {name: _time_ms(fn, reps) for name, fn in parts.items()}


def _timed(out: list, fn):
    """``fn``, appending the host seconds of each call (synchronized on
    both sides) to ``out``."""
    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*args, **kw)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return r
    return call


def _episode_cfg(name: str, sets: list[str]):
    from safe_exploration_tpu_torch.runtime.config import CONFIGS
    from safe_exploration_tpu_torch.runtime.main import _apply_overrides

    return _apply_overrides(CONFIGS[name], sets)


# (a) runs 1 of the registered 6 episodes (2 until the cart-pole's phases
# came) and 15 of its 50 steps (25 until the stacked fleet's phases came)
# to keep the script's time; (b) runs its whole schedule; the cart-pole's
# episodic run 1 of its 6 episodes and 10 of its 50 steps (25 until the
# quadrotor fleet ran its 8 steps)
RUN_A = ["n_ep=1", "n_steps=15"]
RUN_B = ["n_max=2048", "n_init_samples=1024", "hyp_iters=60"]
RUNS_PENDULUM = (("a", "pendulum_episode", RUN_A),
                 ("b", "pendulum_episode", RUN_B))
RUNS_CARTPOLE = (("cartpole", "cartpole_episode", ["n_ep=1", "n_steps=10"]),)


def phase_episode(seed: int, runs: tuple = RUNS_PENDULUM,
                  label: str = "episode") -> dict:
    """run_experiment on the card, f32, printed under ``[label]``: (a)
    pendulum_episode as registered but for 1 of its 6 episodes (n_max 512:
    every refit on cholesky_blocked), (b) the same at BASELINE config 4's
    data scale on the exact GP (n_max 2048, 1,024 initial points, 60
    hyperparameter steps: every refit on cholesky_hbm); or
    cartpole_episode (BASELINE config 2: the portable CEM with 192 samples,
    n_safe 10, n_perf 10, a 4-output GP at n_max 512) for 1 of its 6
    episodes. Counts are zeroed just before each run and read just after;
    the fits, the Lipschitz calibrations and the ssm_updates are timed
    inside the run."""
    from safe_exploration_tpu_torch.ops.kernels.cholesky import MAX_N
    import safe_exploration_tpu_torch.runtime.episode as ep_mod
    from safe_exploration_tpu_torch.models.gp import gp_refit
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    out = {}
    for tag, config, sets in runs:
        cfg = _episode_cfg(config, sets + [f"seed={seed}"])
        spans = {"fit": [], "calibrate": [], "update": []}
        saved = {k: getattr(ep_mod, k) for k in (
            "ssm_fit", "_calibrate_lipschitz", "ssm_update")}

        ep_mod.ssm_fit = _timed(spans["fit"], saved["ssm_fit"])
        ep_mod._calibrate_lipschitz = _timed(spans["calibrate"],
                                             saved["_calibrate_lipschitz"])
        ep_mod.ssm_update = _timed(spans["update"], saved["ssm_update"])
        captured = {}
        run_episodic = ep_mod.run_episodic

        def keep(*args, **kw):
            r = run_episodic(*args, **kw)
            captured["ssm"] = r["ssm"]
            return r

        ep_mod.run_episodic = keep
        try:
            for w in KERNEL_WRAPPERS:
                w.launches = 0
            t0 = time.perf_counter()
            summary = run_experiment(cfg, dtype=torch.float32, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        finally:
            for k, v in saved.items():
                setattr(ep_mod, k, v)
            ep_mod.run_episodic = run_episodic
        gp = captured["ssm"].gp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp_refit(gp)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        split = _refit_split(gp)
        series = summary["series"]
        n_refits = 2 * cfg.n_ep + 2   # build, one per fit, one per update
        want_n = [min(cfg.n_init_samples + ep * cfg.n_steps, cfg.n_max)
                  for ep in range(cfg.n_ep)]
        finite = all(np.isfinite(v).all() for v in series.values())
        big, small = (("cholesky_hbm", "cholesky_blocked")
                      if cfg.n_max > MAX_N
                      else ("cholesky_blocked", "cholesky_hbm"))
        step_s = [t / cfg.n_steps for t in series["episode_time_s"]]
        knobs = (("sqp_outer", "sqp_inner", "sqp_polish", "n_safe", "n_perf",
                  "r_shared") if cfg.solver == "sqp" else
                 ("cem_samples", "cem_elites", "cem_iterations"))
        r = {"config": {k: getattr(cfg, k) for k in (
                 "n_max", "n_init_samples", "hyp_iters", "n_ep", "n_steps")
                 + knobs},
             "config_name": cfg.name,
             "series": series, "wall_s": wall, "launches": launches,
             "refits": n_refits, "fit_s": spans["fit"],
             "calibrate_s": spans["calibrate"], "update_s": spans["update"],
             "refit_s_final_model": refit_s, "refit_split_ms": split,
             "l_mu": captured["ssm"].l_mu.tolist(),
             "l_sigma": captured["ssm"].l_sigma.tolist(),
             "seconds_per_step": step_s}
        out[tag] = r
        print(f"[{label}] ({tag}) {cfg.name} {r['config']} f32: wall "
              f"{wall:.1f} s", flush=True)
        for key in ("violations", "feasibility_rate", "model_error",
                    "mean_cost", "episode_time_s", "n_data"):
            print(f"[{label}] ({tag})   {key}: {series[key]}", flush=True)
        print(f"[{label}] ({tag})   seconds per step "
              f"{[round(v, 4) for v in step_s]}", flush=True)
        print(f"[{label}] ({tag})   fit s {[round(v, 3) for v in spans['fit']]}"
              f", calibrate s {[round(v, 3) for v in spans['calibrate']]}, "
              f"ssm_update (refit) s {[round(v, 4) for v in spans['update']]}"
              f", one gp_refit of the final model {refit_s * 1e3:.2f} ms; "
              f"l_mu {r['l_mu']}, l_sigma {r['l_sigma']}", flush=True)
        print(f"[{label}] ({tag})   refit split of the final model, CUDA-event"
              f" ms per part: { {k: round(v, 4) for k, v in split.items()} }",
              flush=True)
        print(f"[{label}] ({tag})   launches {launches} ({n_refits} refits)",
              flush=True)
        if any(series["violations"]):
            _fail(f"run ({tag}): violations {series['violations']}")
        if not finite:
            _fail(f"run ({tag}): non-finite series")
        if series["n_data"] != want_n:
            _fail(f"run ({tag}): n_data {series['n_data']}, want {want_n}")
        if launches[big] != n_refits or launches[small] != 0:
            _fail(f"run ({tag}): {big} launched {launches[big]} times and "
                  f"{small} {launches[small]} in {n_refits} refits")
        if any(launches[w] != n_refits for w in (
                "rbf_gram_masked", "solve_psd", "tri_inv_lower")) or \
                launches["trsm_lower"]:
            _fail(f"run ({tag}): refit kernels launched {launches}")
    return out


PARITY_SETS = ["n_max=2048", "n_init_samples=1100", "hyp_iters=3", "n_ep=1",
               "n_steps=3", "cem_samples=32", "cem_elites=8",
               "cem_iterations=2"]


def phase_episode_parity(seed: int, config: str = "pendulum_episode",
                         sets: tuple = tuple(PARITY_SETS),
                         label: str = "episode-parity",
                         factor_tol: float = 1e-9) -> dict:
    """f64, one episode of ``config`` (pendulum_episode: 3 steps at n_max
    2048 with 1,100 initial points, 3 hyperparameter steps and a small
    CEM), on the GPU (kernels) and on the CPU (plain versions) with one set
    of draws from a CPU generator: the series equal (counts exactly, floats
    at 1e-9 relative) and the final factors within ``factor_tol``."""
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.episode import (
        episode_draws,
        run_episodic,
    )

    cfg = _episode_cfg(config, list(sets))
    out = {}
    for dev in ("cuda", "cpu"):
        exp = build_experiment(cfg, dtype=torch.float64, device=dev)
        spec = exp["env"].spec
        draws = episode_draws(
            torch.Generator().manual_seed(seed), spec, n_ep=cfg.n_ep,
            n_steps=cfg.n_steps, n_init=cfg.n_init_samples,
            n_region=128 * (spec.n_s + spec.n_u),
            plan_shape=exp["planner_noise_shape"], dtype=torch.float64)
        t0 = time.perf_counter()
        r = run_episodic(
            exp["env"], exp["init_state"], exp["get_action"], exp["a"],
            exp["b"], exp["k_fb"], kern_types=exp["kern_types"],
            n_max=cfg.n_max, l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
            n_ep=cfg.n_ep, n_steps=cfg.n_steps,
            n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
            make_ssm=exp["make_ssm"], draws=draws)
        out[dev] = dict(r, s=time.perf_counter() - t0)
    g, c = out["cuda"], out["cpu"]
    gs, cs = g["series"], c["series"]
    counts_equal = all(gs[k] == cs[k] for k in ("violations",
                                                 "feasibility_rate", "n_data"))
    floats = {k: max(abs(x - y) / max(abs(y), 1e-300)
                     for x, y in zip(gs[k], cs[k]))
              for k in ("model_error", "mean_cost")}
    if hasattr(g["ssm"], "sgp"):
        gs_, cs_, names = g["ssm"].sgp, c["ssm"].sgp, ("luu", "lsig", "alpha",
                                                       "vmat")
    else:
        gs_, cs_, names = g["ssm"].gp, c["ssm"].gp, ("chol", "beta", "kinv")
    factors = {f: _rel(getattr(gs_, f), getattr(cs_, f)) for f in names}
    res = {"counts_equal": counts_equal, "series_rel": floats,
           "factors_rel": factors, "series_cpu": cs, "gpu_s": g["s"],
           "cpu_s": c["s"]}
    print(f"[{label}] f64 {cfg.name}, n_max {cfg.n_max}, "
          f"{cfg.n_init_samples} points, {cfg.n_steps} steps: series "
          f"counts equal {counts_equal} (feasibility {cs['feasibility_rate']}"
          f", n_data {cs['n_data']}), float series rel {floats} (tol 1e-9), "
          f"final factors rel {factors} (tol {factor_tol:g}); GPU "
          f"{g['s']:.1f} s, CPU "
          f"{c['s']:.1f} s", flush=True)
    if not counts_equal or max(floats.values()) > 1e-9:
        _fail(f"[{label}] episode series differ GPU vs CPU: {gs} vs {cs}")
    if max(factors.values()) > factor_tol:
        _fail(f"[{label}] final GP factors differ GPU vs CPU: {factors}")
    return res


# the single-instance NLP (solvers/sqp.py) behind the two SQP episode
# configurations, each cut to 1 of its 6 episodes and a few of its 50
# steps to keep the script's time (the eager solve takes 5-9 s a step on
# the pendulum, 20-36 s on the cart-pole; 10 and 3 steps until the
# quadrotor's and the risk objective's phases came, then 3 and 1 until the
# quadrotor fleet ran its 8 steps)
NLP_X0 = (0.25, 0.65)
NLP_PEND_STEPS = 1
NLP_CART_STEPS = 1
RUNS_SQP = (("pendulum", "pendulum_episode_sqp",
             ["n_ep=1", f"n_steps={NLP_PEND_STEPS}"]),
            ("cartpole", "cartpole_episode_sqp",
             ["n_ep=1", f"n_steps={NLP_CART_STEPS}"]))
SQP_PARITY_SETS = ("n_ep=1", "n_steps=3", "hyp_iters=3")


def _rel0(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, 0 where both are all zero."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _first_model(seed: int, config: str = "pendulum_episode_sqp",
                 sets: tuple = ()):
    """An episodic configuration's first model, made on the card in f64 as
    its run makes it (its initial points from a CPU generator seeded
    ``seed``, its hyperparameter steps, the Lipschitz calibration), bucketed
    as the planner sees it; returned as numpy arrays with the
    configuration."""
    from safe_exploration_tpu_torch.models.convert import gpssm_to_numpy
    from safe_exploration_tpu_torch.models.ssm import (
        calibrate_lipschitz,
        ssm_bucketed,
        ssm_fit,
    )
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.episode import (
        collect_initial_data,
    )

    cfg = _episode_cfg(config, list(sets) + [f"seed={seed}"])
    exp = build_experiment(cfg, dtype=torch.float64, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    xs, us, resid = collect_initial_data(
        exp["env"], cfg.n_init_samples, exp["a"], exp["b"], exp["k_fb"],
        generator=gen)
    ssm = ssm_fit(exp["make_ssm"](xs, us, resid), iters=cfg.hyp_iters)
    ssm = calibrate_lipschitz(ssm, exp["env"].spec, gen)
    return cfg, gpssm_to_numpy(ssm_bucketed(ssm))


def _solve_launches(fn) -> tuple[int, float]:
    """CUDA kernels launched by one call of ``fn`` and their device ms,
    read from torch.profiler's raw trace (device activity only)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, ms = 0, 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            n += 1
            ms += e.duration_ns() / 1e6
    return n, ms


def phase_nlp(seed: int, config: str = "pendulum_episode_sqp",
              x0_vals: tuple = NLP_X0, sets: tuple = (),
              label: str = "nlp") -> dict:
    """One single-instance NLP solve (``build_experiment``'s SQP planner,
    ``make_sqp_planner`` over ``solve_safempc_nlp``: the Gauss-Newton AL
    core; pendulum_episode_sqp's full budget, 12 x 6 with 3 polish steps,
    H = 5, or cartpole_risk_sqp's objective at the horizon and budget
    ``sets`` give) from ``x0_vals`` on the configuration's first model: on
    the CPU in f64 (plain PyTorch), on the card in f64 and in f32. Gates:
    the card's f64 k_ff, lam and g within 1e-9 of the CPU's, feasible
    flags equal in both dtypes, and no host read inside a solve (each card
    solve runs under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any synchronizing call). Reports ms per solve (host,
    synchronized; the first call, which the kernels' build and the fit have
    warmed), the CUDA kernels a second, profiled solve launches and their
    count per Gauss-Newton step, and the device's busy share."""
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.solvers.sqp import (
        SqpConfig,
        sqp_n_duals,
        sqp_warm_len,
    )

    cfg, arrays = _first_model(seed, config, sets)
    tube = SqpConfig(n_safe=cfg.n_safe, c_safety=cfg.c_safety)
    n_warm = sqp_warm_len(SqpConfig(n_safe=cfg.n_safe, n_perf=cfg.n_perf,
                                    r_shared=cfg.r_shared))
    n_steps = cfg.sqp_outer * cfg.sqp_inner + cfg.sqp_polish
    out = {}
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float64),
                       ("cuda", torch.float32)):
        exp = build_experiment(cfg, dtype=dtype, device=dev)
        n_u = exp["env"].spec.n_u
        ssm = gpssm_from_numpy(arrays, exp["kern_types"], device=dev,
                               dtype=dtype)
        x0 = torch.tensor(x0_vals, dtype=dtype, device=dev)
        warm = torch.zeros((n_warm, n_u), dtype=dtype, device=dev)
        lam = torch.zeros((sqp_n_duals(exp["env"], tube),), dtype=dtype,
                          device=dev)

        def solve():
            return exp["planner"](None, ssm, x0, warm, lam)

        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            k_ff, feasible, violation, info = solve()
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
        r = {"k_ff": k_ff.double().cpu(), "lam": info["lam"].double().cpu(),
             "feasible": bool(feasible), "violation": float(violation),
             "cost": float(info["cost"]),
             "ms": (time.perf_counter() - t0) * 1e3}
        r["g"] = _margins(exp, tube, ssm, x0, k_ff).double().cpu()
        if dev == "cuda":
            r["launches"], r["device_ms"] = _solve_launches(solve)
            r["launches_per_gn_step"] = r["launches"] / n_steps
            r["busy"] = r["device_ms"] / r["ms"]
        out[f"{dev}_{str(dtype)[6:]}"] = r
    ref = out["cpu_float64"]
    for key in ("cuda_float64", "cuda_float32"):
        r = out[key]
        r["rel"] = {k: _rel0(r[k], ref[k]) for k in ("k_ff", "lam", "g")}
        print(f"[{label}] {key}: {r['ms']:.1f} ms a solve (the first call),"
              f" {r['launches']} CUDA kernels ({r['launches_per_gn_step']:.1f}"
              f" per GN step of {n_steps}), device {r['device_ms']:.2f} ms "
              f"(busy {r['busy']:.3f}); feasible {r['feasible']} (CPU "
              f"{ref['feasible']}), violation {r['violation']:.3e}, cost "
              f"{r['cost']:.6g}; vs CPU f64 rel {r['rel']}", flush=True)
        if r["feasible"] != ref["feasible"]:
            _fail(f"[{label}] {key} feasible {r['feasible']}, CPU f64 "
                  f"{ref['feasible']}")
    print(f"[{label}] {cfg.name} cpu_float64: {ref['ms']:.1f} ms a solve, "
          f"feasible "
          f"{ref['feasible']}, violation {ref['violation']:.3e}, cost "
          f"{ref['cost']:.6g}, max lam {float(ref['lam'].max()):.4g}, "
          f"max g {float(ref['g'].max()):.4g}; budget {cfg.sqp_outer} x "
          f"{cfg.sqp_inner} + {cfg.sqp_polish} polish", flush=True)
    worst = max(out["cuda_float64"]["rel"].values())
    if not worst <= 1e-9:
        _fail(f"[{label}] f64 card vs CPU: {out['cuda_float64']['rel']} > "
              "1e-9")
    return {k: {kk: (vv.tolist() if isinstance(vv, torch.Tensor) else vv)
                for kk, vv in v.items()} for k, v in out.items()}


def _margins(exp, tube, ssm, x0, k_ff):
    """The NLP's constraint margins g (stage and terminal) at the plan
    ``k_ff``, from the solver's own closures."""
    from safe_exploration_tpu_torch.solvers.sqp import _build_constraint_fn

    spec, k_fb = exp["env"].spec, exp["k_fb"]
    _, constraints, _, _, _ = _build_constraint_fn(
        ssm, x0, k_fb.expand(tube.n_safe, *k_fb.shape), exp["a"], exp["b"],
        tube, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
        exp["cost_fn"])
    return constraints(k_ff.reshape(-1))


L_BATCH = 256   # lanes of pendulum_batch_sqp: its refit is L * E Grams
# the fleet runs 2 of pendulum_batch_sqp's 4 episodes (the second on
# per-lane hyperparameters) and 5 of its 20 steps an episode (10 from the
# quadrotor's phases until its fleet ran its 8 steps) to keep the script's
# time
RUN_BATCH = ["n_ep=2", "n_steps=5"]


def _lane_gram_args(rng, lanes, n, dtype, mask_lane, e=E, d=D_IN):
    """The model-batched Gram's arguments: x (L, n, d); the mask (L, n) with
    ragged per-lane prefixes or lane 0's (n,) shared; the hyperparameters
    (L, e, .), one set per model."""
    mask = (np.arange(n)[None] < n - 7 - np.arange(lanes)[:, None] % 9
            ).astype(np.float64)
    arrays = (rng.uniform(-1.0, 1.0, (lanes, n, d)),
              mask if mask_lane else mask[0],
              rng.normal(-0.5, 0.3, (lanes, e, d)),
              rng.normal(-3.0, 0.2, (lanes, e)),
              rng.normal(-4.0, 0.2, (lanes, e)))
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in arrays]


def _rel_each(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst matrix's max |a - b| / max |b| over a batch (..., n, n)."""
    a, b = a.double(), b.double()
    num = (a - b).abs().flatten(-2).amax(-1)
    return float((num / b.abs().flatten(-2).amax(-1)).max())


def _batched_factor_errors(rng, dtype, lanes=L_BATCH, e=E, d=D_IN,
                           n=N_PATH) -> dict:
    """A refit's Cholesky and solves at its shape (L * e matrices of n,
    per-lane masks) against the f64 plain versions:
    each matrix's relative error (cholesky from the Gram in ``dtype``;
    solve_psd and tri_inv_lower from the f64 factor rounded to ``dtype``),
    and whether the factor and L^-1 are zero above the diagonal."""
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        cholesky_plain,
        rbf_gram_masked,
        solve_psd,
        tri_inv_lower,
        trsm_plain,
    )

    k = rbf_gram_masked(*_lane_gram_args(rng, lanes, n, dtype, True, e, d))
    l64 = cholesky_plain(k.double())
    l = cholesky_blocked(k)
    lt = l64.to(dtype)
    y = torch.tensor(rng.normal(size=(lanes, e, n, 1)), device="cuda")
    eye = torch.eye(n, dtype=torch.float64, device="cuda").expand(
        lanes, e, n, n)
    beta = solve_psd(lt, y.to(dtype))
    linv = tri_inv_lower(lt)
    return {"cholesky": _rel_each(l, l64),
            "solve_psd": _rel_each(beta.mT, trsm_plain(
                l64, trsm_plain(l64, y), True).mT),
            "tri_inv_lower": _rel_each(linv, trsm_plain(l64, eye)),
            "upper_zero": bool((torch.triu(l, 1) == 0).all())
            and bool((torch.triu(linv, 1) == 0).all()),
            "abs": {"cholesky": _abs(l, l64), "trsm": max(
                _abs(beta, trsm_plain(l64, trsm_plain(l64, y), True)),
                _abs(linv, trsm_plain(l64, eye)))}}


# the cart-pole fleet (cartpole_batch_sqp): 128 lanes of 4-output GPs over
# 4-D states and a 1-D force, n_max 128 -- 512 Grams of n = 128 at d = 5
L_CART, E_CART, D_CART = 128, 4, 5
# the quadrotor fleet (quadrotor_batch_sqp): 64 lanes of 6-output GPs over
# 6-D states and 2 thrusts, n_max 96 -- 384 Grams of n = 96 at d = 8, the
# first refit size on a path that is not a multiple of the 64-wide tile
L_QUAD, E_QUAD, D_QUAD, N_QUAD = 64, 6, 8, 96
# the fleet refit shapes: (label, lanes, e, d, n)
FLEET_SHAPES = (("pendulum", L_BATCH, E, D_IN, N_PATH),
                ("cartpole", L_CART, E_CART, D_CART, N_PATH),
                ("quadrotor", L_QUAD, E_QUAD, D_QUAD, N_QUAD))
# the refit shapes held against the plain versions: (label, lanes, e, d, n),
# the fleets' and the episodes' (cartpole_episode: one 4-output GP at n_max
# 512, 4 Grams in one launch; quadrotor_episode: one 6-output GP over 8
# inputs at n_max 512)
N_CART_EPISODE = 512
REFIT_SHAPES = FLEET_SHAPES + (
    ("cartpole-episode", 1, E_CART, D_CART, N_CART_EPISODE),
    ("quadrotor-episode", 1, E_QUAD, D_QUAD, N_CART_EPISODE))


def _fleet_refit_times(rng, lanes: int, e: int, d: int, n: int) -> dict:
    """A fleet refit's kernels timed at its shape (f32, L * e matrices of
    n): CUDA-event ms, device ms (profiler), the plain version's and the
    library's ms, and the bound at the least work (as
    ``_refit_kernel_times``); ``trsm`` sums beta's and K^-1's solves, the
    kernels line's entry."""
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        cholesky_plain,
        gram_plain,
        rbf_gram_masked,
        trsm_plain,
    )

    dt, m = torch.float32, lanes * e
    sz = 4
    args = _lane_gram_args(rng, lanes, n, dt, True, e, d)
    k = rbf_gram_masked(*args)
    l = cholesky_blocked(k)
    y = torch.tensor(rng.normal(size=(lanes, e, n, 1)), dtype=dt,
                     device="cuda")
    eye = torch.eye(n, dtype=dt, device="cuda").expand(lanes, e, n, n)
    eye = eye.contiguous()
    solves = _refit_solves(l, y)
    tri = n * (n + 1) // 2
    in_bytes = (lanes * (n * d + n) + m * (d + 2)) * sz
    t = {
        "gram": dict(fn=lambda: rbf_gram_masked(*args), library=None,
                     plain=lambda: gram_plain(*args),
                     bound=_bound_ms(in_bytes + m * n * n * sz,
                                     m * n * n * (2 * d + 7), dt)),
        "cholesky": dict(fn=lambda: cholesky_blocked(k),
                         library=lambda: torch.linalg.cholesky_ex(k),
                         plain=lambda: cholesky_plain(k),
                         bound=_bound_ms(m * (tri + n * n) * sz,
                                         m * n ** 3 / 3, dt)),
        "beta": dict(fn=solves["beta"],
                     library=lambda: _lib_solve(l, _lib_solve(l, y), True),
                     plain=lambda: trsm_plain(l, trsm_plain(l, y), True),
                     bound=_bound_ms(m * (tri + 2 * n) * sz, m * 2 * n * n,
                                     dt)),
        "kinv": dict(fn=solves["kinv"], library=lambda: _lib_solve(l, eye),
                     plain=lambda: trsm_plain(l, eye),
                     bound=_bound_ms(m * (tri + n * n) * sz, m * n ** 3 / 3,
                                     dt)),
    }
    res = {}
    for name, c in t.items():
        dev_ms, by_kernel = _device_ms(c["fn"])
        r = {"ms": _time_ms(c["fn"], 20),
             "library_ms": (None if c["library"] is None
                            else _time_ms(c["library"], 20)),
             "plain_ms": _time_ms(c["plain"], 2), "device_ms": dev_ms,
             "device_ms_by_kernel": by_kernel, "bound_ms": c["bound"][0],
             "bound_by": c["bound"][1]}
        res[name] = r
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[batch-kernels] time f32 L={lanes} e={e} d={d} n={n} {name}: "
              f"kernel {r['ms']:.4f} ms (device {dev_ms:.4f}), library {lib} "
              f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} "
              f"ms ({r['bound_by']})", flush=True)
    res["trsm"] = {key: (res["beta"][key] + res["kinv"][key]
                         if key in ("ms", "library_ms", "plain_ms",
                                    "device_ms") else None)
                   for key in res["beta"]}
    res["trsm"]["bound_ms"], res["trsm"]["bound_by"] = _bound_ms(
        m * (tri + 2 * n + n * n) * sz, m * (2 * n * n + n ** 3 / 3), dt)
    return res


def phase_batch_kernels(seed: int) -> dict:
    """The model-batched Gram against gram_plain matrix by matrix, f32 and
    f64, at the refits' shapes (``REFIT_SHAPES``: the pendulum fleet's
    L = 256, e = 2, d = 3 and the cart-pole fleet's L = 128, e = 4, d = 5 at
    n = 128; the quadrotor fleet's L = 64, e = 6, d = 8 at n = 96; the
    episodes' L = 1 at n = 512, e = 4, d = 5 and e = 6, d = 8) and at
    L = 2, n = 2048, with per-lane and shared masks: one launch, exactly
    symmetric. Each refit's Cholesky, solve_psd and tri_inv_lower at its
    shape against their f64 plain versions, each matrix within 2e-4 in f32
    and 1e-10 in f64, zero above the diagonal. Then each fleet refit's
    kernels timed at its shape (f32, ``_fleet_refit_times``)."""
    from safe_exploration_tpu_torch.ops.kernels import (
        gram_plain,
        rbf_gram_masked,
    )

    rng = np.random.default_rng(seed + 7)
    errs = {label: {} for label, *_ in REFIT_SHAPES}
    for dtype in (torch.float32, torch.float64):
        for label, lanes, e, d, n in REFIT_SHAPES + (
                ("large", 2, E, D_IN, N_HBM),):
            for mask_lane in (True, False):
                args = _lane_gram_args(rng, lanes, n, dtype, mask_lane, e, d)
                before = rbf_gram_masked.launches
                k = rbf_gram_masked(*args)
                one = rbf_gram_masked.launches == before + 1
                kp = gram_plain(*args)
                e_g, sym = _rel_each(k, kp), bool(torch.equal(k, k.mT))
                tol = 1e-10 if dtype == torch.float64 else 1e-5
                print(f"[batch-kernels] {str(dtype)[6:]} L={lanes} e={e} "
                      f"d={d} n={n} mask "
                      f"{'per lane' if mask_lane else 'shared'}: gram worst "
                      f"matrix's rel {e_g:.2e} (tol {tol:g}), one launch "
                      f"{one}, exactly symmetric {sym}", flush=True)
                if not (e_g <= tol and sym and one):
                    _fail(f"model-batched gram at {dtype} L={lanes} e={e} "
                          f"d={d} n={n} mask_lane={mask_lane}")
                if dtype == torch.float32 and label in errs and mask_lane:
                    errs[label]["gram"] = _abs(k, kp)
        for label, lanes, e, d, n in REFIT_SHAPES:
            fe = _batched_factor_errors(rng, dtype, lanes, e, d, n)
            tol = 1e-10 if dtype == torch.float64 else 2e-4
            worst = max(fe[w] for w in ("cholesky", "solve_psd",
                                        "tri_inv_lower"))
            print(f"[batch-kernels] {str(dtype)[6:]} {label} refit, "
                  f"{lanes * e} matrices of n={n}, worst matrix's rel "
                  f"against f64 plain: cholesky {fe['cholesky']:.2e}, "
                  f"solve_psd {fe['solve_psd']:.2e}, tri_inv_lower "
                  f"{fe['tri_inv_lower']:.2e} (tol {tol:g}); zeros above the "
                  f"diagonal {fe['upper_zero']}", flush=True)
            if not (worst <= tol and fe["upper_zero"]):
                _fail(f"{label} refit's cholesky or trsm disagrees "
                      f"with plain at {dtype}: {fe}")
            if dtype == torch.float32:
                errs[label].update(fe["abs"])
    timings = {label: _fleet_refit_times(rng, lanes, e, d, n)
               for label, lanes, e, d, n in FLEET_SHAPES}
    return {"errs": errs["pendulum"], "timings": timings["pendulum"],
            "errs_cartpole": errs["cartpole"],
            "timings_cartpole": timings["cartpole"],
            "errs_cartpole_episode": errs["cartpole-episode"],
            "errs_quadrotor": errs["quadrotor"],
            "timings_quadrotor": timings["quadrotor"],
            "errs_quadrotor_episode": errs["quadrotor-episode"]}


def _self_distance_and_lmu(ssm) -> dict:
    """On the card: the model's self-pair |z - x_i|^2 at its own buffer
    (``ssm_probe_points``, as the calibration probes it) exactly 0 for
    every output dim's lengthscales, and l_mu over the buffer equal to the
    CPU's on the same model within 1e-5 (f32)."""
    from safe_exploration_tpu_torch.models.convert import (
        gpssm_from_numpy,
        gpssm_to_numpy,
    )
    from safe_exploration_tpu_torch.models.kernels import _sq_dists
    from safe_exploration_tpu_torch.models.ssm import (
        estimate_lipschitz,
        ssm_probe_points,
    )

    probes = ssm_probe_points(ssm)
    z = probes if ssm.z_scale is None else probes / ssm.z_scale
    worst = 0.0
    for p in ssm.gp.params:
        ls = torch.exp(p["log_lengthscales"])
        d2 = torch.diagonal(_sq_dists(z / ls, ssm.gp.x / ls))
        worst = max(worst, float(d2.abs().max()))
    cpu = gpssm_from_numpy(gpssm_to_numpy(ssm), ssm.gp.kern_types,
                           device="cpu", dtype=probes.dtype)
    l_gpu = estimate_lipschitz(ssm, probes, factor=1.2).l_mu
    l_cpu = estimate_lipschitz(cpu, ssm_probe_points(cpu), factor=1.2).l_mu
    return {"self_d2_max": worst, "l_mu_gpu": l_gpu.tolist(),
            "l_mu_cpu": l_cpu.tolist(), "l_mu_rel": _rel(l_gpu, l_cpu)}


# the cart-pole fleet runs 2 of cartpole_batch_sqp's 4 episodes (the second
# on per-lane hyperparameters) and 1 of its 16 steps an episode (5 from
# the single-instance NLP's phases until the quadrotor's came, then 2 until
# the quadrotor fleet ran its 8 steps)
RUN_CART_BATCH = ["n_ep=2", "n_steps=1"]
CART_PARITY = (2, 1)   # [cartpole-batch-parity]: lanes, steps an episode


def phase_batch(seed: int, config: str = "pendulum_batch_sqp",
                sets: tuple = tuple(RUN_BATCH), label: str = "batch") -> dict:
    """run_experiment on a fleet configuration at full width on the card,
    f32, printed under ``[label]``: pendulum_batch_sqp (256 lanes, n_max
    128, 24 initial points, 5 of its 20 steps, n_safe 3) or
    cartpole_batch_sqp (128 lanes, n_max 128, 40 initial points, 1 of its
    16 steps, n_safe 6, n_perf 10, r_shared 2) or quadrotor_batch_sqp (64
    lanes, n_max 96, 40 initial points, 2 of its 8 steps, n_safe 3, n_perf
    5), each with the lane SQP at 4 outer x 3 inner and a per-lane fit and
    calibration after every episode (120 steps), 2 episodes (of 4, 4, 2). Counts are zeroed just before the run
    and read just after; the fits, calibrations and unstack refits are
    timed inside it. Gates: 0 violations, finite series but model_error (a
    non-finite model error only in lanes whose lane model left the episode
    non-finite: the f32 append's divergence), n_data as scheduled, one
    launch of each refit kernel per refit (the build, the first fit, and
    per episode the unstack and the fit: the last two cover all L x e
    matrices in one launch each); the model's self-pair distance exactly 0
    and its l_mu at the buffer equal to the CPU's."""
    import safe_exploration_tpu_torch.runtime.batch as batch_mod
    from safe_exploration_tpu_torch.models.gp_lanes import lane_unstack_ssm
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    cfg = _episode_cfg(config, list(sets) + [f"seed={seed}"])
    spans = {"fit": [], "calibrate": [], "unstack": [], "predict": [],
             "append": []}
    names = {"fit": "ssm_fit", "calibrate": "_calibrate_lipschitz",
             "unstack": "lane_unstack_ssm", "predict": "lane_predict",
             "append": "lane_append_point"}
    saved = {n: getattr(batch_mod, n) for n in names.values()}
    captured = {"episodes": []}
    run_learning = saved_learning = batch_mod.run_batched_learning
    run_episodes = saved_episodes = batch_mod.run_batched_episodes_lanes

    def keep(env, exp, ssm, *args, **kw):
        captured["initial"] = ssm
        r = run_learning(env, exp, ssm, *args, **kw)
        captured["model"] = r["model"]
        return r

    def keep_episode(*args, **kw):
        traj, model = run_episodes(*args, **kw)
        # per episode: lanes whose model error is not finite, and lanes
        # whose lane model (beta, K^-1) left the episode non-finite
        bad_err = ~torch.isfinite(traj["model_err"]).all(dim=1)
        gp = model.gp
        bad_model = ~(torch.isfinite(gp.beta).all(dim=(0, 1))
                      & torch.isfinite(gp.kinv).all(dim=(0, 1, 2)))
        captured["episodes"].append((bad_err.cpu(), bad_model.cpu()))
        return traj, model

    for span, name in names.items():
        setattr(batch_mod, name, _timed(spans[span], saved[name]))
    batch_mod.run_batched_learning = keep
    batch_mod.run_batched_episodes_lanes = keep_episode
    try:
        for w in KERNEL_WRAPPERS:
            w.launches = 0
        t0 = time.perf_counter()
        summary = run_experiment(cfg, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    finally:
        for name, fn in saved.items():
            setattr(batch_mod, name, fn)
        batch_mod.run_batched_learning = saved_learning
        batch_mod.run_batched_episodes_lanes = saved_episodes
    series = summary["series"]
    n_refits = 2 + 2 * cfg.n_ep
    lanes = cfg.batch_lanes
    per_ep_sps = [lanes * cfg.n_steps / t for t in series["episode_time_s"]]
    want_n = [min(cfg.n_init_samples + (ep + 1) * cfg.n_steps, cfg.n_max)
              for ep in range(cfg.n_ep)]
    # model_error is left out: the f32 lane append can drive a lane's K^-1
    # past f32's range when the fitted noise variance is below the jitter,
    # in the JAX package as here (ROADMAP Queue 3); such a lane's model
    # error is NaN from then on, and the episode's unstack refits it
    finite = all(np.isfinite(v).all() for k, v in series.items()
                 if k != "model_error")
    nan_err = [int(e.sum()) for e, _ in captured["episodes"]]
    bad_models = [int(m.sum()) for _, m in captured["episodes"]]
    nan_outside = sum(int((e & ~m).sum()) for e, m in captured["episodes"])
    # the batched refit's split on the final fleet (256 lanes, one shared
    # lockstep mask), beside one lane's own refit
    stacked = lane_unstack_ssm(captured["model"]).gp
    split = _refit_split(stacked)
    lane0 = stacked.replace(
        x=stacked.x[0], y=stacked.y[0], mask=stacked.mask,
        params=tuple({k: v[0] for k, v in p.items()} for p in stacked.params),
        log_noise=stacked.log_noise[0], chol=stacked.chol[0],
        beta=stacked.beta[0], kinv=stacked.kinv[0])
    split_one = _refit_split(lane0)
    probe = _self_distance_and_lmu(captured["initial"])
    step = _fleet_step_split(cfg, captured["model"], seed)
    r = {"config": {k: getattr(cfg, k) for k in (
             "batch_lanes", "n_max", "n_init_samples", "hyp_iters", "n_ep",
             "n_steps", "n_safe", "n_perf", "r_shared", "sqp_outer",
             "sqp_inner")},
         "series": series, "steps_per_sec_per_episode": per_ep_sps,
         "wall_s": wall, "launches": launches, "refits": n_refits,
         "fit_s": spans["fit"], "calibrate_s": spans["calibrate"],
         "unstack_refit_s": spans["unstack"], "refit_split_ms": split,
         "lanes_nan_model_error": nan_err, "lanes_nonfinite_model": bad_models,
         "predict_s": spans["predict"], "append_s": spans["append"],
         "step_split": step,
         "log_noise_first_fit": captured["initial"].gp.log_noise.tolist(),
         "refit_split_one_lane_ms": split_one, **probe}
    print(f"[{label}] {cfg.name} {r['config']} f32: wall {wall:.1f} s",
          flush=True)
    for key in ("violations", "feasibility_rate", "model_error", "mean_cost",
                "episode_time_s", "n_data", "steps_per_sec"):
        print(f"[{label}]   {key}: {series[key]}", flush=True)
    print(f"[{label}]   steps/s per episode {[round(v, 2) for v in per_ep_sps]}"
          f"; fit s {[round(v, 3) for v in spans['fit']]}, calibrate s "
          f"{[round(v, 3) for v in spans['calibrate']]}, unstack (batched "
          f"refit) s {[round(v, 4) for v in spans['unstack']]}", flush=True)
    print(f"[{label}]   batched refit split ({lanes} lanes x {stacked.n_out} "
          f"dims, n "
          f"{stacked.n_max}), CUDA-event ms: "
          f"{ {k: round(v, 4) for k, v in split.items()} }; one lane's "
          f"refit: { {k: round(v, 4) for k, v in split_one.items()} }",
          flush=True)
    per_step = {k: sum(spans[k]) / len(spans[k]) for k in ("predict",
                                                            "append")}
    print(f"[{label}]   per step (host, synchronized): lane_predict "
          f"{per_step['predict'] * 1e3:.2f} ms, lane_append_point "
          f"{per_step['append'] * 1e3:.2f} ms; one get_action_batch (the lane "
          f"SQP on the final fleet) {step['wall_ms_unprofiled']:.1f} ms, "
          f"{step['wall_ms']:.1f} ms under the profiler, device "
          f"{step['device_ms']:.1f} ms (busy share {step['busy']:.3f} of the "
          f"profiled call, {step['busy_unprofiled']:.3f} of the unprofiled "
          f"one; {step['launches']} device events); top kernels by device ms "
          f"{step['top']}", flush=True)
    print(f"[{label}]   launches {launches} ({n_refits} refits)", flush=True)
    print(f"[{label}]   lanes with a non-finite model error per episode "
          f"{nan_err}, lanes whose lane model left the episode non-finite "
          f"{bad_models} (of {lanes}); non-finite model errors outside "
          f"those lanes: {nan_outside}; the first fit's log noise "
          f"{[round(v, 3) for v in r['log_noise_first_fit']]} (the f32 "
          "append diverges below the jitter's 0.5 log 1e-6 = -6.908)",
          flush=True)
    print(f"[{label}]   model's self-pair |z - x_i|^2 max {probe['self_d2_max']}"
          f"; f32 l_mu at the buffer: card {probe['l_mu_gpu']}, CPU "
          f"{probe['l_mu_cpu']} (rel {probe['l_mu_rel']:.2e}, tol 1e-5)",
          flush=True)
    if any(series["violations"]):
        _fail(f"{label}: violations {series['violations']}")
    if not finite:
        _fail(f"{label}: non-finite series")
    if nan_outside:
        _fail(f"{label}: {nan_outside} lanes with a non-finite model error "
              "whose lane model stayed finite")
    if series["n_data"] != want_n:
        _fail(f"{label}: n_data {series['n_data']}, want {want_n}")
    if any(launches[w] != n_refits for w in (
            "rbf_gram_masked", "cholesky_blocked", "solve_psd",
            "tri_inv_lower")) or launches["trsm_lower"] or \
            launches["cholesky_hbm"]:
        _fail(f"{label}: refit kernels launched {launches} in {n_refits} "
              "refits")
    if probe["self_d2_max"] != 0.0 or probe["l_mu_rel"] > 1e-5:
        _fail(f"{label}: self distance {probe['self_d2_max']}, l_mu card vs "
              f"CPU rel {probe['l_mu_rel']}")
    return r


def _fleet_step_split(cfg, model, seed: int) -> dict:
    """One fleet step's solve on the final fleet (its bucketed view, fresh
    machine state, states from the initial distribution): host ms of one
    ``get_action_batch`` without and one under torch.profiler (device
    activity only), the device ms of its kernels, the busy share against
    either call, the launches and the five kernels with the most device
    time."""
    from safe_exploration_tpu_torch.models.gp_lanes import (
        lane_shrink_to_bucket,
    )
    from safe_exploration_tpu_torch.runtime.config import build_experiment

    dev = model.gp.x.device
    exp = build_experiment(cfg, dtype=model.gp.x.dtype, device=dev)
    spec = exp["env"].spec
    lanes = model.gp.n_lanes
    view = lane_shrink_to_bucket(model, n_free=cfg.n_steps)
    noise = np.random.default_rng(seed).standard_normal((lanes, spec.n_s))
    x0 = spec.init_m + spec.init_std * torch.tensor(
        noise, dtype=model.gp.x.dtype, device=dev)
    state = exp["init_state_batch"](lanes)
    # the fleet's episodes ran this solve at this bucket, so the first call
    # is warm; it warms the profiled one in turn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp["get_action_batch"](state, view, x0)
    torch.cuda.synchronize()
    wall_unprofiled = (time.perf_counter() - t0) * 1e3
    # device activity only, read from the raw trace: a cart-pole step
    # launches ~400,000 kernels, and building key_averages over them with
    # the CPU activity on took minutes on the host
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp["get_action_batch"](state, view, x0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "wall_ms_unprofiled": wall_unprofiled,
            "busy_unprofiled": device_ms / wall_unprofiled,
            "launches": sum(n for _, n in by_name.values()),
            "top": {k[:60]: round(ms, 2) for k, (ms, _) in top}}


def phase_batch_parity(seed: int, config: str = "pendulum_batch_sqp",
                       lanes: int = 8, steps: int = 3,
                       label: str = "batch-parity") -> dict:
    """f64, ``lanes`` lanes, ``steps`` steps, 2 episodes of a fleet
    configuration (pendulum_batch_sqp at 8 lanes and 3 steps,
    cartpole_batch_sqp at 2 and 1) on the GPU
    (kernels) and on the CPU (plain versions) with one set of draws from a
    CPU generator: counts and feasible flags equal; the model that enters
    the fleet (the build and first fit: no solve has run yet) within 1e-9;
    after the episodes, whose states follow the SQP's solutions, the
    trajectories within 1e-6, and the final per-lane factors,
    hyperparameters and Lipschitz constants within 1e-9."""
    import safe_exploration_tpu_torch.runtime.batch as batch_mod
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    cfg = _episode_cfg(config, [
        f"batch_lanes={lanes}", f"n_steps={steps}", "n_ep=2",
        f"seed={seed}"])
    spec = build_experiment(cfg, dtype=torch.float64, device="cpu")["env"].spec
    out = {}
    saved = (batch_mod.run_batched_episodes_lanes,
             batch_mod.run_batched_learning)
    for dev in ("cuda", "cpu"):
        rec = {"ep": []}

        def episodes(*args, **kw):
            r = saved[0](*args, **kw)
            rec["ep"].append(r)
            return r

        def learning(env, exp, ssm, *args, **kw):
            rec["initial"] = ssm
            r = saved[1](env, exp, ssm, *args, **kw)
            rec["model"] = r["model"]
            return r

        draws = batch_mod.batch_draws(
            torch.Generator().manual_seed(seed), spec, batch=cfg.batch_lanes,
            n_ep=cfg.n_ep, n_steps=cfg.n_steps, n_init=cfg.n_init_samples,
            n_region=128 * (spec.n_s + spec.n_u), dtype=torch.float64)
        batch_mod.run_batched_episodes_lanes = episodes
        batch_mod.run_batched_learning = learning
        try:
            t0 = time.perf_counter()
            rec["summary"] = run_experiment(cfg, dtype=torch.float64,
                                            device=dev, draws=draws)
            rec["s"] = time.perf_counter() - t0
        finally:
            batch_mod.run_batched_episodes_lanes, \
                batch_mod.run_batched_learning = saved
        out[dev] = rec
    g, c = out["cuda"], out["cpu"]
    gs, cs = g["summary"]["series"], c["summary"]["series"]
    counts_equal = all(gs[k] == cs[k] for k in ("violations",
                                                 "feasibility_rate", "n_data"))
    flags_equal = all(torch.equal(tg["feasible"].cpu(), tc["feasible"])
                      for (tg, _), (tc, _) in zip(g["ep"], c["ep"]))
    gi, ci = g["initial"], c["initial"]
    initial = max(_rel(getattr(gi.gp, f), getattr(ci.gp, f))
                  for f in ("chol", "beta", "kinv", "log_noise"))
    initial = max(initial, _rel(gi.l_mu, ci.l_mu), _rel(gi.l_sigma,
                                                        ci.l_sigma))
    traj = max(_rel(tg[k], tc[k]) for (tg, _), (tc, _) in zip(g["ep"], c["ep"])
               for k in ("x", "u", "resid", "model_err"))
    gm, cm = g["model"], c["model"]
    final = {f: _rel(getattr(gm.gp, f), getattr(cm.gp, f))
             for f in ("beta", "kinv", "log_noise")}
    final["params"] = max(_rel(gp_[k], cp_[k]) for gp_, cp_ in zip(
        gm.gp.params, cm.gp.params) for k in gp_)
    final["l_mu"], final["l_sigma"] = (_rel(gm.l_mu, cm.l_mu),
                                      _rel(gm.l_sigma, cm.l_sigma))
    res = {"counts_equal": counts_equal, "flags_equal": flags_equal,
           "initial_rel": initial, "traj_rel": traj, "final_rel": final,
           "series_cpu": cs, "gpu_s": g["s"], "cpu_s": c["s"]}
    print(f"[{label}] f64 {config}, {lanes} lanes, {steps} steps, 2 "
          f"episodes: "
          f"counts equal "
          f"{counts_equal} (feasibility {cs['feasibility_rate']}, n_data "
          f"{cs['n_data']}), feasible flags equal {flags_equal}; the model "
          f"entering the fleet rel {initial:.2e} (tol 1e-9); trajectories rel "
          f"{traj:.2e} (tol 1e-6), final per-lane model rel "
          f"{ {k: f'{v:.2e}' for k, v in final.items()} } (tol 1e-9); GPU "
          f"{g['s']:.1f} s, CPU {c['s']:.1f} s", flush=True)
    if not (counts_equal and flags_equal):
        _fail(f"{label}: series or flags differ GPU vs CPU: {gs} vs {cs}")
    if initial > 1e-9:
        _fail(f"{label}: initial model differs GPU vs CPU: {initial}")
    if traj > 1e-6 or max(final.values()) > 1e-9:
        _fail(f"{label}: trajectories or final model differ GPU vs CPU: "
              f"{traj}, {final}")
    return res


# BASELINE config 5: the quadrotor fleet (quadrotor_batch_sqp: 64 lanes,
# n_max 96, 40 initial points, 2 episodes; 2 of its 8 steps an episode since
# the stacked fleet's phases came, 4 since the sparse tier's), and its f64
# parity at 2 lanes, 1 step an episode; quadrotor_episode for 1 of its 6
# episodes and 25 of its 50 steps (the portable CEM with 256 samples,
# n_safe 5 + n_perf 12)
RUN_QUAD_BATCH = ("n_steps=2",)
QUAD_PARITY = (2, 1)
RUNS_QUAD = (("quadrotor", "quadrotor_episode", ["n_ep=1", "n_steps=25"]),)
# the risk objective: cartpole_risk_sqp's planner (the NLP with the perf
# trajectory's covariance in the cost) solved once from RISK_X0 on its
# first model, cut to RISK_NLP_SETS: a 4 x 3 + 3 budget and 5 of its 10
# safety stages (at 10 the first model's tube grows to 1e21 and the AL's
# multipliers to 1e27, where no two roundings agree); the lane SQP with the
# same objective at cartpole_batch_sqp's width, and one episode of
# cartpole_risk_sqp cut to 1 step (25-35 s a step on the card). The lane
# SQP's f64 card-vs-CPU gate: its fixed-budget risk solve answers relative
# changes of x0 of 1e-13 to 1e-12 with up to 5.8e-8 in k_ff on the CPU
# (the slow test test_cartpole_risk_lane_sqp_spread), so two devices'
# roundings need agree no better than that
RISK_X0 = (0.02, 0.05, 0.01, 0.02)
RISK_NLP_SETS = ("n_safe=5", "sqp_outer=4", "sqp_inner=3")
RISK_LANE_SETS = ("objective=risk_tracking", "w_sigma=5.0")
RUNS_RISK = (("risk", "cartpole_risk_sqp", ["n_ep=1", "n_steps=1"]),)
RISK_LANE_TOL = 1e-7


def _spread_x0s(spec, lanes: int, seed: int, scale: float, dtype, dev):
    """``lanes`` initial states uniform over ``scale`` times the safe box."""
    hi = spec.h_safe[:spec.n_s].double().cpu().numpy()
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (lanes, spec.n_s))
    return torch.tensor(x * scale * hi, dtype=dtype, device=dev)


def phase_risk_lanes(seed: int, lanes: int = L_CART,
                     n_parity: int = 4) -> dict:
    """The lane SQP under the risk objective (cartpole_batch_sqp's solver:
    n_safe 6 + n_perf 10, r_shared 2, 4 x 3, with objective risk_tracking
    and w_sigma 5, so the perf trajectory carries its covariance
    recursion and the GN Jacobian its n_perf n_s^2 = 160 more rows) on
    cartpole_risk_sqp's first model, one solve over ``lanes`` initial
    states spread over 0.3 of the safe box, on the card in f32 and f64,
    and on the CPU in f64 over the first ``n_parity`` lanes. Gates: finite
    plans, the card's f64 flags equal to the CPU's and k_ff within
    RISK_LANE_TOL of the CPU's on those lanes. Reports
    the host ms of each solve and the flags' agreement between f32 and
    f64."""
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.solvers.sqp import SqpConfig, sqp_warm_len

    _, arrays = _first_model(seed, "cartpole_risk_sqp")
    cfg = _episode_cfg("cartpole_batch_sqp", list(RISK_LANE_SETS))
    n_warm = sqp_warm_len(SqpConfig(n_safe=cfg.n_safe, n_perf=cfg.n_perf,
                                    r_shared=cfg.r_shared))
    out = {}
    for key, dev, dtype, b in (("card_f32", "cuda", torch.float32, lanes),
                               ("card_f64", "cuda", torch.float64, lanes),
                               ("cpu_f64", "cpu", torch.float64, n_parity)):
        exp = build_experiment(cfg, dtype=dtype, device=dev)
        ssm = gpssm_from_numpy(arrays, exp["kern_types"], device=dev,
                               dtype=dtype)
        x0s = _spread_x0s(exp["env"].spec, lanes, seed + 11, 0.3, dtype,
                          dev)[:b]
        warm = torch.zeros((b, n_warm, 1), dtype=dtype, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_ff, feas, viol, info = exp["batch_planner"](ssm, x0s, warm)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[key] = {
            "s": time.perf_counter() - t0, "k_ff": k_ff.double().cpu(),
            "feasible": feas.cpu(), "finite": bool(torch.isfinite(k_ff).all())
            and bool(torch.isfinite(info["cost"]).all())}
    g32, g64, c64 = (out[k] for k in ("card_f32", "card_f64", "cpu_f64"))
    flags_equal = bool(torch.equal(g64["feasible"][:n_parity],
                                   c64["feasible"]))
    kff = _rel0(g64["k_ff"][:n_parity], c64["k_ff"])
    agree = int((g32["feasible"] == g64["feasible"]).sum())
    res = {"lanes": lanes, "seconds": {k: v["s"] for k, v in out.items()},
           "feasible_frac": {k: float(v["feasible"].double().mean())
                             for k, v in out.items()},
           "f64_flags_equal_cpu": flags_equal, "f64_k_ff_rel_cpu": kff,
           "f64_tol": RISK_LANE_TOL,
           "f32_f64_flags_agree": agree}
    print(f"[risk] lane SQP, risk_tracking (w_sigma 5) at cartpole_batch_sqp's"
          f" solver, {lanes} lanes: card f32 {g32['s'] * 1e3:.1f} ms, card "
          f"f64 {g64['s'] * 1e3:.1f} ms, CPU f64 ({n_parity} lanes) "
          f"{c64['s'] * 1e3:.1f} ms; feasible share {res['feasible_frac']}; "
          f"f32 and f64 flags agree on {agree} of {lanes}; f64 card vs CPU on "
          f"{n_parity} lanes: flags equal {flags_equal}, k_ff rel {kff:.2e} "
          f"(tol {RISK_LANE_TOL:.0e})", flush=True)
    if not all(v["finite"] for v in out.values()):
        _fail("[risk] non-finite lane plan")
    if not flags_equal or not kff <= RISK_LANE_TOL:
        _fail(f"[risk] lane SQP f64 card vs CPU: flags equal {flags_equal}, "
              f"k_ff rel {kff}")
    return res


def phase_risk(seed: int) -> dict:
    """The risk objective: one NLP planner solve of cartpole_risk_sqp (as
    ``[nlp]``, cut to RISK_NLP_SETS), then the lane SQP under it."""
    nlp = phase_nlp(seed, "cartpole_risk_sqp", RISK_X0, RISK_NLP_SETS, "risk")
    return {"nlp": nlp, "lanes": phase_risk_lanes(seed)}


def phase_quadrotor_cem(seed: int, batch: int = B_QCEM,
                        n_parity: int = 8) -> dict:
    """One batched lane-CEM solve (quadrotor_episode's solver with
    ``cem_backend="lanes"``: 256 samples, 6 iterations, n_safe 5 + n_perf
    12, r_shared 1, so the wide pass scores M B = 16,384 lanes of the 6-D
    tube and perf trajectory) on quadrotor_episode's first model, over
    ``batch`` initial states spread over 0.3 of the safe box, with one set
    of draws from a CPU generator. In f32 under "auto" (the tube's and the
    perf stages' posterior through the gp_predict kernel at d = 8, e = 6,
    with the Jacobian; cem_score's envelope is n_s 2) and "xla" (the plain
    posterior): gp_predict launched under "auto" and not under "xla", the
    flags agreeing on at least 95 % of the lanes (as ``[cem]``). In f64
    over the first ``n_parity`` lanes, the card ("auto") against the CPU:
    flags equal, k_ff within 1e-9."""
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.ops.kernels import gp_predict_prepared
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.solvers.cem import CemConfig, cem_warm_len

    base, arrays = _first_model(seed, "quadrotor_episode")
    n_warm = cem_warm_len(CemConfig(n_safe=base.n_safe, n_perf=base.n_perf,
                                    r_shared=base.r_shared))
    n_var = n_warm * 2
    gen = torch.Generator().manual_seed(seed + 13)
    noise = torch.randn((base.cem_iterations, base.cem_samples, n_var, batch),
                        generator=gen, dtype=torch.float64)
    runs = {}
    for key, impl, dev, dtype, b in (
            ("auto_card_f32", "auto", "cuda", torch.float32, batch),
            ("xla_card_f32", "xla", "cuda", torch.float32, batch),
            ("auto_card_f64", "auto", "cuda", torch.float64, n_parity),
            ("cpu_f64", "auto", "cpu", torch.float64, n_parity)):
        cfg = _episode_cfg("quadrotor_episode", [
            "cem_backend=lanes", f"cem_gp_impl={impl}"])
        exp = build_experiment(cfg, dtype=dtype, device=dev)
        ssm = gpssm_from_numpy(arrays, exp["kern_types"], device=dev,
                               dtype=dtype)
        x0s = _spread_x0s(exp["env"].spec, batch, seed + 17, 0.3, dtype,
                          dev)[:b]
        warm = torch.zeros((b, n_warm, 2), dtype=dtype, device=dev)
        before = gp_predict_prepared.launches
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_ff, feas, viol, info = exp["batch_planner"](
            ssm, x0s, warm, noise=noise[..., :b])
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[key] = {
            "s": time.perf_counter() - t0, "k_ff": k_ff.double().cpu(),
            "feasible": feas.cpu(), "cost": info["cost"].double().cpu(),
            "gp_predict_launches": gp_predict_prepared.launches - before,
            "finite": bool(torch.isfinite(k_ff).all())}
    a32, x32 = runs["auto_card_f32"], runs["xla_card_f32"]
    g64, c64 = runs["auto_card_f64"], runs["cpu_f64"]
    agree = int((a32["feasible"] == x32["feasible"]).sum())
    flags_equal = bool(torch.equal(g64["feasible"], c64["feasible"]))
    kff = _rel0(g64["k_ff"], c64["k_ff"])
    res = {"batch": batch, "samples": base.cem_samples,
           "seconds": {k: v["s"] for k, v in runs.items()},
           "feasible_frac": {k: float(v["feasible"].double().mean())
                             for k, v in runs.items()},
           "gp_predict_launches": {k: v["gp_predict_launches"]
                                   for k, v in runs.items()},
           "auto_xla_flags_agree": agree, "f64_flags_equal_cpu": flags_equal,
           "f64_k_ff_rel_cpu": kff}
    print(f"[quadrotor-cem] lane CEM on quadrotor_episode's first model, "
          f"B={batch} M={base.cem_samples} ({batch * base.cem_samples} "
          f"scoring lanes), f32: auto {a32['s'] * 1e3:.1f} ms a solve "
          f"({a32['gp_predict_launches']} gp_predict launches), xla "
          f"{x32['s'] * 1e3:.1f} ms ({x32['gp_predict_launches']}); feasible "
          f"share {res['feasible_frac']}; auto vs xla flags agree on {agree} "
          f"of {batch} (gate {int(np.ceil(0.95 * batch))}); f64 card vs CPU "
          f"on {n_parity} lanes: flags equal {flags_equal}, k_ff rel "
          f"{kff:.2e} (tol 1e-9); card f64 {g64['s'] * 1e3:.1f} ms, CPU f64 "
          f"{c64['s'] * 1e3:.1f} ms", flush=True)
    if not all(v["finite"] for v in runs.values()):
        _fail("[quadrotor-cem] non-finite plan")
    if a32["gp_predict_launches"] == 0 or x32["gp_predict_launches"] \
            or c64["gp_predict_launches"]:
        _fail(f"[quadrotor-cem] gp_predict launches {res['gp_predict_launches']}")
    if agree < 0.95 * batch:
        _fail(f"[quadrotor-cem] auto and xla flags agree on only {agree}")
    if not flags_equal or not kff <= 1e-9:
        _fail(f"[quadrotor-cem] f64 card vs CPU: flags equal {flags_equal}, "
              f"k_ff rel {kff}")
    return res


# BASELINE config 4, the sparse (VFE) tier: bench.py's bench_sparse_solves
# model (N = 10,240 pendulum transitions, m = 256 inducing inputs, log noise
# -4, log sf -3, l_mu 0.05, l_sigma 0.02, raw inputs; c_safety 1.8, where the
# exact GP's 2.0 leaves every sparse tube infeasible) and
# pendulum_episode_sparse's m = 32 (n_max 512); bench_large_gp's refit shape
N_SPARSE, M_SPARSE = 10240, 256
N_SPARSE_EP, M_SPARSE_EP = 512, 32
REFIT_SHAPE = dict(n=10240, m=256, d=7, e=2)
SPARSE_SQP = dict(solver="sqp", n_safe=5, n_max=N_SPARSE, c_safety=1.8,
                  sqp_outer=14, sqp_inner=3, sqp_polish=6, sqp_rescue=4)
SPARSE_CEM = dict(solver="cem", n_safe=H_CEM, n_max=N_SPARSE, c_safety=1.8,
                  cem_samples=M_CEM, cem_elites=12, cem_iterations=4)
# f32 gates of [sparse-kernels]: [cem-kernels]' 3e-5 (gp_predict) and 2e-4
# (cem_score) at n <= 128, scaled by n / 128 above as [cem-kernels] scales
# its n = 512 rows. The sparse posterior's sums cancel far more than the
# exact GP's (|alpha| to 1e2 against a mean of 1e-3, |vmat| to 6e4: the
# variance is ~1e-3 of sf2), so two f32 summation orders differ by ~n eps
# times the sum of the terms' magnitudes, not of the result: gp_predict's
# f32 error is held relative to that term scale (_posterior_scales), the
# f64 error and cem_score's as [cem-kernels] holds them
_SPARSE_CACHE: dict = {}


def _sparse_exp(dtype, dev, **kw):
    from safe_exploration_tpu_torch.runtime.config import (
        ExperimentConfig,
        build_experiment,
    )

    return build_experiment(ExperimentConfig(name="bsparse", **kw),
                            dtype=dtype, device=dev)


def _sparse_arrays(seed: int, n_data: int = N_SPARSE,
                   m: int = M_SPARSE) -> dict:
    """bench_sparse_solves' sparse GP-SSM on n_data transitions drawn with
    numpy (bench.py's distributions), built in f64 on the CPU and handed over
    as numpy arrays (made once per shape)."""
    from safe_exploration_tpu_torch.models.convert import sparse_gpssm_to_numpy
    from safe_exploration_tpu_torch.models.sparse_gp import (
        make_sparse_gp_ssm,
        sparse_gp_refit,
    )

    if (seed, n_data, m) not in _SPARSE_CACHE:
        dt = torch.float64
        exp = _sparse_exp(dt, "cpu", **{**SPARSE_SQP, "n_max": n_data})
        xs, us, resid = _make_data(np.random.default_rng(seed + 21), n_data,
                                   dt, "cpu", exp)
        full = torch.full((2,), 0.05, dtype=dt)
        ssm = make_sparse_gp_ssm(exp["kern_types"], xs, us, resid,
                                 n_max=n_data, n_inducing=m, l_mu=full,
                                 l_sigma=0.4 * full, log_noise=-4.0)
        params = tuple({**p, "log_sf": torch.tensor(-3.0, dtype=dt)}
                       for p in ssm.sgp.params)
        _SPARSE_CACHE[seed, n_data, m] = sparse_gpssm_to_numpy(ssm.replace(
            sgp=sparse_gp_refit(ssm.sgp.replace(params=params))))
    return _SPARSE_CACHE[seed, n_data, m]


def _sparse_ssm(arr: dict, dtype, dev, refit: bool = True):
    """The sparse model of ``arr`` on ``dev`` in ``dtype``, refitted there
    (the factors of that device and precision) unless ``refit`` is False."""
    from safe_exploration_tpu_torch.models.convert import (
        sparse_gpssm_from_numpy,
    )
    from safe_exploration_tpu_torch.models.sparse_gp import sparse_gp_refit

    ssm = sparse_gpssm_from_numpy(arr, ("rbf", "rbf"), device=dev,
                                  dtype=dtype)
    return ssm.replace(sgp=sparse_gp_refit(ssm.sgp)) if refit else ssm


def _posterior_scales(post, z: torch.Tensor):
    """The magnitudes of the terms each posterior output sums, per lane, in
    f64: sum_i |w_i| k_i (mean), sf2 + sum_ij k_i |W_ij| k_j (variance) and
    sum_i |w_i| k_i (|x_i| + |z|) il^2 (Jacobian); the scale of two
    summation orders' rounding difference."""
    inv_ls, inv_ls2, sf2, _ = (h.double() for h in post.hyper)
    x, zz = post.x.double(), z.double()
    mus, vars_, jacs = [], [], []
    for e in range(post.w_mean.shape[0]):
        diff = post.x_il[e].double()[:, :, None] - zz[None] * inv_ls[e][
            None, :, None]
        kv = sf2[e] * torch.exp(-0.5 * torch.sum(diff * diff, dim=1))
        w = post.w_mean[e].double().abs()[:, None]
        mus.append(torch.sum(w * kv, dim=0))
        vars_.append(sf2[e] + torch.sum(
            kv * (post.w_var_t[e].double().abs().mT @ kv), dim=0))
        jacs.append((x.abs().T @ (w * kv) + zz.abs() * torch.sum(
            w * kv, dim=0)) * inv_ls2[e][:, None])
    return torch.stack(mus), torch.stack(vars_), torch.stack(jacs)


def _scaled_err(out, ref, scale) -> float:
    """max |out - ref| / scale, elementwise."""
    return float(((out.double() - ref.double()).abs() / scale).max())


def phase_sparse_kernels(seed: int) -> dict:
    """gp_predict (with and without the Jacobian) and cem_score on a sparse
    posterior (the m inducing rows, alpha and Kuu^-1 - Sigma^-1, no mask)
    prepared by prepare_posterior / prepare_tube_score, at m = 256
    (bench_sparse_solves' model: cem_score's streamed-W tier) and m = 32
    (pendulum_episode_sparse's), d 3, e 2, L = 16,384 and a ragged 1,000,
    f32 and f64, against their plain versions; then the f32 times at the
    CEM path's shapes (gp_predict at L = B with the Jacobian, cem_score at L
    = M B, H 5)."""
    from safe_exploration_tpu_torch.models.convert import sparse_gpssm_to_numpy
    from safe_exploration_tpu_torch.ops.kernels import (
        gp_predict_prepared,
        posterior_plain,
        prepare_posterior,
        prepare_tube_score,
        tube_score_plain,
        tube_score_prepared,
    )

    rng = np.random.default_rng(seed + 22)
    consts, polys, target = _cem_plant(torch.float64, "cuda")
    shapes = {M_SPARSE: _sparse_arrays(seed),
              M_SPARSE_EP: _sparse_arrays(seed, N_SPARSE_EP, M_SPARSE_EP)}

    def score_args(ssm, u, x0, dtype):
        t = {"dtype": dtype, "device": "cuda"}
        return (ssm, torch.tensor(u, **t), torch.tensor(x0, **t),
                *(c.to(dtype) for c in consts),
                *(p.to(dtype) for p in polys), 1.8, u.shape[0], "tracking",
                {"target": target.to(dtype)})

    errs, worst, timings = {}, {}, {}
    for m, arr in shapes.items():
        scale = max(1.0, m / 128)
        tol_gp, tol_cs = 3e-5 * scale, 2e-4 * scale
        # the card's factors in each precision, carried to the plain side
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            ssm = _sparse_ssm(arr, dtype, "cuda", refit=not f64)
            post = prepare_posterior(ssm)
            for L in (M_CEM * B_CEM, 1000):
                z = torch.tensor(rng.uniform(-1.0, 1.0, (D_IN, L))
                                 * [[0.3], [1.0], [1.0]], dtype=dtype,
                                 device="cuda")
                scales = _posterior_scales(post, z)
                e_rel, e_scaled = [], []
                for jac in (False, True):
                    out = gp_predict_prepared(post, z, want_jac=jac)
                    ref = posterior_plain(post, z, want_jac=jac)
                    e_rel += [_rel(o, r) for o, r in zip(out, ref)]
                    e_scaled += [_scaled_err(o, r, s) for o, r, s in zip(
                        out, ref, scales)]
                u = (0.4 * rng.standard_normal((H_CEM, L))).astype(
                    np.float64 if f64 else np.float32)
                x0 = (rng.uniform(-1.0, 1.0, (2, L)) * [[0.15], [0.4]]).astype(
                    u.dtype)
                prep = prepare_tube_score(ssm, *score_args(ssm, u, x0,
                                                           dtype)[3:])
                out = tube_score_prepared(prep, *score_args(ssm, u, x0,
                                                            dtype)[1:3])
                # the plain reference in f64 on the model's own values
                ref_ssm = _sparse_ssm(sparse_gpssm_to_numpy(ssm),
                                      torch.float64, "cuda", refit=False)
                ref = tube_score_plain(*score_args(ref_ssm, u.astype(
                    np.float64), x0.astype(np.float64), torch.float64))
                e_cs = max(_rel(o, r) for o, r in zip(out, ref))
                e_gp = max(e_rel) if f64 else max(e_scaled)
                tg, tc = (1e-10, 1e-10) if f64 else (tol_gp, tol_cs)
                print(f"[sparse-kernels] {str(dtype)[6:]} m={m} d={D_IN} e={E}"
                      f" L={L}: gp_predict rel {max(e_rel):.2e}, relative to "
                      f"the terms' scale {max(e_scaled):.2e} (gate on the "
                      f"{'first' if f64 else 'second'}, tol {tg:g}); "
                      f"cem_score rel {e_cs:.2e} (tol {tc:g})", flush=True)
                if e_gp > tg or e_cs > tc:
                    _fail(f"[sparse-kernels] {dtype} m={m} L={L}: gp_predict "
                          f"{e_gp}, cem_score {e_cs}")
                if not f64:
                    worst[f"gp_predict_m{m}"] = max(
                        worst.get(f"gp_predict_m{m}", 0.0), e_gp)
                    worst[f"cem_score_m{m}"] = max(
                        worst.get(f"cem_score_m{m}", 0.0), e_cs)
        # f32 times at the CEM path's shapes, on the card's f32 model
        dt, sz = torch.float32, 4
        ssm = _sparse_ssm(arr, dt, "cuda")
        post = prepare_posterior(ssm)
        z = torch.tensor(rng.uniform(-1.0, 1.0, (D_IN, B_CEM))
                         * [[0.3], [1.0], [1.0]], dtype=dt, device="cuda")
        out = gp_predict_prepared(post, z, want_jac=True)
        ref = posterior_plain(post, z, want_jac=True)
        errs[f"gp_predict_m{m}"] = max(_abs(o, r) for o, r in zip(out, ref))
        n_bytes = sz * (m * D_IN + E * m + E * m * m + E * (D_IN + 1)
                        + D_IN * B_CEM + 2 * E * B_CEM + E * D_IN * B_CEM)
        ops = _gp_prep_ops(m) + E * B_CEM * _gp_lane_ops(m, True)
        r = dict(shape=f"sparse m={m} d={D_IN} e={E} L={B_CEM}",
                 ms=_time_ms(lambda: gp_predict_prepared(post, z,
                                                         want_jac=True), 20),
                 plain_ms=_time_ms(lambda: posterior_plain(post, z,
                                                           want_jac=True), 5),
                 library_ms=None, bound=_bound_ms(n_bytes, ops, dt))
        r["device_ms"], r["device_ms_by_kernel"] = _device_ms(
            lambda: gp_predict_prepared(post, z, want_jac=True))
        timings[f"gp_predict_m{m}"] = r
        L = M_CEM * B_CEM
        u = (0.4 * rng.standard_normal((H_CEM, L))).astype(np.float32)
        x0 = (rng.uniform(-1.0, 1.0, (2, L)) * [[0.15], [0.4]]).astype(
            np.float32)
        args = score_args(ssm, u, x0, dt)
        prep = prepare_tube_score(ssm, *args[3:])
        out = tube_score_prepared(prep, *args[1:3])
        ref = tube_score_plain(*args)
        errs[f"cem_score_m{m}"] = max(_abs(o, r) for o, r in zip(out, ref))
        ops = (_gp_prep_ops(m) + E * L * (_gp_lane_ops(m, False) + (
            H_CEM - 1) * _gp_lane_ops(m, True))
            + L * _tube_ops(H_CEM, len(polys[1]), len(polys[3])))
        n_bytes = sz * (m * D_IN + E * m + E * m * m + (H_CEM + 2) * L + 2 * L)
        r = dict(shape=f"sparse m={m} H={H_CEM} L={L}",
                 ms=_time_ms(lambda: tube_score_prepared(prep, *args[1:3]),
                             20),
                 plain_ms=_time_ms(lambda: tube_score_plain(*args), 3),
                 library_ms=None, bound=_bound_ms(n_bytes, ops, dt))
        r["device_ms"], r["device_ms_by_kernel"] = _device_ms(
            lambda: tube_score_prepared(prep, *args[1:3]))
        timings[f"cem_score_m{m}"] = r
    for name, r in timings.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print(f"[sparse-kernels] time f32 {r['shape']} {name}: kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, library null (no one PyTorch call "
              f"computes it), bound {r['bound_ms']:.6f} ms ({r['bound_by']})",
              flush=True)
    return {"worst_rel_f32": worst, "errs": errs, "timings": timings}


def phase_sparse_refit(seed: int) -> dict:
    """sparse_gp_refit at bench_large_gp's shape (n 10,240 random normal
    inputs, m 256, d 7, e 2, unit hyperparameters): CUDA-event ms in f32
    and f64, sparse_gp_predict at one input in us; the card's f64 factors
    against the CPU's at 1e-9, the f32 factors finite."""
    from safe_exploration_tpu_torch.models.sparse_gp import (
        sparse_gp_init,
        sparse_gp_predict,
        sparse_gp_refit,
    )

    n, m, d, e = (REFIT_SHAPE[k] for k in ("n", "m", "d", "e"))
    rng = np.random.default_rng(seed + 23)
    x, y = rng.standard_normal((n, d)), rng.standard_normal((n, e))
    out, factors = {}, {}
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float64),
                       ("cuda", torch.float32)):
        kw = {"dtype": dtype, "device": dev}
        sgp = sparse_gp_init(("rbf",) * e, torch.tensor(x, **kw),
                             torch.tensor(y, **kw), n_max=n, n_inducing=m)
        key = f"{dev}_{str(dtype)[6:]}"
        factors[key] = {f: getattr(sgp, f) for f in ("luu", "lsig", "alpha",
                                                     "vmat")}
        if dev == "cuda":
            zq = torch.zeros((d,), **kw)
            out[key] = {"refit_ms": _time_ms(lambda: sparse_gp_refit(sgp), 10),
                        "predict_us": 1e3 * _time_ms(
                            lambda: sparse_gp_predict(sgp, zq), 50)}
    rel = {f: _rel(factors["cuda_float64"][f], factors["cpu_float64"][f])
           for f in factors["cpu_float64"]}
    finite = all(bool(torch.isfinite(v).all())
                 for v in factors["cuda_float32"].values())
    res = {"shape": REFIT_SHAPE, "times": out, "f64_factors_rel_cpu": rel,
           "f32_finite": finite}
    print(f"[sparse-refit] n={n} m={m} d={d} e={e}: refit "
          f"{ {k: round(v['refit_ms'], 4) for k, v in out.items()} } ms "
          f"(CUDA events), sparse_gp_predict "
          f"{ {k: round(v['predict_us'], 1) for k, v in out.items()} } us; "
          f"f64 factors card vs CPU rel { {k: f'{v:.1e}' for k, v in rel.items()} } "
          f"(tol 1e-9); f32 factors finite {finite}", flush=True)
    if max(rel.values()) > 1e-9:
        _fail(f"[sparse-refit] f64 factors differ card vs CPU: {rel}")
    if not finite:
        _fail("[sparse-refit] non-finite f32 factors")
    return res


def phase_sparse_batch(seed: int, batch: int = 512, n_parity: int = 16
                       ) -> dict:
    """The lane SQP on bench_sparse_solves' model (build_experiment's
    batch_planner at its configuration: n_safe 5, 14 x 3 + 6 polish + 4
    rescue), f32 on the card at B = batch: the card's refit, two
    get_action_batch calls around a plant step and an ssm_update (an O(N m^2)
    refit); gates 0 violations and finite plans. Then f64 on ``n_parity``
    lanes, the card against the CPU, each from its own refit of one model:
    factors 1e-9, flags equal, k_ff 1e-4 ([parity]'s gates)."""
    from safe_exploration_tpu_torch.envs import env_step
    from safe_exploration_tpu_torch.models import ssm_bucketed, ssm_update

    arr = _sparse_arrays(seed)
    dtype, dev = torch.float32, "cuda"
    rng = np.random.default_rng(seed + 24)
    exp = _sparse_exp(dtype, dev, **SPARSE_SQP)
    ssm = _sparse_ssm(arr, dtype, dev)
    x0 = torch.tensor(rng.uniform(-1.0, 1.0, (batch, 2)) * [0.15, 0.4],
                      dtype=dtype, device=dev)
    noise = [torch.tensor(rng.standard_normal((batch, 2)), dtype=dtype,
                          device=dev) for _ in range(2)]
    state = exp["init_state_batch"](batch)
    _sync(dev)
    t0 = time.perf_counter()
    u1, state, info1 = exp["get_action_batch"](state, ssm_bucketed(ssm), x0)
    _sync(dev)
    t_first = time.perf_counter() - t0
    _, x1 = env_step(exp["env"], x0, u1, noise=noise[0])
    k_new = 8
    resid1 = x1[:k_new] - (x0[:k_new] @ exp["a"].T + u1[:k_new] @ exp["b"].T)
    _sync(dev)
    t0 = time.perf_counter()
    ssm = ssm_update(ssm, x0[:k_new], u1[:k_new], resid1)
    _sync(dev)
    update_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    u2, state, info2 = exp["get_action_batch"](state, ssm_bucketed(ssm), x1)
    _sync(dev)
    t_second = time.perf_counter() - t0
    _, x2 = env_step(exp["env"], x1, u2, noise=noise[1])
    feas = [float(i["feasible"].float().mean()) for i in (info1, info2)]
    viol = _violations(exp, x1) + _violations(exp, x2)
    finite = all(bool(torch.isfinite(o.float()).all()) for o in (
        u1, u2, x1, x2, info1["cost"], info2["cost"], info1["warm_next"],
        info2["warm_next"]))
    res = {"feasible_frac": feas, "solves_per_s": batch / t_second,
           "first_call_s": t_first, "second_call_s": t_second,
           "ssm_update_ms": update_ms, "violations": viol, "finite": finite,
           "n_points_after_update": int(ssm.sgp.n_points)}
    print(f"[sparse-batch] lane SQP on the sparse model (N={N_SPARSE}, "
          f"m={M_SPARSE}), B={batch} H=5 f32: feasible_frac per step {feas}, "
          f"solves/s {res['solves_per_s']:.2f} (second call {t_second:.2f} s;"
          f" first {t_first:.2f} s), ssm_update {update_ms:.1f} ms, "
          f"violations {viol}, finite {finite}", flush=True)
    if not finite:
        _fail("[sparse-batch] non-finite output")
    if viol:
        _fail(f"[sparse-batch] {viol} state-constraint violations")

    par = {}
    for pdev in ("cuda", "cpu"):
        pexp = _sparse_exp(torch.float64, pdev, **SPARSE_SQP)
        pssm = _sparse_ssm(arr, torch.float64, pdev)
        px0 = torch.tensor(np.asarray(x0[:n_parity].cpu(), np.float64),
                           dtype=torch.float64, device=pdev)
        warm = torch.zeros((n_parity, 5, 1), dtype=torch.float64, device=pdev)
        t0 = time.perf_counter()
        k_ff, feas_p, _, _ = pexp["batch_planner"](pssm, px0, warm)
        _sync(pdev)
        par[pdev] = dict(sgp=pssm.sgp, k_ff=k_ff, feasible=feas_p.cpu(),
                         s=time.perf_counter() - t0)
    g, c = par["cuda"], par["cpu"]
    factors = {f: _rel(getattr(g["sgp"], f), getattr(c["sgp"], f))
               for f in ("luu", "lsig", "alpha", "vmat")}
    flags = bool(torch.equal(g["feasible"], c["feasible"]))
    kff = _rel0(g["k_ff"], c["k_ff"])
    res["parity"] = {"lanes": n_parity, "factors_rel": factors,
                     "feasible_equal": flags, "k_ff_rel": kff,
                     "feasible_frac": float(c["feasible"].double().mean()),
                     "gpu_s": g["s"], "cpu_s": c["s"]}
    print(f"[sparse-batch] f64 {n_parity} lanes, card vs CPU: factors rel "
          f"{ {k: f'{v:.1e}' for k, v in factors.items()} } (tol 1e-9), "
          f"flags equal {flags} (feasible {res['parity']['feasible_frac']}), "
          f"k_ff rel {kff:.2e} (tol 1e-4); card {g['s']:.1f} s, CPU "
          f"{c['s']:.1f} s", flush=True)
    if max(factors.values()) > 1e-9 or not flags or kff > 1e-4:
        _fail(f"[sparse-batch] f64 card vs CPU: {res['parity']}")
    return res


def phase_sparse_cem(seed: int, batch: int = B_CEM, n_parity: int = 16
                     ) -> dict:
    """The lane CEM on bench_sparse_solves' model (bench_cem_solves' budget:
    B 256, M 64, 12 elites, 4 iterations, H 5; c_safety 1.8), f32 on the
    card: solves under "auto" (cem_score for the wide passes, gp_predict
    for the final ones, on the sparse posterior; the counts are zeroed just
    before each solve and read just after) and "xla" (the plain lane form)
    in turns (auto, xla, xla, auto), with one set of draws: both kernels
    launched, the flags equal on every lane; solves/s from each one's
    median. The busy share of an "auto" solve (profiler). Then f64 on
    ``n_parity`` lanes, the card ("auto") against the CPU: flags equal,
    k_ff within 1e-9."""
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS

    arr = _sparse_arrays(seed)
    rng = np.random.default_rng(seed + 25)
    x0 = rng.uniform(-1.0, 1.0, (batch, 2)) * [0.15, 0.4]
    gen = torch.Generator().manual_seed(seed + 26)
    noise = torch.randn((4, M_CEM, H_CEM, batch), generator=gen,
                        dtype=torch.float64)
    runs, models = {}, {}
    # the f32 solves in turns (auto, xla, xla, auto): solves/s from the
    # median of each one's two; launches, flags and plans from its last
    for key, impl, dev, dtype, b in (
            ("auto_card_f32", "auto", "cuda", torch.float32, batch),
            ("xla_card_f32", "xla", "cuda", torch.float32, batch),
            ("xla_card_f32", "xla", "cuda", torch.float32, batch),
            ("auto_card_f32", "auto", "cuda", torch.float32, batch),
            ("auto_card_f64", "auto", "cuda", torch.float64, n_parity),
            ("cpu_f64", "auto", "cpu", torch.float64, n_parity)):
        if key not in models:
            models[key] = (_sparse_exp(dtype, dev, **SPARSE_CEM,
                                       cem_gp_impl=impl),
                           _sparse_ssm(arr, dtype, dev))
        exp, ssm = models[key]
        xt = torch.tensor(x0[:b], dtype=dtype, device=dev)
        warm = torch.zeros((b, H_CEM, 1), dtype=dtype, device=dev)
        for w in KERNEL_WRAPPERS:
            w.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        k_ff, feas, viol, info = exp["batch_planner"](
            ssm, xt, warm, noise=noise[..., :b].to(dtype))
        _sync(dev)
        seconds = runs.get(key, {}).get("all_s", []) + [
            time.perf_counter() - t0]
        runs[key] = {
            "s": float(np.median(seconds)), "all_s": seconds,
            "k_ff": k_ff.double().cpu(), "feasible": feas.cpu(),
            "launches": {w.__name__: w.launches for w in KERNEL_WRAPPERS
                         if w.launches},
            "finite": bool(torch.isfinite(k_ff).all())}
    exp, ssm = models["auto_card_f32"]
    split = _cem_split(exp, ssm, torch.tensor(x0, dtype=torch.float32,
                                              device="cuda"), batch, "cuda",
                       "sparse-cem")
    a32, x32 = runs["auto_card_f32"], runs["xla_card_f32"]
    g64, c64 = runs["auto_card_f64"], runs["cpu_f64"]
    agree = int((a32["feasible"] == x32["feasible"]).sum())
    flags_equal = bool(torch.equal(g64["feasible"], c64["feasible"]))
    kff = _rel0(g64["k_ff"], c64["k_ff"])
    launches = a32["launches"]
    res = {"batch": batch, "samples": M_CEM,
           "solves_per_s": {k: batch / v["s"] for k, v in runs.items()
                            if "f32" in k},
           "seconds": {k: v["s"] for k, v in runs.items()},
           "feasible_frac": {k: float(v["feasible"].double().mean())
                             for k, v in runs.items()},
           "launches": {k: v["launches"] for k, v in runs.items()},
           "auto_xla_flags_agree": agree, "f64_flags_equal_cpu": flags_equal,
           "f64_k_ff_rel_cpu": kff, **split}
    print(f"[sparse-cem] lane CEM on the sparse model (m={M_SPARSE}), "
          f"B={batch} M={M_CEM} H={H_CEM} f32: auto "
          f"{res['solves_per_s']['auto_card_f32']:.1f} solves/s (launches "
          f"{launches}), xla {res['solves_per_s']['xla_card_f32']:.1f} "
          f"solves/s (solve s, in turns: "
          f"{ {k: [round(s, 4) for s in v['all_s']] for k, v in runs.items()} }"
          f"); feasible share {res['feasible_frac']}; auto vs xla "
          f"flags agree on {agree} of {batch}; f64 card vs CPU on {n_parity} "
          f"lanes: flags equal {flags_equal}, k_ff rel {kff:.2e} (tol 1e-9)",
          flush=True)
    if not all(v["finite"] for v in runs.values()):
        _fail("[sparse-cem] non-finite plan")
    if not launches.get("gp_predict_prepared") or \
            not launches.get("tube_score_prepared") or x32["launches"] or \
            c64["launches"]:
        _fail(f"[sparse-cem] kernel launches {res['launches']}")
    if agree != batch:
        _fail(f"[sparse-cem] auto and xla flags agree on only {agree}")
    if not flags_equal or not kff <= 1e-9:
        _fail(f"[sparse-cem] f64 card vs CPU: flags equal {flags_equal}, "
              f"k_ff rel {kff}")
    return res


# pendulum_large_sparse as registered (n_max 10,240, m 256, 1,024 initial
# points, 60 fit steps, the NLP at 12 x 6 + 3), cut to 1 of its 6 episodes
# and 2 of its 50 steps (the eager NLP takes seconds a step);
# pendulum_episode_sparse (the portable CEM, m 32) cut to 1 episode and 10
# steps; the f64 card-vs-CPU run of pendulum_episode_sparse cut to 3 steps
# at n_max 64 and 3 fit steps, as the other episode parity runs
RUNS_SPARSE = (("large", "pendulum_large_sparse", ["n_ep=1", "n_steps=2"]),
               ("episode", "pendulum_episode_sparse",
                ["n_ep=1", "n_steps=10"]))
SPARSE_PARITY_SETS = ("n_ep=1", "n_steps=3", "n_max=64", "hyp_iters=3",
                      "cem_samples=32", "cem_elites=8", "cem_iterations=2")
# the final sparse model passed two Adam fits that train Z too, whose steps
# follow each device's summation order of the bound's gradient: its factors
# are held at the 1e-8 of tests/test_torch_sparse_episode.py against JAX
# (the card and the CPU part at ~2e-9 here); the series stay at 1e-9
SPARSE_FACTOR_TOL = 1e-8


def phase_episode_sparse(seed: int) -> dict:
    """run_experiment on the card, f32, for the two sparse configurations
    (RUNS_SPARSE): wall time, fit / calibration / ssm_update seconds,
    seconds a step, the series, the kernels' launches (counts zeroed just
    before each run; the sparse refit, the NLP and the portable CEM launch
    none); gates 0 violations, finite series, n_data
    as scheduled. Then the f64 card-vs-CPU run of pendulum_episode_sparse
    (``phase_episode_parity`` at SPARSE_PARITY_SETS)."""
    import safe_exploration_tpu_torch.runtime.episode as ep_mod
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    out = {}
    for tag, config, sets in RUNS_SPARSE:
        cfg = _episode_cfg(config, sets + [f"seed={seed}"])
        spans = {"fit": [], "calibrate": [], "update": []}
        saved = {k: getattr(ep_mod, k) for k in (
            "ssm_fit", "_calibrate_lipschitz", "ssm_update")}
        ep_mod.ssm_fit = _timed(spans["fit"], saved["ssm_fit"])
        ep_mod._calibrate_lipschitz = _timed(spans["calibrate"],
                                             saved["_calibrate_lipschitz"])
        ep_mod.ssm_update = _timed(spans["update"], saved["ssm_update"])
        try:
            for w in KERNEL_WRAPPERS:
                w.launches = 0
            t0 = time.perf_counter()
            summary = run_experiment(cfg, dtype=torch.float32, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        finally:
            for k, v in saved.items():
                setattr(ep_mod, k, v)
        series = summary["series"]
        step_s = [t / cfg.n_steps for t in series["episode_time_s"]]
        want_n = [min(cfg.n_init_samples + ep * cfg.n_steps, cfg.n_max)
                  for ep in range(cfg.n_ep)]
        finite = all(np.isfinite(v).all() for v in series.values())
        r = {"config_name": cfg.name, "config": {k: getattr(cfg, k) for k in (
                 "n_max", "n_inducing", "n_init_samples", "hyp_iters", "n_ep",
                 "n_steps", "solver")},
             "series": series, "wall_s": wall, "launches": launches,
             "fit_s": spans["fit"],
             "calibrate_s": spans["calibrate"], "update_s": spans["update"],
             "seconds_per_step": step_s}
        out[tag] = r
        print(f"[episode-sparse] ({tag}) {cfg.name} {r['config']} f32: wall "
              f"{wall:.1f} s, seconds per step {[round(v, 3) for v in step_s]}"
              f", fit s {[round(v, 3) for v in spans['fit']]}, calibrate s "
              f"{[round(v, 3) for v in spans['calibrate']]}, ssm_update s "
              f"{[round(v, 4) for v in spans['update']]}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        for key in ("violations", "feasibility_rate", "model_error",
                    "mean_cost", "n_data"):
            print(f"[episode-sparse] ({tag})   {key}: {series[key]}",
                  flush=True)
        if any(series["violations"]) or not finite:
            _fail(f"[episode-sparse] ({tag}): violations "
                  f"{series['violations']}, finite {finite}")
        if series["n_data"] != want_n:
            _fail(f"[episode-sparse] ({tag}): n_data {series['n_data']}, "
                  f"want {want_n}")
    out["parity"] = phase_episode_parity(
        seed, "pendulum_episode_sparse", SPARSE_PARITY_SETS,
        "episode-sparse", SPARSE_FACTOR_TOL)
    return out


# BASELINE config 3 as registered (pendulum_batch): the stacked fleet runner,
# 256 lanes of per-lane models (n_max 128, 24 initial points), 20 steps of
# the portable CEM on a lane axis (M 64, 12 elites, 4 iterations, H 3), every
# score through the model-batched cem_score
L_STACKED, M_STACKED, H_STACKED = 256, 64, 3
STACKED_PARITY = ("batch_lanes=8", "n_steps=3")


def _host_ms(fn) -> float:
    """Host ms of one synchronized call of ``fn`` after a warm one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _ssm_to(ssm, **kw):
    """A (stacked) GP-SSM with every tensor moved by ``Tensor.to(**kw)``."""
    def t(v):
        return None if v is None else v.to(**kw)

    gp = ssm.gp
    return ssm.replace(
        gp=gp.replace(
            x=t(gp.x), y=t(gp.y), mask=t(gp.mask),
            params=tuple({k: t(v) for k, v in p.items()} for p in gp.params),
            log_noise=t(gp.log_noise), chol=t(gp.chol), beta=t(gp.beta),
            kinv=t(gp.kinv)),
        l_mu=t(ssm.l_mu), l_sigma=t(ssm.l_sigma), z_scale=t(ssm.z_scale))


def _stacked_model(seed: int, lanes: int, n: int = N_PATH):
    """A stacked pendulum GP-SSM of ``lanes`` distinct models on the card in
    f64: per lane its own n - 7 points, signal std, noise and Lipschitz
    constants (the per-lane values a fleet carries after its per-lane
    fits; the signal and noise moved together, so every lane's Gram is as
    well conditioned as [cem-kernels]' model's), refitted by the
    model-batched refit."""
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.models.gp import gp_refit
    from safe_exploration_tpu_torch.runtime.batch import stack_ssm

    ssm = stack_ssm(gpssm_from_numpy(_cem_model(seed, n, True),
                                     ("rbf", "rbf"), device="cuda",
                                     dtype=torch.float64), lanes)
    rng = np.random.default_rng(seed + 7)
    k = n - 7
    kw = {"dtype": torch.float64, "device": "cuda"}
    raw = torch.tensor(rng.uniform(-1.0, 1.0, (lanes, k, 3)) * [0.3, 1.0, 1.0],
                       **kw)
    w = torch.tensor(rng.normal(size=(lanes, 3, 2)), **kw)
    x, y = ssm.gp.x.clone(), ssm.gp.y.clone()
    x[:, :k] = raw / ssm.z_scale[:, None, :]
    y[:, :k] = 0.02 * torch.sin(3.0 * raw @ w)
    lane = torch.arange(lanes, **kw)
    frac = (lane % 7) / 7.0
    gp = ssm.gp.replace(
        x=x, y=y,
        params=tuple({**p, "log_sf": -3.0 + 0.3 * frac} for p in ssm.gp.params),
        log_noise=(-4.0 + 0.3 * frac)[:, None].expand(lanes, 2).contiguous())
    l_mu = (0.05 * (1.0 + (lane % 5) / 5.0))[:, None].expand(lanes, 2)
    return ssm.replace(gp=gp_refit(gp), l_mu=l_mu.contiguous(),
                       l_sigma=(0.4 * l_mu).contiguous())


def phase_stacked_kernels(seed: int) -> dict:
    """The model-batched cem_score (one launch over B models, each scoring
    its own M lanes) against its plain version (the lane chain once per
    model) at pendulum_batch's shape, B 256, n 128, H 3, at M 64, a ragged
    40 and 1 (a solve's final passes), tracking (exploration too at M 64),
    distinct per-lane models (data, sf2, noise, l_mu, l_sigma), f32 (against the
    plain version in f64 on the f32-rounded inputs, 2e-4 or twice the f32
    plain version's own error where that is larger) and f64 (1e-10);
    the B = 1 stack equal to the shared model's call; CUDA-event ms, device
    ms (profiler), plain ms and the bound at each M (f32)."""
    from safe_exploration_tpu_torch.models.ssm import ssm_lane
    from safe_exploration_tpu_torch.ops.kernels import (
        prepare_tube_score,
        tube_score_plain,
        tube_score_prepared,
    )
    from safe_exploration_tpu_torch.runtime.batch import stack_ssm

    b_mod, n, t_len = L_STACKED, N_PATH, H_STACKED
    model64 = _stacked_model(seed, b_mod)
    consts, polys, target = _cem_plant(torch.float64, "cuda")
    rng = np.random.default_rng(seed + 11)
    worst, errs, timings = {}, {}, {}
    for m in (M_STACKED, 40, 1):
        L = b_mod * m
        u = 0.4 * rng.standard_normal((t_len, L))
        x0 = rng.uniform(-1.0, 1.0, (2, L)) * np.array([[0.15], [0.4]])
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            model = _ssm_to(model64, dtype=dtype)
            ref_model = _ssm_to(model, dtype=torch.float64)
            kw = {"dtype": dtype, "device": "cuda"}
            uu, xx = torch.tensor(u, **kw), torch.tensor(x0, **kw)
            err, tol = 0.0, 1e-10 if f64 else 2e-4
            # the exploration cost at the path's M only (the plain version
            # loops over the 256 models: ~2.5-5 s a call)
            kinds = ("tracking", "exploration") if m == M_STACKED else (
                "tracking",)
            for kind in kinds:
                args = (*consts, *polys, 2.0, t_len, kind,
                        {"target": target} if kind == "tracking" else {})
                prep = prepare_tube_score(model, *args)
                out = tube_score_prepared(prep, uu, xx)
                ref = tube_score_plain(ref_model, uu.double(), xx.double(),
                                       *args)
                e_kind = max(_rel(o, r) for o, r in zip(out, ref))
                err = max(err, e_kind)
                if not f64 and e_kind > 2e-4:
                    # f32: 2e-4 (the gate of [cem-kernels]), or where the
                    # plain version in f32 on the card misses that itself on
                    # these inputs (sf2 - quad cancels in any summation
                    # order), twice its error
                    own = tube_score_plain(model, uu, xx, *args)
                    tol = max(tol, *(2 * _rel(o, r) for o, r in zip(own, ref)))
                if kind == "tracking":
                    feas = float((ref[1] == 0).double().mean())
                    if not f64:
                        errs[f"m{m}"] = max(_abs(o, r)
                                            for o, r in zip(out, ref))
            worst[f"{str(dtype)[6:]}_m{m}"] = err
            print(f"[stacked-kernels] {str(dtype)[6:]} B={b_mod} M={m} n={n} "
                  f"H={t_len}: cem_score rel {err:.2e} (tol {tol:.2e}); share "
                  f"of lanes inside the constraints {feas:.3f}", flush=True)
            if err > tol:
                _fail(f"model-batched cem_score disagrees with plain at "
                      f"{dtype} M={m}: {err}")
        # f32 times at this M: the path's call (the model prepared once per
        # solve), the bound at the least work (each model's bytes once)
        dt, sz = torch.float32, 4
        model = _ssm_to(model64, dtype=dt)
        args = (*consts, *polys, 2.0, t_len, "tracking", {"target": target})
        prep = prepare_tube_score(model, *args)
        uu = torch.tensor(u, dtype=dt, device="cuda")
        xx = torch.tensor(x0, dtype=dt, device="cuda")
        ops = (b_mod * _gp_prep_ops(n) + E * L * (
            _gp_lane_ops(n, False) + (t_len - 1) * _gp_lane_ops(n, True))
            + L * _tube_ops(t_len, len(polys[1]), len(polys[3])))
        n_bytes = sz * (b_mod * (n * D_IN + E * n + E * n * n + 10 + 4 * D_IN)
                        + (t_len + 2) * L + 2 * L)
        # the plain version (a loop over the 256 models, ~2.5 s a call) is
        # timed once, warm, at the path's M only
        r = dict(ms=_time_ms(lambda: tube_score_prepared(prep, uu, xx), 20),
                 prepare_ms=_time_ms(lambda: prepare_tube_score(model, *args),
                                     10),
                 plain_ms=_host_ms(lambda: tube_score_plain(model, uu, xx,
                                                            *args))
                 if m == M_STACKED else None,
                 library_ms=None, bound=_bound_ms(n_bytes, ops, dt))
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        r["device_ms"], r["device_ms_by_kernel"] = _device_ms(
            lambda: tube_score_prepared(prep, uu, xx))
        timings[f"m{m}"] = r
        print(f"[stacked-kernels] time f32 B={b_mod} M={m}: kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), prepare "
              f"{r['prepare_ms']:.4f} ms, plain {r['plain_ms']} ms, "
              f"library null, bound {r['bound_ms']:.6f} ms ({r['bound_by']})",
              flush=True)
    # the shared call is the B = 1 case of the same entry
    one = _ssm_to(ssm_lane(model64, 3), dtype=torch.float32)
    stack1 = stack_ssm(one, 1)
    args = (*consts, *polys, 2.0, t_len, "tracking", {"target": target})
    uu = torch.tensor(0.4 * rng.standard_normal((t_len, 1000)),
                      dtype=torch.float32, device="cuda")
    xx = torch.tensor(rng.uniform(-1.0, 1.0, (2, 1000)) * [[0.15], [0.4]],
                      dtype=torch.float32, device="cuda")
    shared = tube_score_prepared(prepare_tube_score(one, *args), uu, xx)
    single = tube_score_prepared(prepare_tube_score(stack1, *args), uu, xx)
    same = all(torch.equal(a, b) for a, b in zip(shared, single))
    print(f"[stacked-kernels] B = 1 stack equal to the shared model's call: "
          f"{same}", flush=True)
    if not same:
        _fail("stacked-kernels: the B = 1 stack differs from the shared call")
    return {"worst_rel": worst, "errs": errs, "timings": timings,
            "b1_equals_shared": same}


def _stacked_step_split(exp, model, seed: int) -> dict:
    """One step's batched solve on the final stacked fleet (fresh machine
    state, states from the initial distribution, the planner's draws from
    a seeded generator): host ms without and under torch.profiler (device
    activity only), device ms, busy share and launches."""
    spec = exp["env"].spec
    lanes = model.gp.x.shape[0]
    dev, dt = model.gp.x.device, model.gp.x.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    x0 = spec.init_m + spec.init_std * torch.randn(
        (lanes, spec.n_s), generator=g, dtype=dt, device=dev)
    noise = torch.randn((lanes, *exp["batch_noise_shape"]), generator=g,
                        dtype=dt, device=dev)
    state = exp["init_state_batch"](lanes)
    exp["get_action_batch"](state, model, x0, noise=noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp["get_action_batch"](state, model, x0, noise=noise)
    torch.cuda.synchronize()
    wall_unprofiled = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp["get_action_batch"](state, model, x0, noise=noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "wall_ms_unprofiled": wall_unprofiled,
            "busy_unprofiled": device_ms / wall_unprofiled,
            "launches": sum(n for _, n in by_name.values()),
            "top": {k[:60]: round(ms, 2) for k, (ms, _) in top}}


def _nonfinite_lanes(model) -> dict:
    """Per factor, the lanes of a stacked model where it is not all
    finite ((L,) bool each)."""
    return {f: ~torch.isfinite(getattr(model.gp, f)).flatten(1).all(1)
            for f in ("chol", "beta", "kinv")}


def phase_batch_stacked(seed: int) -> dict:
    """``run_experiment`` on pendulum_batch as registered (256 lanes, n_max
    128, 24 initial points, 120 fit steps, 20 steps of the portable CEM on
    a lane axis, one O(n^2) append per lane a step), f32, counts zeroed just
    before and read just after: the JAX CLI's series, steps/s, the step's
    split into plan (get_action_batch), predict (ssm_predict) and append
    (ssm_append_point), the lanes whose model turned non-finite, cem_score's
    launches (6 a step: 4 wide passes and 2 final passes) and one step's
    solve under the profiler (busy share). Gates: 0 violations, a finite
    series but model_error (a non-finite model error only in lanes whose
    model turned non-finite), n_data 44, lane_backend 0, 6 cem_score
    launches a step, no refit kernel in the episode."""
    import safe_exploration_tpu_torch.runtime.batch as batch_mod
    from safe_exploration_tpu_torch.ops.kernels import KERNEL_WRAPPERS
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    cfg = _episode_cfg("pendulum_batch", [f"seed={seed}"])
    spans = {"plan": [], "predict": [], "append": []}
    saved = {"predict": batch_mod.ssm_predict,
             "append": batch_mod.ssm_append_point,
             "episodes": batch_mod.run_batched_episodes}
    captured = {}

    def episodes(env, get_action_batch, init_state_batch, model, *args,
                 **kw):
        # the episode's own launches (the run's less the initial fit's)
        before = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
        captured["log_noise"] = model.gp.log_noise[0].tolist()
        traj, final = saved["episodes"](
            env, _timed(spans["plan"], get_action_batch), init_state_batch,
            model, *args, **kw)
        captured.update(traj=traj, model=final, episode_launches={
            w.__name__: w.launches - before[w.__name__]
            for w in KERNEL_WRAPPERS})
        return traj, final

    batch_mod.ssm_predict = _timed(spans["predict"], saved["predict"])
    batch_mod.ssm_append_point = _timed(spans["append"], saved["append"])
    batch_mod.run_batched_episodes = episodes
    try:
        for w in KERNEL_WRAPPERS:
            w.launches = 0
        t0 = time.perf_counter()
        summary = run_experiment(cfg, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    finally:
        batch_mod.ssm_predict = saved["predict"]
        batch_mod.ssm_append_point = saved["append"]
        batch_mod.run_batched_episodes = saved["episodes"]
    series = summary["series"]
    traj, model = captured["traj"], captured["model"]
    bad = _nonfinite_lanes(model)
    bad_model = bad["chol"] | bad["beta"] | bad["kinv"]
    bad_err = ~torch.isfinite(traj["model_err"]).all(dim=1)
    nan_outside = int((bad_err & ~bad_model).sum())
    per_step = {k: 1e3 * sum(v) / len(v) for k, v in spans.items()}
    exp = build_experiment(cfg, dtype=torch.float32, device="cuda")
    step = _stacked_step_split(exp, model, seed)
    cem_launches = captured["episode_launches"]["tube_score_prepared"]
    n_data = int(model.gp.n_points.max())
    r = {"config": {k: getattr(cfg, k) for k in (
             "batch_lanes", "n_max", "n_init_samples", "hyp_iters", "n_ep",
             "n_steps", "n_safe", "cem_samples", "cem_elites",
             "cem_iterations")},
         "series": series, "wall_s": wall, "launches": launches,
         "episode_launches": captured["episode_launches"],
         "step_ms": per_step, "step_split": step, "n_data": n_data,
         "lanes_nonfinite_model": int(bad_model.sum()),
         "lanes_nonfinite_by_factor": {f: int(v.sum()) for f, v in bad.items()},
         "lanes_nan_model_error": int(bad_err.sum()),
         "log_noise_first_fit": captured["log_noise"]}
    print(f"[batch-stacked] {cfg.name} {r['config']} f32: wall {wall:.1f} s",
          flush=True)
    for key in ("lane_backend", "violations", "feasibility_rate",
                "model_error", "lanes", "steps_per_sec"):
        print(f"[batch-stacked]   {key}: {series[key]}", flush=True)
    print(f"[batch-stacked]   per step (host, synchronized): plan "
          f"(get_action_batch) {per_step['plan']:.2f} ms, predict "
          f"(ssm_predict) {per_step['predict']:.2f} ms, append "
          f"(ssm_append_point) {per_step['append']:.2f} ms; one step's solve "
          f"on the final fleet {step['wall_ms_unprofiled']:.1f} ms, "
          f"{step['wall_ms']:.1f} ms under the profiler, device "
          f"{step['device_ms']:.2f} ms (busy share {step['busy']:.3f} of the "
          f"profiled call, {step['busy_unprofiled']:.3f} of the unprofiled "
          f"one; {step['launches']} device events); top kernels by device ms "
          f"{step['top']}", flush=True)
    print(f"[batch-stacked]   launches in the run {launches}; in the episode "
          f"{captured['episode_launches']} (cem_score {cem_launches} in "
          f"{cfg.n_steps} steps)", flush=True)
    print(f"[batch-stacked]   lanes whose model turned non-finite "
          f"{r['lanes_nonfinite_model']} (by factor "
          f"{r['lanes_nonfinite_by_factor']}), lanes with a non-finite model "
          f"error {r['lanes_nan_model_error']} (of {cfg.batch_lanes}); the "
          f"first fit's log noise "
          f"{[round(v, 3) for v in r['log_noise_first_fit']]} (the jitter's "
          f"0.5 log 1e-6 = -6.908); n_data {n_data}", flush=True)
    if any(series["violations"]):
        _fail(f"batch-stacked: violations {series['violations']}")
    if not all(np.isfinite(v).all() for k, v in series.items()
               if k != "model_error") or nan_outside:
        _fail(f"batch-stacked: non-finite series {series} or {nan_outside} "
              "non-finite model errors in lanes whose model stayed finite")
    if series["lane_backend"] != [0] or n_data != cfg.n_init_samples + \
            cfg.n_steps:
        _fail(f"batch-stacked: lane_backend {series['lane_backend']}, "
              f"n_data {n_data}")
    if cem_launches != 6 * cfg.n_steps:
        _fail(f"batch-stacked: cem_score launched {cem_launches} times in "
              f"{cfg.n_steps} steps, want {6 * cfg.n_steps}")
    if any(captured["episode_launches"][w] for w in (
            "rbf_gram_masked", "cholesky_blocked", "solve_psd",
            "tri_inv_lower", "cholesky_hbm")):
        _fail(f"batch-stacked: refit kernels in the episode "
              f"{captured['episode_launches']}")
    return r


def phase_batch_stacked_parity(seed: int) -> dict:
    """f64, pendulum_batch at 8 lanes and 3 steps (1 episode, the
    registered 120 fit steps) on the card (the model-batched cem_score) and
    on the CPU (its plain version) with one set of draws from a CPU
    generator: counts and feasible flags equal, the trajectories and the
    final per-lane factors within 1e-9."""
    import safe_exploration_tpu_torch.runtime.batch as batch_mod
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    cfg = _episode_cfg("pendulum_batch", [*STACKED_PARITY, f"seed={seed}"])
    exp = build_experiment(cfg, dtype=torch.float64, device="cpu")
    spec = exp["env"].spec
    saved = batch_mod.run_batched_episodes
    out = {}
    for dev in ("cuda", "cpu"):
        rec = {}

        def episodes(*args, **kw):
            rec["traj"], rec["model"] = saved(*args, **kw)
            return rec["traj"], rec["model"]

        draws = batch_mod.batch_draws(
            torch.Generator().manual_seed(seed), spec, batch=cfg.batch_lanes,
            n_ep=cfg.n_ep, n_steps=cfg.n_steps, n_init=cfg.n_init_samples,
            n_region=128 * (spec.n_s + spec.n_u), dtype=torch.float64,
            plan_shape=exp["batch_noise_shape"])
        batch_mod.run_batched_episodes = episodes
        try:
            t0 = time.perf_counter()
            rec["summary"] = run_experiment(cfg, dtype=torch.float64,
                                            device=dev, draws=draws)
            rec["s"] = time.perf_counter() - t0
        finally:
            batch_mod.run_batched_episodes = saved
        out[dev] = rec
    g, c = out["cuda"], out["cpu"]
    gs, cs = g["summary"]["series"], c["summary"]["series"]
    counts_equal = all(gs[k] == cs[k] for k in ("violations",
                                                 "feasibility_rate"))
    flags_equal = torch.equal(g["traj"]["feasible"].cpu(),
                              c["traj"]["feasible"])
    traj = max(_rel(g["traj"][k], c["traj"][k])
               for k in ("x", "u", "resid", "model_err", "violation"))
    factors = max(_rel(getattr(g["model"].gp, f), getattr(c["model"].gp, f))
                  for f in ("chol", "beta", "kinv"))
    res = {"counts_equal": counts_equal, "flags_equal": flags_equal,
           "traj_rel": traj, "factors_rel": factors, "series_cpu": cs,
           "gpu_s": g["s"], "cpu_s": c["s"]}
    print(f"[batch-stacked-parity] f64 pendulum_batch, {cfg.batch_lanes} "
          f"lanes, {cfg.n_steps} steps: counts equal {counts_equal} "
          f"(feasibility {cs['feasibility_rate']}), feasible flags equal "
          f"{flags_equal}; trajectories rel {traj:.2e}, final per-lane "
          f"factors rel {factors:.2e} (tol 1e-9); GPU {g['s']:.1f} s, CPU "
          f"{c['s']:.1f} s", flush=True)
    if not (counts_equal and flags_equal):
        _fail(f"batch-stacked-parity: series or flags differ GPU vs CPU: "
              f"{gs} vs {cs}")
    if traj > 1e-9 or factors > 1e-9:
        _fail(f"batch-stacked-parity: trajectories {traj} or factors "
              f"{factors} differ GPU vs CPU")
    return res


# the kernels line: per Pallas kernel its name, CUDA source, the Pallas
# kernel it replaces and the wrappers whose launches count for it (trsm's
# three entries replace _trsm_kernel together)
KERNELS = (
    ("gram", "safe_exploration_tpu_torch/csrc/gram.cu",
     "safe_exploration_tpu/ops/pallas/gram.py:41", ("rbf_gram_masked",)),
    ("cholesky", "safe_exploration_tpu_torch/csrc/cholesky.cu",
     "safe_exploration_tpu/ops/pallas/cholesky.py:110", ("cholesky_blocked",)),
    ("trsm", "safe_exploration_tpu_torch/csrc/trsm.cu",
     "safe_exploration_tpu/ops/pallas/trsm.py:39",
     ("trsm_lower", "solve_psd", "tri_inv_lower")),
    ("gp_predict", "safe_exploration_tpu_torch/csrc/gp_predict.cu",
     "safe_exploration_tpu/ops/pallas/gp_predict.py:46",
     ("gp_predict_prepared",)),
    ("cem_score", "safe_exploration_tpu_torch/csrc/cem_score.cu",
     "safe_exploration_tpu/ops/pallas/cem_score.py:50",
     ("tube_score_prepared",)),
    ("cholesky_hbm", "safe_exploration_tpu_torch/csrc/cholesky_hbm.cu",
     "safe_exploration_tpu/ops/pallas/cholesky_hbm.py:52", ("cholesky_hbm",)),
)


def _partial_run(args, timed, t_start) -> int:
    """Run the phases named in ``--phases`` (after device and build) and
    write their record; a partial run prints no kernels or ok line."""
    table = {
        "kernels": (phase_kernels,), "batch-kernels": (phase_batch_kernels,),
        "cem-kernels": (phase_cem_kernels,), "path": (phase_path,),
        "parity": (phase_parity,), "cem": (phase_cem_path,),
        "cem-parity": (phase_cem_parity,),
        "stacked-kernels": (phase_stacked_kernels,),
        "batch-stacked": (phase_batch_stacked,),
        "batch-stacked-parity": (phase_batch_stacked_parity,),
        "batch": (phase_batch,),
        "batch-parity": (phase_batch_parity,),
        "cartpole-batch": (phase_batch, "cartpole_batch_sqp",
                           tuple(RUN_CART_BATCH), "cartpole-batch"),
        "cartpole-batch-parity": (phase_batch_parity, "cartpole_batch_sqp",
                                  *CART_PARITY, "cartpole-batch-parity"),
        "hbm": (phase_hbm_kernels,), "episode": (phase_episode,),
        "episode-parity": (phase_episode_parity,),
        "cartpole-episode": (phase_episode, RUNS_CARTPOLE,
                             "cartpole-episode"),
        "nlp": (phase_nlp,),
        "episode-sqp": (phase_episode, RUNS_SQP, "episode-sqp"),
        "episode-sqp-parity": (phase_episode_parity, "pendulum_episode_sqp",
                               SQP_PARITY_SETS, "episode-sqp-parity"),
        "quadrotor-batch": (phase_batch, "quadrotor_batch_sqp",
                            RUN_QUAD_BATCH, "quadrotor-batch"),
        "quadrotor-batch-parity": (phase_batch_parity, "quadrotor_batch_sqp",
                                   *QUAD_PARITY, "quadrotor-batch-parity"),
        "quadrotor-episode": (phase_episode, RUNS_QUAD, "quadrotor-episode"),
        "quadrotor-cem": (phase_quadrotor_cem,),
        "risk": (phase_risk,),
        "episode-risk": (phase_episode, RUNS_RISK, "episode-risk"),
        "sparse-kernels": (phase_sparse_kernels,),
        "sparse-refit": (phase_sparse_refit,),
        "sparse-batch": (phase_sparse_batch,),
        "sparse-cem": (phase_sparse_cem,),
        "episode-sparse": (phase_episode_sparse,),
    }
    record = {}
    for label in args.phases.split(","):
        fn, *rest = table[label]
        record[label] = timed(label, fn, args.seed, *rest)
    record["failures"] = FAILURES
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"[done] partial run of {args.phases}: {record['seconds']:.1f} s; "
          f"{len(FAILURES)} failure(s); record in {args.out}", flush=True)
    return 1 if FAILURES else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke.json"),
                    help="where the full JSON record is written")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run after device and "
                    "build, for a partial run (no kernels or ok line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import safe_exploration_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    phase_s = {}

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        phase_s[label] = time.perf_counter() - t0
        print(f"[time] {label}: {phase_s[label]:.1f} s", flush=True)
        return r

    smi = timed("device", phase_device)
    timed("build", phase_build)
    if args.phases:
        return _partial_run(args, timed, t_start)
    kern = timed("kernels", phase_kernels, args.seed)
    batch_kern = timed("batch-kernels", phase_batch_kernels, args.seed)
    cem_kern = timed("cem-kernels", phase_cem_kernels, args.seed)
    stacked_kern = timed("stacked-kernels", phase_stacked_kernels, args.seed)
    path = timed("path", phase_path, args.seed)
    parity = timed("parity", phase_parity, args.seed)
    cem = timed("cem", phase_cem_path, args.seed)
    cem_parity = timed("cem-parity", phase_cem_parity, args.seed)
    stacked = timed("batch-stacked", phase_batch_stacked, args.seed)
    stacked_parity = timed("batch-stacked-parity", phase_batch_stacked_parity,
                           args.seed)
    batch = timed("batch", phase_batch, args.seed)
    batch_parity = timed("batch-parity", phase_batch_parity, args.seed)
    cart_batch = timed("cartpole-batch", phase_batch, args.seed,
                       "cartpole_batch_sqp", tuple(RUN_CART_BATCH),
                       "cartpole-batch")
    cart_parity = timed("cartpole-batch-parity", phase_batch_parity,
                        args.seed, "cartpole_batch_sqp", *CART_PARITY,
                        "cartpole-batch-parity")
    hbm = timed("hbm", phase_hbm_kernels, args.seed)
    episode = timed("episode", phase_episode, args.seed)
    episode_parity = timed("episode-parity", phase_episode_parity, args.seed)
    cart_episode = timed("cartpole-episode", phase_episode, args.seed,
                         RUNS_CARTPOLE, "cartpole-episode")["cartpole"]
    nlp = timed("nlp", phase_nlp, args.seed)
    episode_sqp = timed("episode-sqp", phase_episode, args.seed, RUNS_SQP,
                        "episode-sqp")
    sqp_parity = timed("episode-sqp-parity", phase_episode_parity, args.seed,
                       "pendulum_episode_sqp", SQP_PARITY_SETS,
                       "episode-sqp-parity")
    quad_batch = timed("quadrotor-batch", phase_batch, args.seed,
                       "quadrotor_batch_sqp", RUN_QUAD_BATCH,
                       "quadrotor-batch")
    quad_parity = timed("quadrotor-batch-parity", phase_batch_parity,
                        args.seed, "quadrotor_batch_sqp", *QUAD_PARITY,
                        "quadrotor-batch-parity")
    quad_episode = timed("quadrotor-episode", phase_episode, args.seed,
                         RUNS_QUAD, "quadrotor-episode")["quadrotor"]
    quad_cem = timed("quadrotor-cem", phase_quadrotor_cem, args.seed)
    risk = timed("risk", phase_risk, args.seed)
    episode_risk = timed("episode-risk", phase_episode, args.seed, RUNS_RISK,
                         "episode-risk")["risk"]
    sparse_kern = timed("sparse-kernels", phase_sparse_kernels, args.seed)
    sparse_refit = timed("sparse-refit", phase_sparse_refit, args.seed)
    sparse_batch = timed("sparse-batch", phase_sparse_batch, args.seed)
    sparse_cem = timed("sparse-cem", phase_sparse_cem, args.seed)
    episode_sparse = timed("episode-sparse", phase_episode_sparse, args.seed)

    # each kernel's launches are those of the path that runs it: the refit
    # kernels' from the fleet (pendulum_batch_sqp, PR 8's main path), the
    # CEM kernels' from the CEM path, cholesky_hbm's from the episodic run
    # (b); times at that path's shapes (the refit kernels: the fleet
    # refit's 512 matrices of n = 128; gp_predict: the final B-lane passes;
    # cholesky_hbm: n = 2048, f32). The refit kernels also carry the
    # cart-pole fleet's launches, errors and times at its shape
    # ("cartpole_fleet"), and the cart-pole episode's launches; the
    # quadrotor fleet's the same at its shape ("quadrotor_fleet": 384
    # matrices of n = 96), the quadrotor and risk episodes' launches, and
    # gp_predict the quadrotor lane CEM's at d 8, e 6 ("quadrotor_cem").
    t_hbm = hbm["times"][f"float32_n{N_HBM}"]
    times = {**batch_kern["timings"],
             "gp_predict": cem_kern["timings"][f"gp_predict_L{B_CEM}"],
             "cem_score": cem_kern["timings"]["cem_score"],
             "cholesky_hbm": {"ms": t_hbm["hbm_ms"],
                              "plain_ms": t_hbm["plain_ms"],
                              "library_ms": t_hbm["library_ms"],
                              "bound_ms": t_hbm["bound_ms"],
                              "bound_by": t_hbm["bound_by"]}}
    errs = {**batch_kern["errs"], **cem_kern["errs"],
            "cholesky_hbm": hbm["max_abs_err"]}
    path_launches = {"cholesky_hbm": episode["b"]["launches"]}
    for short in cem_kern["errs"]:
        path_launches[short] = cem["launches"]
    kernels = []
    for short, source, replaces, wrappers in KERNELS:
        r = times[short]
        counts = path_launches.get(short, batch["launches"])
        entry = {
            "name": short, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(counts.get(w, 0) for w in wrappers),
            "max_abs_err": errs[short], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if len(wrappers) > 1:
            entry["entries"] = list(wrappers)
        if short in batch_kern["timings_cartpole"]:
            rc = batch_kern["timings_cartpole"][short]
            entry["cartpole_fleet"] = {
                "launches": sum(cart_batch["launches"].get(w, 0)
                                for w in wrappers),
                "max_abs_err": batch_kern["errs_cartpole"][short],
                **{k: rc[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
            entry["cartpole_episode_launches"] = sum(
                cart_episode["launches"].get(w, 0) for w in wrappers)
            entry["cartpole_episode_max_abs_err"] = batch_kern[
                "errs_cartpole_episode"][short]
            entry["episode_sqp_launches"] = {
                episode_sqp[tag]["config_name"]: sum(
                    episode_sqp[tag]["launches"].get(w, 0) for w in wrappers)
                for tag in episode_sqp}
            rq = batch_kern["timings_quadrotor"][short]
            entry["quadrotor_fleet"] = {
                "launches": sum(quad_batch["launches"].get(w, 0)
                                for w in wrappers),
                "max_abs_err": batch_kern["errs_quadrotor"][short],
                **{k: rq[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
            entry["quadrotor_episode_launches"] = sum(
                quad_episode["launches"].get(w, 0) for w in wrappers)
            entry["quadrotor_episode_max_abs_err"] = batch_kern[
                "errs_quadrotor_episode"][short]
            entry["episode_risk_launches"] = sum(
                episode_risk["launches"].get(w, 0) for w in wrappers)
        if short in ("gp_predict", "cem_score"):
            # the sparse posterior: m 256 on the sparse lane CEM's path, m 32
            # pendulum_episode_sparse's (its portable CEM launches neither)
            for m, counts in ((M_SPARSE,
                               sparse_cem["launches"]["auto_card_f32"]),
                              (M_SPARSE_EP,
                               episode_sparse["episode"]["launches"])):
                rs = sparse_kern["timings"][f"{short}_m{m}"]
                entry[f"sparse_m{m}"] = {
                    "launches": sum(counts.get(w, 0) for w in wrappers),
                    "max_abs_err": sparse_kern["errs"][f"{short}_m{m}"],
                    **{k: rs[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}
        if short == "cem_score":
            # pendulum_batch's stacked fleet: every score model-batched (B
            # 256 per-lane models, M 64 lanes each, n 128, H 3)
            rs = stacked_kern["timings"][f"m{M_STACKED}"]
            entry["pendulum_batch"] = {
                "launches": stacked["episode_launches"]["tube_score_prepared"],
                "max_abs_err": stacked_kern["errs"][f"m{M_STACKED}"],
                **{k: rs[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
        if short == "gp_predict":
            rq = cem_kern["timings"]["gp_predict_quadrotor"]
            entry["quadrotor_cem"] = {
                "launches": quad_cem["gp_predict_launches"]["auto_card_f32"],
                "max_abs_err": cem_kern["errs"]["gp_predict_quadrotor"],
                **{k: rq[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
        kernels.append(entry)
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": kernels,
              "kernel_times": {str(n): v for n, v in kern["timings"].items()},
              "cem_kernel_times": cem_kern["timings"],
              "cem_kernel_worst_rel_f32": cem_kern["worst_rel_f32"],
              "path": path, "parity": parity, "cem_path": cem,
              "cem_parity": cem_parity, "stacked_kernels": stacked_kern,
              "batch_stacked": stacked,
              "batch_stacked_parity": stacked_parity,
              "hbm": hbm, "episode": episode,
              "episode_parity": episode_parity,
              "batch_kernel_times": batch_kern["timings"], "batch": batch,
              "batch_parity": batch_parity,
              "batch_kernel_times_cartpole": batch_kern["timings_cartpole"],
              "cartpole_batch": cart_batch,
              "cartpole_batch_parity": cart_parity,
              "cartpole_episode": cart_episode, "nlp": nlp,
              "episode_sqp": episode_sqp, "episode_sqp_parity": sqp_parity,
              "batch_kernel_times_quadrotor": batch_kern["timings_quadrotor"],
              "quadrotor_batch": quad_batch,
              "quadrotor_batch_parity": quad_parity,
              "quadrotor_episode": quad_episode, "quadrotor_cem": quad_cem,
              "risk": risk, "episode_risk": episode_risk,
              "sparse_kernels": sparse_kern, "sparse_refit": sparse_refit,
              "sparse_batch": sparse_batch, "sparse_cem": sparse_cem,
              "episode_sparse": episode_sparse,
              "phase_s": phase_s,
              "failures": FAILURES,
              "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[done] {record['seconds']:.1f} s; record in {args.out}", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

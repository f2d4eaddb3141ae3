#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``safe_exploration_tpu_torch/csrc``,
holds each against its plain PyTorch version, drives the port's main path
(the batched lane SQP safe-MPC on the pendulum at H=5, B=512, with GP refits
through the kernels) and checks the GPU against the CPU in f64.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases (any failure exits non-zero, without the final ``ok`` line):
  1. device   card name and power limit (nvidia-smi), CUDA and torch versions
  2. build    nvcc for every kernel source, all at once
  3. kernels  every kernel against its plain version at the main path's shapes
              (e=2, n=128; L^-1 with m=128, beta with m=1), at n=512 and at a
              ragged n=200, in f32 and f64; NaN on an indefinite input; CUDA-
              event times of kernel, plain version and the torch.linalg call
  4. path     build_experiment at the headline budget, a GP refit, two batched
              get_action_batch calls around a plant step and an ssm_update
              (a second refit); launch counts are zeroed just before and read
              just after
  5. parity   the refit factors and the first get_action_batch in f64 at B=16
              on the GPU (kernels) and on the CPU (plain versions)

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
    """L read once, B read once, X written once, for the E matrices."""
    return E * (n * n + 2 * n * m) * sz


def _gram_args(rng, n, dtype, device):
    x = rng.uniform(-1.0, 1.0, (n, D_IN))
    mask = (np.arange(n) < n - 7).astype(np.float64)   # ragged valid prefix
    log_ls = rng.normal(-0.5, 0.3, (E, D_IN))
    log_sf = np.array([-3.0, -2.5])
    noise = np.exp(2.0 * np.array([-4.0, -3.8]))
    return [torch.tensor(a, dtype=dtype, device=device)
            for a in (x, mask, log_ls, log_sf, noise)]


def phase_kernels(seed: int) -> dict:
    """Correctness at every shape and dtype, then times at the path shape
    and at n=512 (f32, the path's dtype)."""
    from safe_exploration_tpu_torch.ops.kernels import (
        cholesky_blocked,
        cholesky_plain,
        gram_plain,
        rbf_gram_masked,
        trsm_lower,
        trsm_plain,
    )

    rng = np.random.default_rng(seed)
    errs = {"gram": 0.0, "cholesky": 0.0, "trsm": 0.0}
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        for n in (N_PATH, 200, 512):
            args = _gram_args(rng, n, dtype, "cuda")
            args64 = [a.double() for a in args]
            k = rbf_gram_masked(*args)
            kp = gram_plain(*args)
            e_g = _rel(k, kp)
            k64 = gram_plain(*args64)
            l = cholesky_blocked(k64.to(dtype))
            l64 = cholesky_plain(k64)
            e_c = _rel(l, l64)
            y = torch.tensor(rng.normal(size=(E, n, 1)), device="cuda")
            eye = torch.eye(n, dtype=torch.float64, device="cuda").expand(E, n, n)
            e_t, a_t = 0.0, 0.0
            for b, transpose in ((y, False), (y, True), (eye.contiguous(), False)):
                x = trsm_lower(l64.to(dtype), b.to(dtype).contiguous(), transpose)
                xp = trsm_plain(l64, b, transpose)
                e_t, a_t = max(e_t, _rel(x, xp)), max(a_t, _abs(x, xp))
            tol_g, tol_ct = (1e-10, 1e-10) if f64 else (1e-5, 2e-4)
            print(f"[kernels] {str(dtype)[6:]} e={E} n={n}: gram rel {e_g:.2e} "
                  f"(tol {tol_g:g}), cholesky rel {e_c:.2e}, trsm rel {e_t:.2e} "
                  f"(tol {tol_ct:g})", flush=True)
            if not (e_g <= tol_g and e_c <= tol_ct and e_t <= tol_ct):
                _fail(f"kernel disagrees with plain at {dtype} n={n}")
            if dtype == torch.float32 and n == N_PATH:
                errs = {"gram": _abs(k, kp), "cholesky": _abs(l, l64),
                        "trsm": a_t}
    bad = gram_plain(*_gram_args(rng, 200, torch.float64, "cuda"))
    bad[:, 150, 150] = -1.0
    l_bad = cholesky_blocked(bad)
    nan_ok = bool(torch.isnan(l_bad).any()) and bool(
        torch.isfinite(l_bad[:, :150, :150]).all())
    print(f"[kernels] indefinite input -> NaN from the bad pivot on: {nan_ok}",
          flush=True)
    if not nan_ok:
        _fail("cholesky does not give NaN on an indefinite input")

    timings = {}
    for n in (N_PATH, 512):
        dt = torch.float32
        sz = 4
        args = _gram_args(rng, n, dt, "cuda")
        k = rbf_gram_masked(*args)
        l = cholesky_blocked(k)
        y = torch.tensor(rng.normal(size=(E, n, 1)), dtype=dt, device="cuda")
        eye = torch.eye(n, dtype=dt, device="cuda").expand(E, n, n).contiguous()
        reps, preps = (50, 3) if n == N_PATH else (20, 1)

        def trsm_refit(solve):
            z = solve(l, y, False)
            solve(l, z, True)
            solve(l, eye, False)

        def lib_solve(lm, b, transpose):
            if transpose:
                return torch.linalg.solve_triangular(lm.mT, b, upper=True)
            return torch.linalg.solve_triangular(lm, b, upper=False)

        in_bytes = (n * D_IN + n + 2 * E * D_IN) * sz
        t = {
            "gram": dict(
                ms=_time_ms(lambda: rbf_gram_masked(*args), reps),
                plain_ms=_time_ms(lambda: gram_plain(*args), reps),
                library_ms=None,
                bound=_bound_ms(in_bytes + E * n * n * sz,
                                E * n * n * (2 * D_IN + 7), dt),
            ),
            "cholesky": dict(
                ms=_time_ms(lambda: cholesky_blocked(k), reps),
                plain_ms=_time_ms(lambda: cholesky_plain(k), preps),
                library_ms=_time_ms(lambda: torch.linalg.cholesky_ex(k), reps),
                bound=_bound_ms(2 * E * n * n * sz, E * n ** 3 / 3, dt),
            ),
            # one refit's three solves: beta forward + backward (m = 1) and
            # L^-1 (m = n)
            "trsm": dict(
                ms=_time_ms(lambda: trsm_refit(trsm_lower), reps),
                plain_ms=_time_ms(lambda: trsm_refit(trsm_plain), preps),
                library_ms=_time_ms(lambda: trsm_refit(lib_solve), reps),
                bound=_bound_ms(
                    sum(_trsm_bytes(n, m, sz) for m in (1, 1, n)),
                    sum(E * n * n * m for m in (1, 1, n)), dt),
            ),
        }
        for name, r in t.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"[kernels] time f32 n={n} {name}: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {lib} ms, bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
        timings[n] = t
    return {"errs": errs, "timings": timings}


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


def _bench_ssm(exp, xs, us, resid, dtype, device):
    """bench.py's model: GP-SSM on raw inputs, l_mu 0.05, l_sigma 0.02,
    log_noise -4, then log_sf = -3 for every dim and a refit."""
    from safe_exploration_tpu_torch.models import gp_refit, make_gp_ssm

    def full(v):
        return torch.full((2,), v, dtype=dtype, device=device)

    ssm = make_gp_ssm(exp["kern_types"], xs, us, resid, n_max=N_PATH,
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

    cfg, k_fb = sl.SqpConfig(n_safe=5), exp["k_fb"].tolist()
    a, b = exp["a"].tolist(), exp["b"].tolist()
    s_lift = torch.cat([torch.eye(2, dtype=x0.dtype, device=x0.device),
                        exp["k_fb"]], 0)
    bmat = (s_lift.T @ s_lift).tolist()
    rows = [x0[:, i] for i in range(2)]
    u = torch.movedim(warm.reshape(x0.shape[0], -1), 0, -1).contiguous()

    def roll(v, k=1):
        return sl._rollout_y_lanes(ssm, v, [r.repeat(k) for r in rows], k_fb,
                                   a, b, cfg, bmat)

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
    launches = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
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


SOURCES = {
    "rbf_gram_masked": ("safe_exploration_tpu_torch/csrc/gram.cu",
                        "safe_exploration_tpu/ops/pallas/gram.py:41"),
    "cholesky_blocked": ("safe_exploration_tpu_torch/csrc/cholesky.cu",
                         "safe_exploration_tpu/ops/pallas/cholesky.py:110"),
    "trsm_lower": ("safe_exploration_tpu_torch/csrc/trsm.cu",
                   "safe_exploration_tpu/ops/pallas/trsm.py:39"),
}
SHORT = {"rbf_gram_masked": "gram", "cholesky_blocked": "cholesky",
         "trsm_lower": "trsm"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke.json"),
                    help="where the full JSON record is written")
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
    smi = phase_device()
    phase_build()
    kern = phase_kernels(args.seed)
    path = phase_path(args.seed)
    parity = phase_parity(args.seed)

    t = kern["timings"][N_PATH]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        short = SHORT[name]
        r = t[short]
        kernels.append({
            "name": short, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path["launches"][name],
            "max_abs_err": kern["errs"][short], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": kernels,
              "kernel_times": {str(n): v for n, v in kern["timings"].items()},
              "path": path, "parity": parity, "failures": FAILURES,
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

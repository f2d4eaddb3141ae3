"""Host-clock milliseconds of the single-instance NLP's rollout Jacobian
(the Gauss-Newton step's ``Jy``) in each derivative form, and of one
planner solve, on the two episodic SQP configurations:

    PYTHONPATH=. python safe_exploration_tpu_torch/solvers/nlp_times.py

f32, on CUDA unless ``--device cpu``; each configuration's first model
(its initial points from a CPU generator seeded 0, fitted and calibrated)
at x0 = 0.3 of the safe box, the decision vector at zero. Forms:

  reverse   ``solvers/sqp._rollout_jacobian``: one backward pass through
            ny folded copies of the rollout (what the solver takes)
  jacfwd    ``torch.func.jacfwd`` over the n_var tangents (the JAX
            package's form)
  dual      forward-mode dual tensors over n_var folded copies

and the rollout alone (``outputs``) for scale. Each is timed five times
after a warm call; one JSON line goes to stdout, with the largest
difference of each form's Jacobian from ``reverse`` and, on CUDA, the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.autograd.forward_ad as fwAD

from safe_exploration_tpu_torch.models import ssm_bucketed
from safe_exploration_tpu_torch.models.ssm import calibrate_lipschitz, ssm_fit
from safe_exploration_tpu_torch.runtime.config import CONFIGS, build_experiment
from safe_exploration_tpu_torch.runtime.episode import collect_initial_data
from safe_exploration_tpu_torch.solvers import sqp


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _ms(fn, device: str, reps: int = 5) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def _dual_jacobian(fn, u):
    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(u.expand(n, n).clone(), eye))
        return fwAD.unpack_dual(out).tangent.transpose(0, 1)


def _case(name: str, device: str) -> dict:
    cfg = CONFIGS[name]
    exp = build_experiment(cfg, dtype=torch.float32, device=device)
    spec = exp["env"].spec
    gen = torch.Generator().manual_seed(0)
    xs, us, r = collect_initial_data(exp["env"], cfg.n_init_samples,
                                     exp["a"], exp["b"], exp["k_fb"],
                                     generator=gen)
    ssm = ssm_bucketed(calibrate_lipschitz(
        ssm_fit(exp["make_ssm"](xs, us, r), iters=cfg.hyp_iters), spec,
        generator=gen))
    x0 = 0.3 * spec.h_safe[:spec.n_s]
    scfg = sqp.SqpConfig(n_safe=cfg.n_safe, c_safety=cfg.c_safety,
                         n_perf=cfg.n_perf, r_shared=cfg.r_shared,
                         perf_method=cfg.perf_trajectory)
    k_fb = exp["k_fb"]
    _, _, outputs, _, _ = sqp._build_constraint_fn(
        ssm, x0, k_fb.expand(cfg.n_safe, *k_fb.shape), exp["a"], exp["b"],
        scfg, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
        exp["cost_fn"])
    n_warm = sqp.sqp_warm_len(scfg)
    u = torch.zeros(n_warm * spec.n_u, dtype=torch.float32, device=device)
    ny = outputs(u).shape[-1]
    forms = {
        "reverse": lambda: sqp._rollout_jacobian(outputs, u, ny)[0],
        "jacfwd": lambda: torch.func.jacfwd(outputs)(u),
        "dual": lambda: _dual_jacobian(outputs, u),
    }
    ref = forms["reverse"]().double()
    warm = torch.zeros((n_warm, spec.n_u), dtype=torch.float32,
                       device=device)
    out = {"n_var": u.shape[0], "ny": ny,
           "outputs_ms": _ms(lambda: outputs(u), device)}
    for form, fn in forms.items():
        out[f"{form}_ms"] = _ms(fn, device)
        out[f"{form}_max_diff"] = float((fn().double() - ref).abs().max())
    out["solve_ms"] = _ms(lambda: exp["planner"](None, ssm, x0, warm),
                          device, reps=1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = {name: _case(name, args.device)
           for name in ("pendulum_episode_sqp", "cartpole_episode_sqp")}
    if args.device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

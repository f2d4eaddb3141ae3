"""Which f32 factors make the quadrotor fleet's lane models diverge.

quadrotor_batch_sqp fits a log noise of about -7.7 on its 40 initial
points, so the noise variance (~2e-7) lies below the refit's 1e-6 jitter
and the f32 lane append (``lane_append_point``) amplifies the rounding of
the first model's K^-1 until some lanes' models leave the episode
non-finite. This script runs the first episode (64 lanes, 8 steps, f32, the
draws of a CPU generator seeded 0, as ``chip_smoke.py [quadrotor-batch]``)
on the card from one set of hyperparameters with the factors (beta, K^-1)
taken five ways:

  * ``kernels``: refit on the card (the gram, cholesky and trsm kernels);
  * ``plain``: refit on the CPU (the kernels' plain versions);
  * ``f64``: refit in f64 on the CPU, cast to f32;
  * ``kernels, K^-1 plain``: the kernels' beta with the plain K^-1;
  * ``plain, K^-1 kernels``: the plain beta with the kernels' K^-1.

It does so for the first model fitted on the card and the one fitted on the
CPU, and prints per variant the largest error of K^-1 and beta against the
f64 refit (relative to its largest entry, per output dim), the largest
asymmetry of K^-1, the lanes whose model left the episode non-finite and
the feasible share per step. Needs a CUDA card:

    python3 scripts/fleet_factor_divergence.py [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from safe_exploration_tpu_torch.envs.base import env_reset  # noqa: E402
from safe_exploration_tpu_torch.models import gp_lanes  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as ssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    gpssm_from_numpy,
    gpssm_to_numpy,
)
from safe_exploration_tpu_torch.models.gp import gp_refit  # noqa: E402
from safe_exploration_tpu_torch.runtime import batch, episode  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)

CFG = CONFIGS["quadrotor_batch_sqp"]
KERN = ("rbf",) * 6
N_REGION = 128 * 8


def first_model(dev: str):
    """The configuration's first f32 model fitted on ``dev`` (numpy arrays)
    and the run's draws, moved to the card."""
    exp = build_experiment(CFG, dtype=torch.float32, device=dev)
    spec = exp["env"].spec
    d = batch.batch_draws(
        torch.Generator().manual_seed(0), spec, batch=CFG.batch_lanes,
        n_ep=CFG.n_ep, n_steps=CFG.n_steps, n_init=CFG.n_init_samples,
        n_region=N_REGION, dtype=torch.float32)
    d = {k: v.to(dev) for k, v in d.items()}
    data = episode.collect_initial_data(
        exp["env"], CFG.n_init_samples, exp["a"], exp["b"], exp["k_fb"],
        draws=d)
    m = ssm_mod.calibrate_lipschitz(
        ssm_mod.ssm_fit(exp["make_ssm"](*data), iters=CFG.hyp_iters), spec,
        n_region=N_REGION, draws=(d["region_x"], d["region_u"]))
    return gpssm_to_numpy(m), {k: v.to("cuda") for k, v in d.items()}


def refit(arrays: dict, dev: str, dtype) -> dict:
    m = gpssm_from_numpy(arrays, KERN, device=dev, dtype=dtype)
    return gpssm_to_numpy(m.replace(gp=gp_refit(m.gp)))


def errors(arrays: dict, truth: dict) -> dict:
    n = int(np.asarray(arrays["mask"]).sum())
    k = np.asarray(arrays["kinv"], np.float64)[:, :n, :n]
    kt = np.asarray(truth["kinv"], np.float64)[:, :n, :n]
    b = np.asarray(arrays["beta"], np.float64)[:, :n]
    bt = np.asarray(truth["beta"], np.float64)[:, :n]
    return {
        "kinv_rel": [float(np.abs(k[i] - kt[i]).max() / np.abs(kt[i]).max())
                     for i in range(k.shape[0])],
        "beta_rel": [float(np.abs(b[i] - bt[i]).max() / np.abs(bt[i]).max())
                     for i in range(b.shape[0])],
        "kinv_asym": [float(np.abs(k[i] - k[i].T).max() / np.abs(k[i]).max())
                      for i in range(k.shape[0])]}


def run_episode(arrays: dict, d: dict) -> dict:
    """Episode 0 on the card from ``arrays`` (cast to f32)."""
    exp = build_experiment(CFG, dtype=torch.float32, device="cuda")
    m = gpssm_from_numpy(arrays, KERN, device="cuda", dtype=torch.float32)
    lanes, steps = CFG.batch_lanes, CFG.n_steps
    view = gp_lanes.lane_shrink_to_bucket(
        gp_lanes.lane_stack_ssm(m, lanes), n_free=steps)
    x0 = env_reset(exp["env"], batch=(lanes,), noise=d["reset"][0])
    t0 = time.perf_counter()
    traj, fin = batch.run_batched_episodes_lanes(
        exp["env"], exp["get_action_batch"], exp["init_state_batch"], view,
        x0, steps, exp["a"], exp["b"], step_noise=d["step"][0])
    torch.cuda.synchronize()
    g = fin.gp
    bad = ~(torch.isfinite(g.beta).all(dim=(0, 1))
            & torch.isfinite(g.kinv).all(dim=(0, 1, 2)))
    feas = traj["feasible"].double().cpu()
    return {"s": time.perf_counter() - t0, "diverged": int(bad.sum()),
            "feasible": float(feas.mean()),
            "feasible_per_step": feas.mean(dim=0).tolist()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        "build", "fleet_factor_divergence.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    record = {}
    for fit_on in ("cuda", "cpu"):
        arrays, d = first_model(fit_on)
        truth = refit(arrays, "cpu", torch.float64)
        kern = refit(arrays, "cuda", torch.float32)
        plain = refit(arrays, "cpu", torch.float32)
        variants = {
            "kernels": kern, "plain": plain, "f64": truth,
            "kernels, K^-1 plain": {**kern, "kinv": plain["kinv"]},
            "plain, K^-1 kernels": {**plain, "kinv": kern["kinv"]}}
        for name, a in variants.items():
            r = {**errors(a, truth), **run_episode(a, d),
                 "log_noise": np.asarray(arrays["log_noise"]).tolist()}
            record[f"fit on {fit_on}, {name}"] = r
            print(f"fit on {fit_on}, {name}: K^-1 err max "
                  f"{max(r['kinv_rel']):.2e}, beta err max "
                  f"{max(r['beta_rel']):.2e}, K^-1 asymmetry max "
                  f"{max(r['kinv_asym']):.2e}; diverged lanes "
                  f"{r['diverged']} of {CFG.batch_lanes}, feasible "
                  f"{r['feasible']:.4f}, per step "
                  f"{np.round(r['feasible_per_step'], 3).tolist()}",
                  flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Why the MC-dropout configurations fall back at every step: the
calibrated Lipschitz constants or the network's variance.

``pendulum_episode_mcdropout`` and ``pendulum_episode_concrete`` report
feasibility 0.0 in every episode, in the port and in the JAX CLI. This
script builds each configuration's first model (fitted and calibrated, as
the episodic runner builds it) at a small buffer, then asks the safe
controller for a first action at three start states (the episode's reset
state, the origin and 0.3 x the reset state) with the model changed one
way at a time:

  * ``calibrated``: as built;
  * ``l_mu=0`` / ``l_sigma=0``: one calibrated constant set to zero;
  * ``l=0``: both set to zero;
  * ``var*1e-4``: the network's predictive variance scaled by 1e-4;
  * ``l=0,var*1e-4``: both changes.

It prints the calibrated constants, the network's predictive and noise
standard deviations at the origin, and per case the solve's
(feasible, summed violation) at each state:

    python scripts/mc_tube_infeasibility.py [--device cpu] \\
        [--set n_max=64 n_init_samples=20 cem_samples=32 cem_elites=8 \\
               cem_iterations=3]
"""

from __future__ import annotations

import argparse
import json

import torch

import safe_exploration_tpu_torch.models.nn_ssm as nn_ssm
import safe_exploration_tpu_torch.models.ssm as ssm_mod
from safe_exploration_tpu_torch.envs.base import env_reset
from safe_exploration_tpu_torch.runtime.config import CONFIGS, build_experiment
from safe_exploration_tpu_torch.runtime.episode import (
    episode_draws,
    first_model,
)
from safe_exploration_tpu_torch.runtime.main import _apply_overrides

SETS = ["n_max=64", "n_init_samples=20", "cem_samples=32", "cem_elites=8",
        "cem_iterations=3"]
_JAC, _LATENT = ssm_mod.mc_predict_mean_jac, nn_ssm.McDropoutSSM.predict_latent


def _scale_variance(factor: float) -> None:
    """Scale the MC network's predictive variance by ``factor`` wherever
    the planner and the tube read it."""
    def jac(model, z):
        mu, var, j = _JAC(model, z)
        return mu, var * factor, j

    def latent(model, z):
        mu, var = _LATENT(model, z)
        return mu, var * factor

    ssm_mod.mc_predict_mean_jac = jac
    nn_ssm.McDropoutSSM.predict_latent = latent


def probe(name: str, sets: list[str], device: str) -> dict:
    cfg = _apply_overrides(CONFIGS[name], sets)
    exp = build_experiment(cfg, dtype=torch.float64, device=device)
    spec = exp["env"].spec
    draws = episode_draws(
        torch.Generator().manual_seed(cfg.seed), spec, n_ep=1, n_steps=1,
        n_init=cfg.n_init_samples, n_region=128 * (spec.n_s + spec.n_u),
        plan_shape=exp["planner_noise_shape"], dtype=torch.float64,
        ssm_shapes=exp["ssm_draw_shapes"])
    draws = {k: v.to(device) for k, v in draws.items()}
    model = first_model(exp["env"], exp["a"], exp["b"], exp["k_fb"], draws,
                        exp["make_ssm"], n_init=cfg.n_init_samples,
                        hyp_iters=cfg.hyp_iters)
    x_reset = env_reset(exp["env"], noise=draws["reset"][0])
    states = [x_reset, torch.zeros_like(x_reset), 0.3 * x_reset]
    origin = torch.zeros((spec.n_s + spec.n_u,), dtype=torch.float64,
                         device=device)
    _, var = model.predict_latent(origin)
    zero = {"l_mu": 0.0 * model.l_mu, "l_sigma": 0.0 * model.l_sigma}
    cases = {"calibrated": ({}, 1.0), "l_mu=0": ({"l_mu": zero["l_mu"]}, 1.0),
             "l_sigma=0": ({"l_sigma": zero["l_sigma"]}, 1.0),
             "l=0": (zero, 1.0), "var*1e-4": ({}, 1e-4),
             "l=0,var*1e-4": (zero, 1e-4)}
    out = {"l_mu": model.l_mu.tolist(), "l_sigma": model.l_sigma.tolist(),
           "sd_at_origin": var.sqrt().tolist(),
           "noise_sd": model.noise_var().sqrt().tolist()}
    try:
        for case, (changes, factor) in cases.items():
            _scale_variance(factor)
            m = model.replace(**changes) if changes else model
            res = []
            for x in states:
                _, _, info = exp["get_action"](
                    torch.Generator().manual_seed(1), exp["init_state"](), m,
                    x)
                res.append([bool(info["feasible"]),
                            float(info["violation"])])
            out[case] = res
    finally:
        ssm_mod.mc_predict_mean_jac = _JAC
        nn_ssm.McDropoutSSM.predict_latent = _LATENT
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--set", nargs="*", default=SETS, metavar="KEY=VALUE")
    args = ap.parse_args()
    for name in ("pendulum_episode_mcdropout", "pendulum_episode_concrete"):
        print(json.dumps({"config": name, "sets": args.set,
                          **probe(name, args.set, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Episodic plan -> act -> update-GP loop — port of
``safe_exploration_tpu/runtime/episode.py``.

Collect initial safe samples, fit the GP's hyperparameters and calibrate
its Lipschitz constants, then for each episode run ``n_steps`` of
``get_action`` / ``env_step`` on a bucketed view of the model, append the
episode's transitions (one batched refit) and fit again; log per-episode
metrics. The JAX package scans an episode as one compiled program; here an
episode is a Python loop over steps whose only read-back is the single-
instance SafeMPC machine's branch on the solve's feasibility.

Random streams: where the JAX package splits keys, the port makes every
draw of a run up front from one ``torch.Generator`` (:func:`episode_draws`;
a CPU generator gives the same run on the CPU and on the GPU) or takes them
from the caller as ``draws``, a dict of tensors:

  ``init_x`` (n_init, n_s), ``init_u`` (n_init, n_u)  uniform on [-1, 1)
  ``init_noise`` (n_init, n_s)                       plant noise, N(0, 1)
  ``region_x`` (n_region, n_s), ``region_u`` (n_region, n_u)  uniform on
      [0, 1): the Lipschitz region probes, the same at every calibration
  ``reset`` (n_ep, n_s)                              N(0, 1)
  ``plan`` (n_ep, n_steps, ...)   each solve's planner draws (optional:
      without it the planner draws from ``generator``)
  ``step`` (n_ep, n_steps, n_s)                      plant noise, N(0, 1)
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from safe_exploration_tpu_torch.envs.base import Env, env_reset, env_step
from safe_exploration_tpu_torch.models.ssm import (
    calibrate_lipschitz as _calibrate_lipschitz,
    make_gp_ssm,
    ssm_bucketed,
    ssm_fit,
    ssm_n_points,
    ssm_predict,
    ssm_update,
)
from safe_exploration_tpu_torch.solvers.safempc import SafeMPCState

__all__ = ["collect_initial_data", "episode_draws", "rollout_episode",
           "run_episodic"]


def episode_draws(generator: torch.Generator, spec, *, n_ep: int,
                  n_steps: int, n_init: int, n_region: int,
                  plan_shape: tuple | None, dtype) -> dict:
    """Every draw of one run from ``generator``, made on its device in a
    fixed order (keys as in the module docstring; ``plan`` only when the
    planner's draw shape ``plan_shape`` is given)."""
    n_s, n_u = spec.n_s, spec.n_u
    kw = {"generator": generator, "dtype": dtype, "device": generator.device}

    def sym(*shape):
        return 2.0 * torch.rand(shape, **kw) - 1.0

    draws = {"init_x": sym(n_init, n_s), "init_u": sym(n_init, n_u),
             "init_noise": torch.randn((n_init, n_s), **kw),
             "region_x": torch.rand((n_region, n_s), **kw),
             "region_u": torch.rand((n_region, n_u), **kw),
             "reset": torch.randn((n_ep, n_s), **kw),
             "step": torch.randn((n_ep, n_steps, n_s), **kw)}
    if plan_shape is not None:
        draws["plan"] = torch.randn((n_ep, n_steps, *plan_shape), **kw)
    return draws


def collect_initial_data(env: Env, n_samples: int, a: torch.Tensor,
                         b: torch.Tensor, k_fb: torch.Tensor, *,
                         generator: torch.Generator | None = None,
                         draws: dict | None = None, u_perturb: float = 0.3):
    """Initial safe transitions: states uniform in half the safe box, the
    stabilizing LQR control plus a uniform perturbation, one plant step.
    ``draws`` (``init_x``, ``init_u``, ``init_noise``) replaces the draws of
    ``generator``. Returns (x (n, n_s), u (n, n_u), residuals (n, n_s))."""
    spec = env.spec
    kw = {"dtype": a.dtype, "device": a.device}
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = episode_draws(generator, spec, n_ep=0, n_steps=0,
                              n_init=n_samples, n_region=0, plan_shape=None,
                              dtype=a.dtype)
    ux, uu, noise = (draws[k].to(**kw) for k in ("init_x", "init_u",
                                                 "init_noise"))
    box = spec.h_safe[: spec.n_s]
    xs = ux * 0.5 * box
    u_noise = uu * u_perturb * spec.u_max
    us = torch.clamp(xs @ k_fb.T + u_noise, spec.u_min, spec.u_max)
    u_app, x_next = env_step(env, xs, us, noise=noise)
    resid = x_next - (xs @ a.T + u_app @ b.T)
    return xs, u_app, resid


def rollout_episode(env: Env, get_action: Callable, mpc_state: SafeMPCState,
                    ssm, x0: torch.Tensor, n_steps: int, a: torch.Tensor,
                    b: torch.Tensor, *, generator=None, plan_noise=None,
                    step_noise=None):
    """One episode, step by step. ``plan_noise`` (n_steps, ...) and
    ``step_noise`` (n_steps, n_s) replace the draws of ``generator``.

    Returns (traj, final mpc_state, final x); traj holds per-step (x, u,
    x_next, resid, model_err, feasible, violation, constraint_ok), stacked
    on the device."""
    spec = env.spec
    x, mstate = x0, mpc_state
    steps = []
    for t in range(n_steps):
        u, mstate, info = get_action(
            generator, mstate, ssm, x,
            noise=None if plan_noise is None else plan_noise[t])
        u_app, x_next = env_step(
            env, x, u, generator=generator,
            noise=None if step_noise is None else step_noise[t])
        resid = x_next - (a @ x + b @ u_app)
        # model error under the episode's frozen model: |resid - mu(x, u)|
        mu_pred, _ = ssm_predict(ssm, x, u_app)
        steps.append({
            "x": x, "u": u_app, "x_next": x_next, "resid": resid,
            "model_err": torch.linalg.vector_norm(resid - mu_pred),
            "feasible": info["feasible"], "violation": info["violation"],
            "constraint_ok": torch.all(spec.h_mat_obs @ x_next - spec.h_obs
                                       <= 0.0),
        })
        x = x_next
    traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return traj, mstate, x


def run_episodic(
    env: Env,
    init_state: Callable,
    get_action: Callable,
    a: torch.Tensor,
    b: torch.Tensor,
    k_fb: torch.Tensor,
    *,
    kern_types: tuple,
    n_max: int,
    l_mu: torch.Tensor,
    l_sigma: torch.Tensor,
    n_ep: int = 5,
    n_steps: int = 50,
    n_init_samples: int = 40,
    opt_hyp_every: int = 1,
    hyp_iters: int = 120,
    log_noise: float = -3.0,
    calibrate_lipschitz: bool = True,
    metrics: Any = None,
    ckpt_dir: str | None = None,
    resume: bool = False,
    make_ssm: Callable | None = None,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    plan_noise_shape: tuple | None = None,
) -> dict:
    """The episodic safe-learning experiment. Returns ``{"series": ...,
    "ssm": final model}`` with the JAX package's per-episode series
    (violations, feasibility_rate, model_error, mean_cost, episode_time_s,
    n_data). ``draws`` (see the module docstring) replaces the draws of
    ``generator`` (``None``: a CPU generator seeded 0);
    ``plan_noise_shape`` is the shape of one solve's planner draws."""
    if ckpt_dir is not None or resume:
        raise NotImplementedError(
            "checkpointing and resume (runtime/checkpoint.py) are not ported "
            "yet (ROADMAP Queue 1, item 12)")
    spec = env.spec
    d_in = spec.n_s + spec.n_u
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = episode_draws(generator, spec, n_ep=n_ep, n_steps=n_steps,
                              n_init=n_init_samples, n_region=128 * d_in,
                              plan_shape=plan_noise_shape, dtype=a.dtype)
    draws = {k: torch.as_tensor(v).to(dtype=a.dtype, device=a.device)
             for k, v in draws.items()}

    xs, us, resid = collect_initial_data(env, n_init_samples, a, b, k_fb,
                                         draws=draws)
    if make_ssm is not None:
        ssm = make_ssm(xs, us, resid)
    else:
        ssm = make_gp_ssm(kern_types, xs, us, resid, n_max=n_max, l_mu=l_mu,
                          l_sigma=l_sigma, log_noise=log_noise)

    region = (draws["region_x"], draws["region_u"])

    def fit_and_calibrate(s):
        s = ssm_fit(s, iters=hyp_iters)
        if calibrate_lipschitz:
            # training buffer + the operating region's probes
            s = _calibrate_lipschitz(s, spec, n_region=region[0].shape[0],
                                     draws=region)
        return s

    ssm = fit_and_calibrate(ssm)
    series: dict[str, list] = {
        "violations": [], "feasibility_rate": [], "model_error": [],
        "mean_cost": [], "episode_time_s": [], "n_data": [],
    }
    for ep in range(n_ep):
        x0 = env_reset(env, noise=draws["reset"][ep])
        t0 = time.perf_counter()
        # the planner runs on a bucketed view (posterior contractions sized
        # to the active points); appends and refits use the full buffer
        traj, _, _ = rollout_episode(
            env, get_action, init_state(), ssm_bucketed(ssm), x0, n_steps, a,
            b, generator=generator,
            plan_noise=draws["plan"][ep] if "plan" in draws else None,
            step_noise=draws["step"][ep])
        host = {k: v.cpu() for k, v in traj.items()}
        dt_ep = time.perf_counter() - t0

        series["violations"].append(int((~host["constraint_ok"]).sum()))
        series["feasibility_rate"].append(
            float(host["feasible"].to(a.dtype).mean()))
        series["model_error"].append(float(host["model_err"].mean()))
        series["mean_cost"].append(
            float(torch.mean(torch.sum(host["x"] ** 2, dim=-1))))
        series["episode_time_s"].append(dt_ep)
        series["n_data"].append(int(ssm_n_points(ssm)))

        ssm = ssm_update(ssm, traj["x"], traj["u"], traj["resid"])
        if opt_hyp_every and (ep + 1) % opt_hyp_every == 0:
            ssm = fit_and_calibrate(ssm)

        if metrics is not None:
            for name, vals in series.items():
                metrics.log_scalar(name, vals[-1], step=ep)
            metrics.flush()
    return {"series": series, "ssm": ssm}

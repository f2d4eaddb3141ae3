"""Episodic plan -> act -> update-GP loop — port of
``safe_exploration_tpu/runtime/episode.py``.

Collect initial safe samples, fit the GP's hyperparameters and calibrate
its Lipschitz constants, then for each episode run ``n_steps`` of
``get_action`` / ``env_step`` on a bucketed view of the model, append the
episode's transitions (one batched refit) and fit again; log per-episode
metrics. The JAX package scans an episode as one compiled program; here an
episode is a Python loop over steps whose only read-back is the single-
instance SafeMPC machine's branch on the solve's feasibility.

Random streams: where the JAX package splits keys, the port draws from
one ``torch.Generator`` (:func:`episode_draws`; a CPU generator gives the
same run on the CPU and on the GPU) or takes the draws from the caller as
``draws``, a dict of tensors:

  ``init_x`` (n_init, n_s), ``init_u`` (n_init, n_u)  uniform on [-1, 1)
  ``init_noise`` (n_init, n_s)                       plant noise, N(0, 1)
  ``region_x`` (n_region, n_s), ``region_u`` (n_region, n_u)  uniform on
      [0, 1): the Lipschitz region probes, the same at every calibration
  ``mc_w{i}``, ``mc_u{i}``  the MC-dropout network's first weights and
      prediction uniforms (``build_experiment``'s ``ssm_draw_shapes``;
      only for those families)
  ``mc_fit{i}``  optional: the MC-dropout fit's draws per hidden layer
      (``models/nn_ssm.mc_fit_draws``' shapes), the same at every fit;
      without them each fit draws from a generator seeded 0 on the
      model's device, as the JAX package fits from PRNGKey(0)
  ``reset`` (n_ep, n_s)                              N(0, 1)
  ``plan`` (n_ep, n_steps, ...)   each solve's planner draws (optional:
      without it the planner draws from ``generator``)
  ``step`` (n_ep, n_steps, n_s)                      plant noise, N(0, 1)

The generator makes every draw of the run up front: the first draws
(initial data, region, the first model's), then each episode's ``reset``,
``step`` and ``plan`` in episode order, so episode k's draws do not depend
on how many episodes follow. With ``ckpt_dir`` :func:`run_episodic` writes
``ckpt_dir/ckpt_{ep}.pt`` after every episode (``runtime/checkpoint.py``:
the model after its fit, the episode index, the series and the run's
configuration); ``resume`` continues from the latest one on the same
draws, bit for bit.
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
from safe_exploration_tpu_torch.runtime import checkpoint as ckpt
from safe_exploration_tpu_torch.solvers.safempc import SafeMPCState

__all__ = ["collect_initial_data", "episode_draws", "first_model",
           "fit_and_calibrate", "on_device", "rollout_episode",
           "run_episodic"]


def episode_draws(generator: torch.Generator, spec, *, n_ep: int,
                  n_steps: int, n_init: int, n_region: int,
                  plan_shape: tuple | None, dtype,
                  ssm_shapes: dict | None = None, lead: tuple = ()) -> dict:
    """Every draw of one run from ``generator``, made on its device in a
    fixed order (keys as in the module docstring): the initial data's, the
    region's and (``ssm_shapes``: name -> ("normal" | "uniform", shape))
    the first model's, then each episode's ``reset``, ``step`` and (with
    the planner's draw shape ``plan_shape``) ``plan`` in episode order,
    with ``lead`` (a fleet's lanes) in front of a step's shapes."""
    n_s, n_u = spec.n_s, spec.n_u
    kw = {"generator": generator, "dtype": dtype, "device": generator.device}

    def sym(*shape):
        return 2.0 * torch.rand(shape, **kw) - 1.0

    draws = {"init_x": sym(n_init, n_s), "init_u": sym(n_init, n_u),
             "init_noise": torch.randn((n_init, n_s), **kw),
             "region_x": torch.rand((n_region, n_s), **kw),
             "region_u": torch.rand((n_region, n_u), **kw)}
    for k, (kind, shape) in (ssm_shapes or {}).items():
        draws[k] = (torch.randn if kind == "normal" else torch.rand)(shape,
                                                                     **kw)
    eps = []
    for _ in range(n_ep):
        ep = {"reset": torch.randn((*lead, n_s), **kw),
              "step": torch.randn((n_steps, *lead, n_s), **kw)}
        if plan_shape is not None:
            ep["plan"] = torch.randn((n_steps, *lead, *plan_shape), **kw)
        eps.append(ep)
    for k in eps[0] if eps else ():
        draws[k] = torch.stack([e[k] for e in eps])
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


def on_device(draws: dict, a: torch.Tensor) -> dict:
    """``draws`` as tensors of ``a``'s dtype on ``a``'s device."""
    return {k: torch.as_tensor(v).to(dtype=a.dtype, device=a.device)
            for k, v in draws.items()}


def mc_fit_of(draws: dict | None):
    """The MC-dropout fit's draws in ``draws`` (``mc_fit0``, ``mc_fit1``,
    ...), or ``None``."""
    if not draws or "mc_fit0" not in draws:
        return None
    return tuple(draws[f"mc_fit{i}"] for i in range(len(
        [k for k in draws if k.startswith("mc_fit")])))


def fit_and_calibrate(ssm, spec, hyp_iters: int, draws: dict | None, *,
                      fit_draws=None):
    """A hyperparameter fit of ``ssm`` (an MC-dropout network's on
    ``fit_draws``, see ``ssm_fit``), then (unless ``draws`` is ``None``)
    its Lipschitz calibration over the training buffer and the operating
    region's probes ``draws["region_x"]``, ``draws["region_u"]``."""
    ssm = ssm_fit(ssm, iters=hyp_iters, draws=fit_draws)
    if draws is None:
        return ssm
    region = (draws["region_x"], draws["region_u"])
    return _calibrate_lipschitz(ssm, spec, n_region=region[0].shape[0],
                                draws=region)


def first_model(env: Env, a: torch.Tensor, b: torch.Tensor,
                k_fb: torch.Tensor, draws: dict, make_ssm: Callable, *,
                n_init: int, hyp_iters: int, calibrate: bool = True):
    """The runners' first model: ``n_init`` initial transitions from
    ``draws`` (:func:`collect_initial_data`), the model ``make_ssm(xs, us,
    resid)`` builds from them (with ``init=``, the ``mc_w*`` / ``mc_u*``
    draws, where ``draws`` holds an MC-dropout network's), fitted and (with
    ``calibrate``) calibrated (:func:`fit_and_calibrate`)."""
    xs, us, resid = collect_initial_data(env, n_init, a, b, k_fb,
                                         draws=draws)
    init = {k: v for k, v in draws.items()
            if k.startswith(("mc_w", "mc_u"))}
    ssm = make_ssm(xs, us, resid, init=init) if init else make_ssm(
        xs, us, resid)
    return fit_and_calibrate(ssm, env.spec, hyp_iters,
                             draws if calibrate else None,
                             fit_draws=mc_fit_of(draws))


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
    run_config: dict | None = None,
    make_ssm: Callable | None = None,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    plan_noise_shape: tuple | None = None,
    ssm_draw_shapes: dict | None = None,
) -> dict:
    """The episodic safe-learning experiment. Returns ``{"series": ...,
    "ssm": final model}`` with the JAX package's per-episode series
    (violations, feasibility_rate, model_error, mean_cost, episode_time_s,
    n_data). ``draws`` (see the module docstring) replaces the draws of
    ``generator`` (``None``: a CPU generator seeded 0);
    ``plan_noise_shape`` is the shape of one solve's planner draws and
    ``ssm_draw_shapes`` the first model's (``build_experiment``'s).

    ``ckpt_dir`` writes a checkpoint after every episode (and, on a fresh
    run, first removes the ones an earlier run left there); ``resume``
    restarts from the latest one (the model, the series and the episode
    index), so a run interrupted after episode k and resumed on the same
    draws equals the uninterrupted run bit for bit, wall times aside.
    ``run_config`` (plain values) is stored in each checkpoint, and a
    resume raises where the checkpoint's differs (``runtime/checkpoint``'s
    ``restore``)."""
    spec = env.spec
    d_in = spec.n_s + spec.n_u
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = episode_draws(generator, spec, n_ep=n_ep, n_steps=n_steps,
                              n_init=n_init_samples, n_region=128 * d_in,
                              plan_shape=plan_noise_shape, dtype=a.dtype,
                              ssm_shapes=ssm_draw_shapes)
    draws = on_device(draws, a)
    restored = ckpt.restore(ckpt_dir, resume, run_config,
                            map_location=a.device)
    if make_ssm is None:
        def make_ssm(xs, us, resid):
            return make_gp_ssm(kern_types, xs, us, resid, n_max=n_max,
                               l_mu=l_mu, l_sigma=l_sigma,
                               log_noise=log_noise)

    region = draws if calibrate_lipschitz else None
    series: dict[str, list] = {
        "violations": [], "feasibility_rate": [], "model_error": [],
        "mean_cost": [], "episode_time_s": [], "n_data": [],
    }
    start_ep = 0
    if restored is None:
        ssm = first_model(env, a, b, k_fb, draws, make_ssm,
                          n_init=n_init_samples, hyp_iters=hyp_iters,
                          calibrate=calibrate_lipschitz)
    else:
        ssm = restored["ssm"]
        start_ep = restored["episode"] + 1
        series = {k: list(v) for k, v in restored["series"].items()}
    for ep in range(start_ep, n_ep):
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
            ssm = fit_and_calibrate(ssm, spec, hyp_iters, region,
                                    fit_draws=mc_fit_of(draws))

        if metrics is not None:
            for name, vals in series.items():
                metrics.log_scalar(name, vals[-1], step=ep)
            metrics.flush()
        if ckpt_dir is not None:
            ckpt.save_checkpoint(
                ckpt.checkpoint_path(ckpt_dir, ep),
                {"ssm": ssm, "episode": ep, "series": series,
                 "config": run_config})
    return {"series": series, "ssm": ssm}

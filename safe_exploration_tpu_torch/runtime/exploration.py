"""Safe active-learning (exploration) runners — port of
``safe_exploration_tpu/runtime/exploration.py``.

Both runners collect initial safe samples, fit the GP's hyperparameters and
calibrate its Lipschitz constants, then per iteration probe one transition
of the plant, append it to the GP (``ssm_update``, a refit) and re-fit the
hyperparameters every ``opt_hyp_every`` iterations; they track the exact
greedy information gain I(y; f) = 0.5 sum_d log(1 + sigma_d^2 / sigma_n_d^2)
at the probed input, the predictive std and the model error.

  * :func:`run_exploration` (greedy) plans an information-seeking
    trajectory from the current state (the planner's objective is the
    exploration cost) and applies its first control;
  * :func:`run_exploration_static` optimizes the probe input (x, u) itself
    (solvers/static_exploration.py), from the previous optimum and
    ``n_restarts`` uniform restarts, and takes the best feasible probe.

Each iteration reads its metrics back to the host once. Random streams:
where the JAX package splits keys, the port takes every draw from ``draws``
(tensors, as :mod:`runtime.episode`'s, with the iteration axis where an
episode has its steps) or makes them up front from one ``torch.Generator``:

  ``init_x``, ``init_u``, ``init_noise``, ``region_x``, ``region_u``  as in
      :func:`runtime.episode.episode_draws`
  ``reset`` (1, n_s)             the greedy runner's start state, N(0, 1)
  ``plan`` (1, n_iterations, ...)  each solve's planner draws (optional)
  ``step`` (1, n_iterations, n_s)  plant noise, N(0, 1)
  ``restart`` (n_iterations, n_restarts, n_flat)  the static runner's
      restart bank, uniform on [-1, 1)
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from safe_exploration_tpu_torch.envs.base import Env, env_reset, env_step
from safe_exploration_tpu_torch.models.ssm import (
    make_gp_ssm,
    ssm_n_points,
    ssm_predict,
    ssm_update,
)
from safe_exploration_tpu_torch.runtime.episode import (
    episode_draws,
    first_model,
    fit_and_calibrate,
    mc_fit_of,
    on_device,
)

__all__ = ["run_exploration", "run_exploration_static"]

_SERIES = ("info_gain", "pred_std_sum", "model_error", "feasibility_rate",
           "violations", "n_data")


def _setup(env, a, b, k_fb, *, kern_types, n_max, l_mu, l_sigma, log_noise,
           n_init_samples, n_iterations, hyp_iters, make_ssm, generator,
           draws, plan_noise_shape, ssm_draw_shapes=None):
    """The runs' draws on the device, the first model
    (:func:`runtime.episode.first_model`) and the fit-and-calibrate step
    both runners repeat."""
    spec = env.spec
    if draws is None:
        draws = episode_draws(
            generator, spec, n_ep=1, n_steps=n_iterations,
            n_init=n_init_samples, n_region=128 * (spec.n_s + spec.n_u),
            plan_shape=plan_noise_shape, dtype=a.dtype,
            ssm_shapes=ssm_draw_shapes)
    draws = on_device(draws, a)
    if make_ssm is None:
        def make_ssm(xs, us, resid):
            return make_gp_ssm(kern_types, xs, us, resid, n_max=n_max,
                               l_mu=l_mu, l_sigma=l_sigma,
                               log_noise=log_noise)

    ssm = first_model(env, a, b, k_fb, draws, make_ssm,
                      n_init=n_init_samples, hyp_iters=hyp_iters)
    return draws, ssm, lambda s: fit_and_calibrate(
        s, spec, hyp_iters, draws, fit_draws=mc_fit_of(draws))


def _probe(env, ssm, a, b, x, u, noise):
    """Apply ``u`` at ``x`` on the plant (``noise`` its draw) and score the
    probe on the model before the update: (u_applied, x_next, residual,
    the device-side metrics info_gain, pred_std_sum, model_error and
    constraint_ok)."""
    spec = env.spec
    mu, var = ssm_predict(ssm, x, u)
    u_app, x_next = env_step(env, x, u, noise=noise)
    resid = x_next - (a @ x + b @ u_app)
    info_gain = 0.5 * torch.sum(torch.log1p(var / ssm.noise_var()))
    metrics = (info_gain, torch.sum(torch.sqrt(var)),
               torch.linalg.vector_norm(resid - mu),
               torch.all(spec.h_mat_obs @ x_next - spec.h_obs <= 0.0))
    return u_app, x_next, resid, metrics


def _record(series, metrics_dev, feasible, ssm, it, metrics) -> None:
    """Read one iteration's metrics back in one copy, append them to the
    series and log them."""
    info_gain, std_sum, model_err, ok = metrics_dev
    vals = torch.stack([info_gain, std_sum, model_err,
                        feasible.to(info_gain.dtype), ok.to(info_gain.dtype),
                        ssm_n_points(ssm).to(info_gain.dtype)]).cpu()
    series["info_gain"].append(float(vals[0]))
    series["pred_std_sum"].append(float(vals[1]))
    series["model_error"].append(float(vals[2]))
    series["feasibility_rate"].append(float(bool(vals[3])))
    series["violations"].append(int(not bool(vals[4])))
    series["n_data"].append(int(vals[5]))
    if metrics is not None:
        metrics.log_dict({k: v[-1] for k, v in series.items()}, step=it)
        metrics.flush()


def run_exploration(
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
    n_iterations: int = 40,
    n_init_samples: int = 20,
    opt_hyp_every: int = 10,
    hyp_iters: int = 120,
    log_noise: float = -3.0,
    metrics: Any = None,
    make_ssm: Callable | None = None,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    plan_noise_shape: tuple | None = None,
    ssm_draw_shapes: dict | None = None,
) -> dict:
    """Greedy safe exploration: the planner's objective must be the
    exploration (max-predictive-std) cost. Each iteration plans from the
    current state on the full model (safety tube constrained), applies the
    first control, observes the transition and updates the GP. ``draws``
    (module docstring) replace the draws of ``generator`` (``None``: a CPU
    generator seeded 0); ``plan_noise_shape`` is one solve's draw shape.
    Returns ``{"series": ..., "ssm": final model}`` with the JAX package's
    per-iteration series."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    draws, ssm, fit_fn = _setup(
        env, a, b, k_fb, kern_types=kern_types, n_max=n_max, l_mu=l_mu,
        l_sigma=l_sigma, log_noise=log_noise, n_init_samples=n_init_samples,
        n_iterations=n_iterations, hyp_iters=hyp_iters, make_ssm=make_ssm,
        generator=generator, draws=draws, plan_noise_shape=plan_noise_shape,
        ssm_draw_shapes=ssm_draw_shapes)
    plans = draws["plan"][0] if "plan" in draws else None
    x = env_reset(env, noise=draws["reset"][0])
    mstate = init_state()
    series: dict[str, list] = {k: [] for k in _SERIES}
    for it in range(n_iterations):
        u, mstate, info = get_action(
            generator, mstate, ssm, x,
            noise=None if plans is None else plans[it])
        u_app, x_next, resid, out = _probe(env, ssm, a, b, x, u,
                                           draws["step"][0, it])
        ssm = ssm_update(ssm, x[None], u_app[None], resid[None])
        x = x_next
        _record(series, out, info["feasible"], ssm, it, metrics)
        if opt_hyp_every and (it + 1) % opt_hyp_every == 0:
            ssm = fit_fn(ssm)
    return {"series": series, "ssm": ssm}


def run_exploration_static(
    env: Env,
    a: torch.Tensor,
    b: torch.Tensor,
    k_fb: torch.Tensor,
    *,
    kern_types: tuple,
    n_max: int,
    l_mu: torch.Tensor,
    l_sigma: torch.Tensor,
    n_iterations: int = 40,
    n_init_samples: int = 20,
    n_restarts: int = 8,
    n_safe: int = 4,
    c_safety: float = 2.0,
    sqp_outer: int = 8,
    sqp_inner: int = 4,
    opt_hyp_every: int = 10,
    hyp_iters: int = 120,
    log_noise: float = -3.0,
    metrics: Any = None,
    make_ssm: Callable | None = None,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    ssm_draw_shapes: dict | None = None,
) -> dict:
    """Static safe active learning, the reference's exploration semantics:
    each iteration optimizes the probe input z = (x, u) (maximum predictive
    variance, the n_safe-step tube from x returning to the safe set),
    samples that transition from the plant (a quasi-static plant, steered
    to the probe between queries) and appends it to the model.

    The probe NLP runs from the previous optimum and ``n_restarts`` random
    warm starts (0.5 ``restart``) in one batched solve; the best FEASIBLE
    probe wins. ``draws`` as :func:`run_exploration` plus ``restart``. Returns
    ``{"series", "ssm", "probes" (n_iterations, n_s)}``."""
    from safe_exploration_tpu_torch.solvers.sqp import SqpConfig
    from safe_exploration_tpu_torch.solvers.static_exploration import (
        make_static_exploration_planner,
        static_warm_len,
    )

    scfg = SqpConfig(n_safe=n_safe, c_safety=c_safety, n_outer=sqp_outer,
                     n_inner=sqp_inner)
    n_flat = static_warm_len(env, scfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    draws, ssm, fit_fn = _setup(
        env, a, b, k_fb, kern_types=kern_types, n_max=n_max, l_mu=l_mu,
        l_sigma=l_sigma, log_noise=log_noise, n_init_samples=n_init_samples,
        n_iterations=n_iterations, hyp_iters=hyp_iters, make_ssm=make_ssm,
        generator=generator, draws=draws, plan_noise_shape=None,
        ssm_draw_shapes=ssm_draw_shapes)
    if "restart" not in draws:
        draws["restart"] = (2.0 * torch.rand(
            (n_iterations, n_restarts, n_flat), generator=generator,
            dtype=a.dtype, device=generator.device) - 1.0).to(a.device)
    planner = make_static_exploration_planner(env, k_fb, a, b, scfg)

    warm = torch.zeros((n_flat,), dtype=a.dtype, device=a.device)
    series: dict[str, list] = {k: [] for k in _SERIES}
    probes = []
    for it in range(n_iterations):
        # restart bank: the previous optimum + random safe-box starts
        res = planner(ssm, torch.cat([warm[None], 0.5 * draws["restart"][it]]))
        gain = 0.5 * torch.sum(torch.log1p(res.sigma2 / ssm.noise_var()),
                               dim=-1)
        best = torch.argmax(torch.where(res.feasible, gain, -torch.inf))
        x_probe, u_probe = res.x_probe[best], res.u_probe[best]
        warm = res.warm_next[best]

        # sample the chosen transition from the plant (a static query)
        u_app, _, resid, out = _probe(env, ssm, a, b, x_probe, u_probe,
                                      draws["step"][0, it])
        ssm = ssm_update(ssm, x_probe[None], u_app[None], resid[None])
        probes.append(x_probe)
        _record(series, out, res.feasible[best], ssm, it, metrics)
        if opt_hyp_every and (it + 1) % opt_hyp_every == 0:
            ssm = fit_fn(ssm)
    return {"series": series, "ssm": ssm,
            "probes": (torch.stack(probes) if probes
                       else torch.zeros((0, env.spec.n_s), dtype=a.dtype,
                                        device=a.device))}

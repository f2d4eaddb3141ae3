"""Fleet runner: B independent safe-learning episodes at once — port of
``safe_exploration_tpu/runtime/batch.py`` on the lanes backend.

Each lane owns its plant state, its SafeMPC machine state and its own GP,
stored batch-last (``models/gp_lanes.LaneGPSSM``): a step is one batched
SafeMPC call over the lane SQP (``solvers/safempc.make_safempc_batch``),
one batched plant step, and the O(n^2) lane append
(``lane_append_point``) of the step's transition to every lane's model.
Between episodes every lane refits and re-calibrates its own
hyperparameters and Lipschitz constants on the stacked view
(``lane_unstack_ssm`` -> ``ssm_fit`` -> ``calibrate_lipschitz`` ->
``lane_restack_ssm``), which rides the batched refit kernels over all
lanes at once. The JAX package scans an episode as one program; here it is
a Python loop over steps with no read-back inside.

Random streams follow the episodic runner (``runtime/episode.py``): every
draw comes up front from one ``torch.Generator`` (:func:`batch_draws`) or
from the caller as ``draws``, a dict of tensors:

  ``init_x`` (n_init, n_s), ``init_u`` (n_init, n_u)  uniform on [-1, 1)
  ``init_noise`` (n_init, n_s)                       plant noise, N(0, 1)
  ``region_x`` (n_region, n_s), ``region_u`` (n_region, n_u)  uniform on
      [0, 1): the Lipschitz region probes, the same for every lane and
      every calibration (the JAX package's PRNGKey(0))
  ``reset`` (n_ep, B, n_s)                           N(0, 1)
  ``step`` (n_ep, n_steps, B, n_s)                   plant noise, N(0, 1)

Not ported yet, and raising: the stacked backend (``stack_ssm``, the
vmapped ``run_batched_episodes``, ``gp_append_point``; ROADMAP Queue 1,
item 7), checkpointing (item 12) and the device mesh (item 13).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from safe_exploration_tpu_torch.envs.base import Env, env_reset, env_step
from safe_exploration_tpu_torch.models.gp_lanes import (
    lane_append_point,
    lane_expand_to,
    lane_predict,
    lane_restack_ssm,
    lane_shrink_to_bucket,
    lane_stack_ssm,
    lane_unstack_ssm,
)
from safe_exploration_tpu_torch.models.ssm import (
    calibrate_lipschitz as _calibrate_lipschitz,
    ssm_fit,
)

__all__ = ["batch_draws", "stack_ssm", "run_batched_episodes",
           "run_batched_episodes_lanes", "run_batched_learning"]

_STACKED = ("the stacked fleet runner (stack_ssm, run_batched_episodes, "
            "gp_append_point) is not ported yet (ROADMAP Queue 1, item 7)")


def stack_ssm(*args, **kwargs):
    raise NotImplementedError(_STACKED)


def run_batched_episodes(*args, **kwargs):
    raise NotImplementedError(_STACKED)


def batch_draws(generator: torch.Generator, spec, *, batch: int, n_ep: int,
                n_steps: int, n_init: int, n_region: int, dtype) -> dict:
    """Every draw of one fleet run from ``generator``, made on its device in
    a fixed order (keys as in the module docstring)."""
    n_s, n_u = spec.n_s, spec.n_u
    kw = {"generator": generator, "dtype": dtype, "device": generator.device}

    def sym(*shape):
        return 2.0 * torch.rand(shape, **kw) - 1.0

    return {"init_x": sym(n_init, n_s), "init_u": sym(n_init, n_u),
            "init_noise": torch.randn((n_init, n_s), **kw),
            "region_x": torch.rand((n_region, n_s), **kw),
            "region_u": torch.rand((n_region, n_u), **kw),
            "reset": torch.randn((n_ep, batch, n_s), **kw),
            "step": torch.randn((n_ep, n_steps, batch, n_s), **kw)}


def run_batched_episodes_lanes(env: Env, get_action_batch: Callable,
                               init_state_batch: Callable, lane_ssm,
                               x0s: torch.Tensor, n_steps: int,
                               a: torch.Tensor, b: torch.Tensor, *,
                               generator: torch.Generator | None = None,
                               step_noise: torch.Tensor | None = None):
    """Run B lane-major online-learning episodes of ``n_steps``.

    ``lane_ssm`` is a :class:`LaneGPSSM` (``lane_stack_ssm``) with at least
    ``n_steps`` free slots (raises ``ValueError`` before the episode
    otherwise: the lane append saturates on a full buffer, and a schedule
    that reached it would silently stop learning). ``x0s`` (B, n_s);
    ``step_noise`` (n_steps, B, n_s) replaces the plant-noise draws of
    ``generator``.

    Returns (traj, final lane model); traj holds (B, n_steps, ...) series:
    x, u, resid, model_err (the model that planned the step, before the
    append), feasible, violation, constraint_ok."""
    spec = env.spec
    n_max = lane_ssm.gp.n_max
    n_used = int(lane_ssm.gp.n_points)
    if n_used + n_steps > n_max:
        raise ValueError(
            f"batched episode would overflow the GP buffer: {n_used} points "
            f"+ {n_steps} appends > n_max={n_max}; raise the config's n_max "
            "or shorten the episode")
    xs, ms, s = x0s, init_state_batch(x0s.shape[0]), lane_ssm
    steps = []
    for t in range(n_steps):
        u, ms, info = get_action_batch(ms, s, xs)
        u_app, x_next = env_step(
            env, xs, u, generator=generator,
            noise=None if step_noise is None else step_noise[t])
        resid = x_next - (xs @ a.T + u_app @ b.T)
        mu_pred, _ = lane_predict(s, torch.cat([xs, u_app], dim=-1).T)
        s = lane_append_point(s, xs, u_app, resid)
        steps.append({
            "x": xs, "u": u_app, "resid": resid,
            "model_err": torch.linalg.vector_norm(resid - mu_pred.T, dim=-1),
            "feasible": info["feasible"], "violation": info["violation"],
            "constraint_ok": torch.all(
                x_next @ spec.h_mat_obs.T - spec.h_obs[None, :] <= 0.0,
                dim=-1),
        })
        xs = x_next
    traj = {k: torch.stack([st[k] for st in steps], dim=1) for k in steps[0]}
    return traj, s


def run_batched_learning(env: Env, exp: dict, ssm, batch: int, n_ep: int,
                         n_steps: int, *, hyp_iters: int = 80,
                         opt_hyp_every: int = 1, calibrate: bool = True,
                         backend: str | None = None,
                         ckpt_dir: str | None = None, resume: bool = False,
                         generator: torch.Generator | None = None,
                         draws: dict | None = None) -> dict:
    """``batch`` independent full safe-learning runs: each episode through
    :func:`run_batched_episodes_lanes` on a bucketed view of the fleet's
    model (``lane_shrink_to_bucket`` -> episode -> ``lane_expand_to``),
    then, every ``opt_hyp_every`` episodes, each lane's own
    hyperparameter fit and Lipschitz calibration on the stacked view
    (``lane_unstack_ssm`` -> ``ssm_fit`` -> ``calibrate_lipschitz`` ->
    ``lane_restack_ssm``), after which the lanes carry per-lane
    hyperparameters and constants.

    ``ssm`` is one fitted GPSSM; ``exp`` is ``build_experiment``'s dict.
    ``backend`` "lanes" or None (lanes when ``exp`` supports the model);
    ``draws`` (``reset``, ``step``, ``region_x``, ``region_u``; see the
    module docstring) replaces the draws of ``generator`` (``None``: a CPU
    generator seeded 0).

    Returns {"series": per-episode lists (lane means, the names of the
    episodic runner), "model": the final LaneGPSSM}."""
    if ckpt_dir is not None or resume:
        raise NotImplementedError(
            "checkpointing and resume (runtime/checkpoint.py) are not ported "
            "yet (ROADMAP Queue 1, item 12)")
    lbs = exp.get("lane_batch_supported")
    if backend is None:
        backend = ("lanes" if exp.get("get_action_batch") is not None
                   and lbs is not None and lbs(ssm) else "stacked")
    if backend != "lanes":
        raise NotImplementedError(f"backend={backend!r}: {_STACKED}")
    spec = env.spec
    a, b = exp["a"], exp["b"]
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = batch_draws(generator, spec, batch=batch, n_ep=n_ep,
                            n_steps=n_steps, n_init=0,
                            n_region=128 * (spec.n_s + spec.n_u),
                            dtype=a.dtype)
    draws = {k: torch.as_tensor(v).to(dtype=a.dtype, device=a.device)
             for k, v in draws.items()}
    region = (draws["region_x"], draws["region_u"])

    def fit_one(s):
        s = ssm_fit(s, iters=hyp_iters)
        if calibrate:
            s = _calibrate_lipschitz(s, spec, n_region=region[0].shape[0],
                                     draws=region)
        return s

    model = lane_stack_ssm(ssm, batch)
    series: dict[str, list] = {
        "violations": [], "feasibility_rate": [], "model_error": [],
        "mean_cost": [], "episode_time_s": [], "n_data": [],
    }
    for ep in range(n_ep):
        x0s = env_reset(env, batch=(batch,), noise=draws["reset"][ep])
        t0 = time.perf_counter()
        # the episode runs on a bucketed view (contractions sized to the
        # active points plus this episode's appends), expanded afterwards
        cap = model.gp.n_max
        view = lane_shrink_to_bucket(model, n_free=n_steps)
        traj, view = run_batched_episodes_lanes(
            env, exp["get_action_batch"], exp["init_state_batch"], view, x0s,
            n_steps, a, b, step_noise=draws["step"][ep])
        model = lane_expand_to(view, cap)
        host = {k: v.cpu() for k, v in traj.items()}
        dt_ep = time.perf_counter() - t0

        series["violations"].append(int((~host["constraint_ok"]).sum()))
        series["feasibility_rate"].append(
            float(host["feasible"].to(a.dtype).mean()))
        series["model_error"].append(float(host["model_err"].mean()))
        series["mean_cost"].append(
            float(torch.mean(torch.sum(host["x"] ** 2, dim=-1))))
        series["episode_time_s"].append(dt_ep)
        series["n_data"].append(int(model.gp.n_points))

        if opt_hyp_every and (ep + 1) % opt_hyp_every == 0:
            model = lane_restack_ssm(fit_one(lane_unstack_ssm(model)))
    return {"series": series, "model": model}

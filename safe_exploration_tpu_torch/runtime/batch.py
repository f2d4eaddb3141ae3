"""Fleet runner: B independent safe-learning episodes at once — port of
``safe_exploration_tpu/runtime/batch.py``, both backends.

Each lane owns its plant state, its SafeMPC machine state and its own GP.
A step is one batched SafeMPC call (``solvers/safempc.make_safempc_batch``),
one batched plant step, and the O(n^2) append of the step's transition to
every lane's model. The two backends differ in how the models are kept:

  * **lanes** (:func:`run_batched_episodes_lanes`): batch-last
    (``models/gp_lanes.LaneGPSSM``), appended by ``lane_append_point``,
    planned by the lane SQP;
  * **stacked** (:func:`run_batched_episodes`): a stacked GPSSM (one
    leading lane axis, :func:`stack_ssm`), appended by the bordered
    Cholesky ``ssm_append_point``, planned by the batched planner on a
    stacked model (the portable CEM on a lane axis). The JAX package
    vmaps its single-instance ``get_action`` over lanes; the batched
    state machine selects the same values lane by lane.

Between episodes every lane refits and re-calibrates its own
hyperparameters and Lipschitz constants on the stacked model (the lanes
backend through ``lane_unstack_ssm`` -> ``ssm_fit`` ->
``calibrate_lipschitz`` -> ``lane_restack_ssm``), which rides the batched
refit kernels over all lanes at once. The JAX package scans an episode as
one program; here it is a Python loop over steps with no read-back inside.

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
  ``plan`` (n_ep, n_steps, B, ...)  each lane's planner draws on the
      stacked backend (``build_experiment``'s ``batch_noise_shape``; none
      for a planner that draws nothing)

Not ported yet, and raising: the portable NLP over a stacked model (ROADMAP
Queue 1, item 7), checkpointing (item 12) and the device mesh (item 13).
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
    GPSSM,
    calibrate_lipschitz as _calibrate_lipschitz,
    ssm_append_point,
    ssm_fit,
    ssm_predict,
)

__all__ = ["batch_draws", "stack_ssm", "run_batched_episodes",
           "run_batched_episodes_lanes", "run_batched_learning"]


def stack_ssm(ssm: GPSSM, batch: int) -> GPSSM:
    """Replicate one GP-SSM into a stacked one of ``batch`` lanes (every
    tensor copied behind a leading lane axis; the mask and head stay
    shared: the lanes append in lockstep), each of which then evolves on
    its own."""
    if not isinstance(ssm, GPSSM):
        raise TypeError(
            "the stacked fleet appends points to exact GPs (ssm_append_point)"
            f"; {type(ssm).__name__} has no incremental append")
    gp = ssm.gp

    def lanes(t):
        return None if t is None else t[None].expand(
            (batch,) + t.shape).contiguous()

    return GPSSM(
        gp=gp.replace(
            x=lanes(gp.x), y=lanes(gp.y),
            params=tuple({k: lanes(v) for k, v in p.items()}
                         for p in gp.params),
            log_noise=lanes(gp.log_noise), chol=lanes(gp.chol),
            beta=lanes(gp.beta), kinv=lanes(gp.kinv)),
        l_mu=lanes(ssm.l_mu), l_sigma=lanes(ssm.l_sigma),
        z_scale=lanes(ssm.z_scale))


def _require_no_mesh(mesh) -> None:
    """The JAX runners shard the lane axis over a device mesh; the port
    runs on one card."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding the fleet's lanes over a device mesh (parallel/mesh.py) "
            "is not ported yet (ROADMAP Queue 1, item 13)")


def _check_room(n_used: int, n_steps: int, n_max: int) -> None:
    """Raise before an episode whose appends would overflow the buffer:
    the append saturates on a full buffer, and a schedule that reached it
    would silently stop learning."""
    if n_used + n_steps > n_max:
        raise ValueError(
            f"batched episode would overflow the GP buffer: {n_used} points "
            f"+ {n_steps} appends > n_max={n_max}; raise the config's n_max "
            "or shorten the episode")


def batch_draws(generator: torch.Generator, spec, *, batch: int, n_ep: int,
                n_steps: int, n_init: int, n_region: int, dtype,
                plan_shape: tuple | None = None) -> dict:
    """Every draw of one fleet run from ``generator``, made on its device in
    a fixed order (keys as in the module docstring; ``plan`` only when one
    lane's planner draw shape ``plan_shape`` is given)."""
    n_s, n_u = spec.n_s, spec.n_u
    kw = {"generator": generator, "dtype": dtype, "device": generator.device}

    def sym(*shape):
        return 2.0 * torch.rand(shape, **kw) - 1.0

    draws = {"init_x": sym(n_init, n_s), "init_u": sym(n_init, n_u),
             "init_noise": torch.randn((n_init, n_s), **kw),
             "region_x": torch.rand((n_region, n_s), **kw),
             "region_u": torch.rand((n_region, n_u), **kw),
             "reset": torch.randn((n_ep, batch, n_s), **kw),
             "step": torch.randn((n_ep, n_steps, batch, n_s), **kw)}
    if plan_shape is not None:
        draws["plan"] = torch.randn((n_ep, n_steps, batch, *plan_shape), **kw)
    return draws


def _step_record(spec, xs, u_app, x_next, resid, mu_pred, info) -> dict:
    """One step's traj entries (each (B, ...))."""
    return {
        "x": xs, "u": u_app, "resid": resid,
        "model_err": torch.linalg.vector_norm(resid - mu_pred, dim=-1),
        "feasible": info["feasible"], "violation": info["violation"],
        "constraint_ok": torch.all(
            x_next @ spec.h_mat_obs.T - spec.h_obs[None, :] <= 0.0, dim=-1),
    }


def run_batched_episodes(env: Env, get_action_batch: Callable,
                         init_state_batch: Callable, ssm_batch: GPSSM,
                         x0s: torch.Tensor, n_steps: int, a: torch.Tensor,
                         b: torch.Tensor, *,
                         generator: torch.Generator | None = None,
                         step_noise: torch.Tensor | None = None,
                         plan_noise: torch.Tensor | None = None, mesh=None):
    """Run B online-learning episodes of ``n_steps`` on a stacked model.

    ``ssm_batch`` is a stacked GPSSM (:func:`stack_ssm`) with at least
    ``n_steps`` free slots in every lane (raises ``ValueError`` before the
    episode otherwise). A step plans every lane at once
    (``get_action_batch``, the batched SafeMPC machine, with the step's
    ``plan_noise[t]`` (B, ...) as the planner's draws when given), steps
    the plant, predicts the transition with the model that planned it and
    appends it to each lane's own model (``ssm_append_point``, O(n^2)).
    ``x0s`` (B, n_s); ``step_noise`` (n_steps, B, n_s) replaces the
    plant-noise draws of ``generator``.

    Returns (traj, final stacked model); traj holds (B, n_steps, ...)
    series as :func:`run_batched_episodes_lanes`; ``mesh`` (the JAX
    runner's lane sharding) raises: not ported yet."""
    _require_no_mesh(mesh)
    spec = env.spec
    _check_room(int(ssm_batch.gp.n_points.max()), n_steps,
                ssm_batch.gp.n_max)
    xs, ms, s = x0s, init_state_batch(x0s.shape[0]), ssm_batch
    steps = []
    for t in range(n_steps):
        u, ms, info = get_action_batch(
            ms, s, xs, noise=None if plan_noise is None else plan_noise[t])
        u_app, x_next = env_step(
            env, xs, u, generator=generator,
            noise=None if step_noise is None else step_noise[t])
        resid = x_next - (xs @ a.T + u_app @ b.T)
        mu_pred, _ = ssm_predict(s, xs, u_app)
        s = ssm_append_point(s, xs, u_app, resid)
        steps.append(_step_record(spec, xs, u_app, x_next, resid, mu_pred,
                                  info))
        xs = x_next
    traj = {k: torch.stack([st[k] for st in steps], dim=1) for k in steps[0]}
    return traj, s


def run_batched_episodes_lanes(env: Env, get_action_batch: Callable,
                               init_state_batch: Callable, lane_ssm,
                               x0s: torch.Tensor, n_steps: int,
                               a: torch.Tensor, b: torch.Tensor, *,
                               generator: torch.Generator | None = None,
                               step_noise: torch.Tensor | None = None,
                               mesh=None):
    """Run B lane-major online-learning episodes of ``n_steps``.

    ``lane_ssm`` is a :class:`LaneGPSSM` (``lane_stack_ssm``) with at least
    ``n_steps`` free slots (raises ``ValueError`` before the episode
    otherwise: the lane append saturates on a full buffer, and a schedule
    that reached it would silently stop learning). ``x0s`` (B, n_s);
    ``step_noise`` (n_steps, B, n_s) replaces the plant-noise draws of
    ``generator``.

    Returns (traj, final lane model); traj holds (B, n_steps, ...) series:
    x, u, resid, model_err (the model that planned the step, before the
    append), feasible, violation, constraint_ok. ``mesh`` raises, as in
    :func:`run_batched_episodes`."""
    _require_no_mesh(mesh)
    spec = env.spec
    _check_room(int(lane_ssm.gp.n_points), n_steps, lane_ssm.gp.n_max)
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
        steps.append(_step_record(spec, xs, u_app, x_next, resid, mu_pred.T,
                                  info))
        xs = x_next
    traj = {k: torch.stack([st[k] for st in steps], dim=1) for k in steps[0]}
    return traj, s


def run_batched_learning(env: Env, exp: dict, ssm, batch: int, n_ep: int,
                         n_steps: int, *, hyp_iters: int = 80,
                         opt_hyp_every: int = 1, calibrate: bool = True,
                         backend: str | None = None,
                         mesh=None, ckpt_dir: str | None = None,
                         resume: bool = False,
                         generator: torch.Generator | None = None,
                         draws: dict | None = None) -> dict:
    """``batch`` independent full safe-learning runs: each episode through
    :func:`run_batched_episodes_lanes` on a bucketed view of the fleet's
    model (``lane_shrink_to_bucket`` -> episode -> ``lane_expand_to``) or
    through :func:`run_batched_episodes` on the stacked model, then, every
    ``opt_hyp_every`` episodes, each lane's own hyperparameter fit and
    Lipschitz calibration on the stacked model (the lanes backend's view:
    ``lane_unstack_ssm`` -> ``ssm_fit`` -> ``calibrate_lipschitz`` ->
    ``lane_restack_ssm``), after which the lanes carry per-lane
    hyperparameters and constants.

    ``ssm`` is one fitted GPSSM; ``exp`` is ``build_experiment``'s dict.
    ``backend`` "lanes", "stacked" or None (lanes when ``exp`` supports the
    model); ``draws`` (``reset``, ``step``, ``region_x``, ``region_u``, and
    ``plan`` on the stacked backend; see the module docstring) replaces the
    draws of ``generator`` (``None``: a CPU generator seeded 0).

    Returns {"series": per-episode lists (lane means, the names of the
    episodic runner), "model": the final LaneGPSSM or stacked GPSSM}.
    ``mesh`` and checkpointing (``ckpt_dir``, ``resume``) raise: not
    ported yet."""
    _require_no_mesh(mesh)
    if ckpt_dir is not None or resume:
        raise NotImplementedError(
            "checkpointing and resume (runtime/checkpoint.py) are not ported "
            "yet (ROADMAP Queue 1, item 12)")
    lbs = exp.get("lane_batch_supported")
    if backend is None:
        backend = ("lanes" if exp.get("get_action_batch") is not None
                   and lbs is not None and lbs(ssm) else "stacked")
    if backend not in ("lanes", "stacked"):
        raise ValueError(f"unknown backend {backend!r} (lanes|stacked)")
    lanes = backend == "lanes"
    spec = env.spec
    a, b = exp["a"], exp["b"]
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = batch_draws(generator, spec, batch=batch, n_ep=n_ep,
                            n_steps=n_steps, n_init=0,
                            n_region=128 * (spec.n_s + spec.n_u),
                            dtype=a.dtype,
                            plan_shape=None if lanes
                            else exp["batch_noise_shape"])
    draws = {k: torch.as_tensor(v).to(dtype=a.dtype, device=a.device)
             for k, v in draws.items()}
    region = (draws["region_x"], draws["region_u"])

    def fit_one(s):
        s = ssm_fit(s, iters=hyp_iters)
        if calibrate:
            s = _calibrate_lipschitz(s, spec, n_region=region[0].shape[0],
                                     draws=region)
        return s

    model = lane_stack_ssm(ssm, batch) if lanes else stack_ssm(ssm, batch)
    plans = draws.get("plan")
    series: dict[str, list] = {
        "violations": [], "feasibility_rate": [], "model_error": [],
        "mean_cost": [], "episode_time_s": [], "n_data": [],
    }
    for ep in range(n_ep):
        x0s = env_reset(env, batch=(batch,), noise=draws["reset"][ep])
        t0 = time.perf_counter()
        if lanes:
            # the episode runs on a bucketed view (contractions sized to
            # the active points plus this episode's appends), expanded
            # afterwards
            cap = model.gp.n_max
            view = lane_shrink_to_bucket(model, n_free=n_steps)
            traj, view = run_batched_episodes_lanes(
                env, exp["get_action_batch"], exp["init_state_batch"], view,
                x0s, n_steps, a, b, step_noise=draws["step"][ep])
            model = lane_expand_to(view, cap)
        else:
            traj, model = run_batched_episodes(
                env, exp["get_action_batch"], exp["init_state_batch"], model,
                x0s, n_steps, a, b, step_noise=draws["step"][ep],
                plan_noise=None if plans is None else plans[ep])
        host = {k: v.cpu() for k, v in traj.items()}
        dt_ep = time.perf_counter() - t0

        series["violations"].append(int((~host["constraint_ok"]).sum()))
        series["feasibility_rate"].append(
            float(host["feasible"].to(a.dtype).mean()))
        series["model_error"].append(float(host["model_err"].mean()))
        series["mean_cost"].append(
            float(torch.mean(torch.sum(host["x"] ** 2, dim=-1))))
        series["episode_time_s"].append(dt_ep)
        series["n_data"].append(int(model.gp.n_points.max()))

        if opt_hyp_every and (ep + 1) % opt_hyp_every == 0:
            model = (lane_restack_ssm(fit_one(lane_unstack_ssm(model)))
                     if lanes else fit_one(model))
    return {"series": series, "model": model}

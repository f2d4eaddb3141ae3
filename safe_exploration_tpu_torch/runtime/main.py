"""Experiment CLI — port of ``safe_exploration_tpu/runtime/main.py``: every
task of the JAX CLI (episodic, batch on both backends, serve, uncertainty,
exploration, exploration_static):

    python -m safe_exploration_tpu_torch.runtime.main --config pendulum_episode \\
        [--set n_ep=3 n_steps=20] [--x64] [--out results/ [--resume]] \\
        [--device cpu]
    python -m safe_exploration_tpu_torch.runtime.main --config pendulum_serve

It runs on CUDA unless ``--device cpu`` is given (and raises without a
GPU). The summary it prints has the JAX CLI's keys (``wall_time_s``,
``metrics``, and ``series``, or for the uncertainty task its containment
keys; the file under ``--out`` adds ``config``). With ``--out`` the
episodic and batch tasks write a checkpoint after every episode under
``<out>/<config>.ckpt/``, and ``--resume`` continues such a run from the
latest one. The batch task's stacked backend under the NLP raises naming
the ROADMAP item that brings it; the MC-dropout networks in the batch and
serve tasks raise, as the JAX CLI fails there (they have no incremental
append).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import warnings

import torch

__all__ = ["main", "run_experiment"]

def _apply_overrides(cfg, overrides: list[str]):
    """``--set key=value ...`` overrides on the frozen dataclass config."""
    if not overrides:
        return cfg
    updates = {}
    fields = {f.name for f in dataclasses.fields(cfg)}
    for item in overrides:
        k, _, v = item.partition("=")
        if k not in fields:
            raise SystemExit(f"unknown config field: {k}")
        ftype = type(getattr(cfg, k))
        if ftype is bool:
            updates[k] = v.lower() in ("1", "true", "yes")
        elif ftype is tuple:
            updates[k] = tuple(v.split(","))
        else:
            updates[k] = ftype(v)
    return dataclasses.replace(cfg, **updates)


def run_experiment(cfg, *, out_dir: str | None = None, dtype=None,
                   device=None, resume: bool = False,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None) -> dict:
    """Build and run one experiment on ``device`` (CUDA unless ``"cpu"``).
    The run's draws come from ``generator`` (``None``: a CPU generator
    seeded ``cfg.seed``, so the CPU and the GPU see the same draws) or from
    ``draws`` (see :mod:`runtime.episode` for the episodic and serve tasks,
    :mod:`runtime.batch` for the batch task, :mod:`runtime.exploration` for
    the exploration tasks; the uncertainty task takes the initial data's
    and the region's and ``rollout`` (256, n_safe, n_s)). ``out_dir``
    receives the metrics and the summary, and for the episodic and batch
    tasks a checkpoint after every episode under ``<out_dir>/<name>.ckpt``;
    ``resume`` continues from the latest one there."""
    from safe_exploration_tpu_torch.runtime.config import (
        MC_FAMILIES,
        build_experiment,
    )
    from safe_exploration_tpu_torch.runtime.metrics import AggregatedMetrics

    if cfg.task not in _RUNNERS:
        raise SystemExit(f"unknown task: {cfg.task}")
    if cfg.ssm in MC_FAMILIES and cfg.task in ("batch", "serve"):
        raise NotImplementedError(_MC_APPEND.format(cfg.task, cfg.ssm))
    if (cfg.task == "batch" and cfg.batch_backend != "lanes"
            and cfg.solver == "sqp"):
        raise NotImplementedError(_STACKED_NLP.format(cfg.batch_backend))
    if resume and not out_dir:
        raise ValueError("resume continues a run from its checkpoints under "
                         "out_dir; none was given")
    dtype = dtype or torch.float32
    exp = build_experiment(cfg, dtype=dtype, device=device)
    metrics = AggregatedMetrics(out_dir, run_name=cfg.name)
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    ckpt_dir = os.path.join(out_dir, f"{cfg.name}.ckpt") if out_dir else None
    t0 = time.perf_counter()
    out = _RUNNERS[cfg.task](cfg, exp, metrics, generator, draws,
                             ckpt_dir=ckpt_dir, resume=resume,
                             run_config=_ckpt_config(cfg, dtype))
    wall = time.perf_counter() - t0
    summary = {
        "config": dataclasses.asdict(cfg),
        "wall_time_s": wall,
        "metrics": metrics.summary(),
    }
    if "series" in out:
        summary["series"] = out["series"]
    else:
        for k in ("per_stage_containment", "overall_containment",
                  "violation_rate"):
            summary[k] = out[k]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{cfg.name}.summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return summary


def _ckpt_config(cfg, dtype) -> dict:
    """What a checkpoint records of its run: the configuration's fields
    and the dtype (a resume under another one raises)."""
    return {**dataclasses.asdict(cfg), "dtype": str(dtype)}


def _run_episodic(cfg, exp, metrics, generator, draws, *, ckpt_dir,
                  resume, run_config) -> dict:
    """The episodic task (``run_episodic``), checkpointed under
    ``ckpt_dir`` when given."""
    from safe_exploration_tpu_torch.runtime.episode import run_episodic

    return run_episodic(
        exp["env"], exp["init_state"], exp["get_action"], exp["a"], exp["b"],
        exp["k_fb"], kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], n_ep=cfg.n_ep,
        n_steps=cfg.n_steps, n_init_samples=cfg.n_init_samples,
        hyp_iters=cfg.hyp_iters, metrics=metrics, make_ssm=exp["make_ssm"],
        ckpt_dir=ckpt_dir, resume=resume, run_config=run_config,
        generator=generator, draws=draws,
        plan_noise_shape=exp["planner_noise_shape"],
        ssm_draw_shapes=exp["ssm_draw_shapes"],
    )


_STACKED_NLP = (
    "batch_backend={!r} routes the NLP to the stacked fleet runner, which "
    "needs the portable NLP batched over a stacked model; it is not ported "
    "yet (ROADMAP Queue 1, item 7); the port runs batch_backend='lanes' "
    "under the SQP")

_MC_APPEND = (
    "the {} task appends each transition to the model (the fleet's and the "
    "serving controller's O(n^2) append), an exact-GP feature; ssm={!r} "
    "has none, and the JAX CLI fails there too (ROADMAP Queue 1, item 14)")


def _run_batch(cfg, exp, metrics, generator, draws, *, ckpt_dir,
               resume, run_config) -> dict:
    """The batch task as the JAX CLI runs it: initial data, one fit and
    calibration, then on the lanes backend (when the configuration pins it
    and the lane runner covers the model) or else the stacked one
    ``run_batched_learning`` for n_ep > 1 (per-lane fits between episodes,
    checkpointed under ``ckpt_dir`` when given)
    or one episode of ``run_batched_episodes_lanes`` /
    ``run_batched_episodes``; the same series keys, ``lane_backend``
    1 or 0."""
    from safe_exploration_tpu_torch.envs.base import env_reset
    from safe_exploration_tpu_torch.models.gp_lanes import (
        lane_shrink_to_bucket,
        lane_stack_ssm,
    )
    from safe_exploration_tpu_torch.runtime import batch as batch_mod
    from safe_exploration_tpu_torch.runtime.episode import on_device

    env, a = exp["env"], exp["a"]
    spec = env.spec
    lanes = cfg.batch_lanes
    if draws is None:
        draws = batch_mod.batch_draws(
            generator, spec, batch=lanes, n_ep=cfg.n_ep, n_steps=cfg.n_steps,
            n_init=cfg.n_init_samples, n_region=128 * (spec.n_s + spec.n_u),
            dtype=a.dtype, plan_shape=exp["batch_noise_shape"])
    draws = on_device(draws, a)
    ssm = _first_model(cfg, exp, draws, exp["make_ssm"])
    lbs = exp["lane_batch_supported"]
    lanes_ok = lbs is not None and lbs(ssm)
    if cfg.batch_backend == "lanes" and not lanes_ok:
        warnings.warn(
            f"config '{cfg.name}' pins batch_backend='lanes' but the lane "
            "episode runner does not support this model/solver configuration "
            "— falling back to the stacked runner", stacklevel=2)
    use_lanes = lanes_ok and cfg.batch_backend == "lanes"
    if not use_lanes and cfg.solver == "sqp":
        raise NotImplementedError(_STACKED_NLP.format(cfg.batch_backend))
    if cfg.n_ep > 1:
        res = batch_mod.run_batched_learning(
            env, exp, ssm, lanes, cfg.n_ep, cfg.n_steps,
            hyp_iters=cfg.hyp_iters,
            backend="lanes" if use_lanes else "stacked", draws=draws,
            ckpt_dir=ckpt_dir, resume=resume, run_config=run_config)
        series = dict(res["series"])
        roll_s = sum(series["episode_time_s"])
        series["lane_backend"] = [int(use_lanes)] * cfg.n_ep
        series["lanes"] = [lanes] * cfg.n_ep
        series["steps_per_sec"] = [lanes * cfg.n_steps * cfg.n_ep / roll_s
                                   ] * cfg.n_ep
        for name, vals in series.items():
            for step, v in enumerate(vals):
                metrics.log_scalar(name, v, step=step)
    else:
        t_roll = time.perf_counter()
        x0s = env_reset(env, batch=(lanes,), noise=draws["reset"][0])
        if use_lanes:
            traj, _ = batch_mod.run_batched_episodes_lanes(
                env, exp["get_action_batch"], exp["init_state_batch"],
                lane_shrink_to_bucket(lane_stack_ssm(ssm, lanes),
                                      n_free=cfg.n_steps),
                x0s, cfg.n_steps, a, exp["b"], step_noise=draws["step"][0])
        else:
            plans = draws.get("plan")
            traj, _ = batch_mod.run_batched_episodes(
                env, exp["get_action_batch"], exp["init_state_batch"],
                batch_mod.stack_ssm(ssm, lanes), x0s, cfg.n_steps, a,
                exp["b"], step_noise=draws["step"][0],
                plan_noise=None if plans is None else plans[0])
        host = {k: v.cpu() for k, v in traj.items()}
        roll_s = time.perf_counter() - t_roll
        series = {
            "lane_backend": [int(use_lanes)],
            "violations": [int((~host["constraint_ok"]).sum())],
            "feasibility_rate": [float(host["feasible"].to(a.dtype).mean())],
            "model_error": [float(host["model_err"].mean())],
            "lanes": [lanes],
            "steps_per_sec": [lanes * cfg.n_steps / roll_s],
        }
        for name, vals in series.items():
            metrics.log_scalar(name, vals[0], step=0)
    metrics.flush()
    return {"series": series}


def _first_model(cfg, exp, draws, make_ssm):
    """:func:`runtime.episode.first_model` at ``cfg``'s sizes."""
    from safe_exploration_tpu_torch.runtime.episode import first_model

    return first_model(exp["env"], exp["a"], exp["b"], exp["k_fb"], draws,
                       make_ssm, n_init=cfg.n_init_samples,
                       hyp_iters=cfg.hyp_iters)


def _run_serve(cfg, exp, metrics, generator, draws, **_) -> dict:
    """The serve task as the JAX CLI runs it: a fitted and calibrated first
    model behind a :class:`ServeController` (``on_full="drop"``), then
    ``n_steps`` of step / plant step / observe from a reset state; the
    series feasibility_rate, violations, recompiles, dropped_points and the
    step latency's p50 / p99. ``draws`` as :func:`run_episodic`'s for one
    episode of n_steps."""
    import numpy as np

    from safe_exploration_tpu_torch.envs.base import env_reset, env_step
    from safe_exploration_tpu_torch.runtime import serve as serve_mod
    from safe_exploration_tpu_torch.runtime.episode import (
        episode_draws,
        on_device,
    )

    env, a = exp["env"], exp["a"]
    spec = env.spec
    if draws is None:
        draws = episode_draws(
            generator, spec, n_ep=1, n_steps=cfg.n_steps,
            n_init=cfg.n_init_samples, n_region=128 * (spec.n_s + spec.n_u),
            plan_shape=exp["planner_noise_shape"], dtype=a.dtype)
    draws = on_device(draws, a)
    ssm = _first_model(cfg, exp, draws, exp["make_ssm"])
    ctrl = serve_mod.ServeController(exp, ssm, generator, on_full="drop")
    h_mat, h_obs = spec.h_mat_obs.cpu().numpy(), spec.h_obs.cpu().numpy()
    x = env_reset(env, noise=draws["reset"][0]).cpu().numpy()
    plans = draws["plan"][0] if "plan" in draws else None
    feas, viol = [], 0
    for i in range(cfg.n_steps):
        u = ctrl.step(x, noise=None if plans is None else plans[i])
        _, x_next = env_step(env, torch.as_tensor(x).to(a.device),
                             torch.as_tensor(u).to(a.device),
                             noise=draws["step"][0, i])
        x_next = x_next.cpu().numpy()
        ctrl.observe(x, u, x_next)
        feas.append(ctrl.last_feasible)
        if np.any(h_mat @ x_next - h_obs > 0.0):
            viol += 1
        x = x_next
    stats = ctrl.latency_stats()
    series = {
        "feasibility_rate": [float(np.mean(feas))],
        "violations": [viol],
        "recompiles": [ctrl.recompiles],
        "dropped_points": [ctrl.dropped_points],
        "latency_p50_ms": [stats["p50_ms"]],
        "latency_p99_ms": [stats["p99_ms"]],
    }
    for name, vals in series.items():
        # a percentile is None (JSON null) when every step was a build's
        # first: not logged as a scalar
        if vals[0] is not None:
            metrics.log_scalar(name, vals[0], step=0)
    metrics.flush()
    return {"series": series}


def _run_uncertainty(cfg, exp, metrics, generator, draws, **_) -> dict:
    """The uncertainty task as the JAX CLI runs it: a GP-SSM on raw inputs
    (no input scales) fitted and calibrated, then the tube of the zero plan
    from the origin against 256 noisy rollouts. ``draws``: the initial
    data's and the region's, and ``rollout`` (256, n_safe, n_s)."""
    from safe_exploration_tpu_torch.models.ssm import make_gp_ssm
    from safe_exploration_tpu_torch.runtime.episode import (
        episode_draws,
        on_device,
    )
    from safe_exploration_tpu_torch.runtime.uncertainty import (
        run_uncertainty_estimation,
    )

    env, a = exp["env"], exp["a"]
    spec = env.spec
    kw = {"dtype": a.dtype, "device": a.device}
    if draws is None:
        draws = episode_draws(
            generator, spec, n_ep=0, n_steps=0, n_init=cfg.n_init_samples,
            n_region=128 * (spec.n_s + spec.n_u), plan_shape=None,
            dtype=a.dtype)
        draws["rollout"] = torch.randn(
            (256, cfg.n_safe, spec.n_s), generator=generator, dtype=a.dtype,
            device=generator.device)
    draws = on_device(draws, a)

    def make_ssm(xs, us, resid):
        return make_gp_ssm(exp["kern_types"], xs, us, resid, n_max=cfg.n_max,
                           l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
                           log_noise=cfg.log_noise)

    ssm = _first_model(cfg, exp, draws, make_ssm)
    return run_uncertainty_estimation(
        env, ssm, a, exp["b"], exp["k_fb"], x0=torch.zeros((spec.n_s,), **kw),
        k_ff_all=torch.zeros((cfg.n_safe, spec.n_u), **kw),
        c_safety=cfg.c_safety, noise=draws["rollout"], metrics=metrics)


def _run_exploration(cfg, exp, metrics, generator, draws, **_) -> dict:
    """The greedy exploration task: ``n_ep * n_steps`` iterations."""
    from safe_exploration_tpu_torch.runtime.exploration import run_exploration

    return run_exploration(
        exp["env"], exp["init_state"], exp["get_action"], exp["a"], exp["b"],
        exp["k_fb"], kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
        n_iterations=cfg.n_ep * cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
        metrics=metrics, make_ssm=exp["make_ssm"], generator=generator,
        draws=draws, plan_noise_shape=exp["planner_noise_shape"],
        ssm_draw_shapes=exp["ssm_draw_shapes"])


def _run_exploration_static(cfg, exp, metrics, generator, draws, **_) -> dict:
    """The static exploration task: ``n_ep * n_steps`` probe solves (the
    exact-Hessian AL NLP at ``sqp_outer`` x ``sqp_inner``, 8 restarts)."""
    from safe_exploration_tpu_torch.runtime.exploration import (
        run_exploration_static,
    )

    return run_exploration_static(
        exp["env"], exp["a"], exp["b"], exp["k_fb"],
        kern_types=exp["kern_types"], n_max=cfg.n_max, l_mu=exp["l_mu"],
        l_sigma=exp["l_sigma"], n_iterations=cfg.n_ep * cfg.n_steps,
        n_init_samples=cfg.n_init_samples, n_safe=cfg.n_safe,
        c_safety=cfg.c_safety, sqp_outer=cfg.sqp_outer,
        sqp_inner=cfg.sqp_inner, hyp_iters=cfg.hyp_iters,
        log_noise=cfg.log_noise, metrics=metrics, make_ssm=exp["make_ssm"],
        generator=generator, draws=draws,
        ssm_draw_shapes=exp["ssm_draw_shapes"])


_RUNNERS = {"episodic": _run_episodic, "batch": _run_batch,
            "serve": _run_serve,
            "uncertainty": _run_uncertainty, "exploration": _run_exploration,
            "exploration_static": _run_exploration_static}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="pendulum_episode",
                        help="named config (runtime/config.py CONFIGS)")
    parser.add_argument("--list", action="store_true", help="list configs")
    parser.add_argument("--x64", action="store_true", help="run in float64")
    parser.add_argument("--out", default=None, help="output directory")
    parser.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                        help="config field overrides")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--resume", action="store_true",
                        help="resume the episodic/batch task from the latest "
                             "checkpoint under --out (bit-exact RNG stream)")
    args = parser.parse_args(argv)
    if args.resume and not args.out:
        parser.error("--resume continues a run from its checkpoints under "
                     "--out; give --out")

    from safe_exploration_tpu_torch.runtime.config import CONFIGS

    if args.list:
        for name, c in CONFIGS.items():
            print(f"{name:28s} task={c.task:12s} env={c.env:10s} "
                  f"solver={c.solver}")
        return 0
    if args.config not in CONFIGS:
        raise SystemExit(
            f"unknown config '{args.config}'; available: {sorted(CONFIGS)}")
    cfg = _apply_overrides(CONFIGS[args.config], args.set)
    summary = run_experiment(
        cfg, out_dir=args.out,
        dtype=torch.float64 if args.x64 else torch.float32,
        device=args.device, resume=args.resume)
    print(json.dumps({k: v for k, v in summary.items() if k != "config"},
                     indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

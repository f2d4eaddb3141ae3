"""Experiment CLI — port of ``safe_exploration_tpu/runtime/main.py`` for the
episodic task and the batch (fleet) task on its lanes backend:

    python -m safe_exploration_tpu_torch.runtime.main --config pendulum_episode \\
        [--set n_ep=3 n_steps=20] [--x64] [--out results/] [--device cpu]
    python -m safe_exploration_tpu_torch.runtime.main --config pendulum_batch_sqp

It runs on CUDA unless ``--device cpu`` is given (and raises without a
GPU). The summary it prints has the JAX CLI's keys (``wall_time_s``,
``metrics``, ``series``; the file under ``--out`` adds ``config``). Other
tasks, and the batch task's vmapped backend, raise naming the ROADMAP item
that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

__all__ = ["main", "run_experiment"]

_TASK_ITEMS = {
    "exploration": "runtime/exploration.py: ROADMAP Queue 1, item 12",
    "exploration_static": "runtime/exploration.py: ROADMAP Queue 1, item 12",
    "serve": "runtime/serve.py: ROADMAP Queue 1, item 12",
    "uncertainty": "runtime/uncertainty.py: ROADMAP Queue 1, item 12",
}


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
    ``draws`` (see :mod:`runtime.episode`, and :mod:`runtime.batch` for the
    batch task). ``out_dir`` receives the metrics and the summary;
    checkpoints are not ported (ROADMAP Queue 1, item 12)."""
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.metrics import AggregatedMetrics

    if cfg.task not in ("episodic", "batch"):
        where = _TASK_ITEMS.get(cfg.task)
        if where is None:
            raise SystemExit(f"unknown task: {cfg.task}")
        raise NotImplementedError(f"task={cfg.task!r} is not ported yet "
                                  f"({where})")
    if cfg.task == "batch" and cfg.batch_backend != "lanes":
        raise NotImplementedError(
            f"batch_backend={cfg.batch_backend!r} routes to the vmapped "
            "fleet runner (runtime/batch.py: run_batched_episodes, stack_ssm, "
            "gp_append_point), which is not ported yet (ROADMAP Queue 1, "
            "item 7); the port runs batch_backend='lanes'")
    dtype = dtype or torch.float32
    exp = build_experiment(cfg, dtype=dtype, device=device)
    metrics = AggregatedMetrics(out_dir, run_name=cfg.name)
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    t0 = time.perf_counter()
    if cfg.task == "batch":
        out = _run_batch(cfg, exp, metrics, generator, draws)
    else:
        out = _run_episodic(cfg, exp, metrics, generator, draws, resume)
    wall = time.perf_counter() - t0
    summary = {
        "config": dataclasses.asdict(cfg),
        "wall_time_s": wall,
        "metrics": metrics.summary(),
        "series": out["series"],
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{cfg.name}.summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return summary


def _run_episodic(cfg, exp, metrics, generator, draws, resume) -> dict:
    from safe_exploration_tpu_torch.runtime.episode import run_episodic

    return run_episodic(
        exp["env"], exp["init_state"], exp["get_action"], exp["a"], exp["b"],
        exp["k_fb"], kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], n_ep=cfg.n_ep,
        n_steps=cfg.n_steps, n_init_samples=cfg.n_init_samples,
        hyp_iters=cfg.hyp_iters, metrics=metrics, make_ssm=exp["make_ssm"],
        resume=resume, generator=generator, draws=draws,
        plan_noise_shape=exp["planner_noise_shape"],
    )


def _run_batch(cfg, exp, metrics, generator, draws) -> dict:
    """The batch task on the lanes backend, as the JAX CLI runs it: initial
    data, one fit and calibration, then ``run_batched_learning`` for
    n_ep > 1 (per-lane fits between episodes) or one
    ``run_batched_episodes_lanes`` episode; the same series keys."""
    from safe_exploration_tpu_torch.envs.base import env_reset
    from safe_exploration_tpu_torch.models.gp_lanes import (
        lane_shrink_to_bucket,
        lane_stack_ssm,
    )
    from safe_exploration_tpu_torch.models.ssm import (
        calibrate_lipschitz,
        ssm_fit,
    )
    from safe_exploration_tpu_torch.runtime import batch as batch_mod
    from safe_exploration_tpu_torch.runtime.episode import (
        collect_initial_data,
    )

    env, a = exp["env"], exp["a"]
    spec = env.spec
    lanes = cfg.batch_lanes
    if draws is None:
        draws = batch_mod.batch_draws(
            generator, spec, batch=lanes, n_ep=cfg.n_ep, n_steps=cfg.n_steps,
            n_init=cfg.n_init_samples, n_region=128 * (spec.n_s + spec.n_u),
            dtype=a.dtype)
    draws = {k: torch.as_tensor(v).to(dtype=a.dtype, device=a.device)
             for k, v in draws.items()}
    region = (draws["region_x"], draws["region_u"])
    xs, us, resid = collect_initial_data(env, cfg.n_init_samples, a, exp["b"],
                                         exp["k_fb"], draws=draws)
    ssm = exp["make_ssm"](xs, us, resid)
    ssm = calibrate_lipschitz(ssm_fit(ssm, iters=cfg.hyp_iters), spec,
                              n_region=region[0].shape[0], draws=region)
    lbs = exp["lane_batch_supported"]
    if lbs is None or not lbs(ssm):
        raise NotImplementedError(
            f"config '{cfg.name}' pins batch_backend='lanes' but the lane "
            "fleet runner does not cover this model/solver; the vmapped "
            "runner it would fall back to is not ported yet (ROADMAP Queue "
            "1, item 7)")
    if cfg.n_ep > 1:
        res = batch_mod.run_batched_learning(
            env, exp, ssm, lanes, cfg.n_ep, cfg.n_steps,
            hyp_iters=cfg.hyp_iters, backend="lanes", draws=draws)
        series = dict(res["series"])
        roll_s = sum(series["episode_time_s"])
        series["lane_backend"] = [1] * cfg.n_ep
        series["lanes"] = [lanes] * cfg.n_ep
        series["steps_per_sec"] = [lanes * cfg.n_steps * cfg.n_ep / roll_s
                                   ] * cfg.n_ep
        for name, vals in series.items():
            for step, v in enumerate(vals):
                metrics.log_scalar(name, v, step=step)
    else:
        t_roll = time.perf_counter()
        traj, _ = batch_mod.run_batched_episodes_lanes(
            env, exp["get_action_batch"], exp["init_state_batch"],
            lane_shrink_to_bucket(lane_stack_ssm(ssm, lanes),
                                  n_free=cfg.n_steps),
            env_reset(env, batch=(lanes,), noise=draws["reset"][0]),
            cfg.n_steps, a, exp["b"], step_noise=draws["step"][0])
        host = {k: v.cpu() for k, v in traj.items()}
        roll_s = time.perf_counter() - t_roll
        series = {
            "lane_backend": [1],
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
    args = parser.parse_args(argv)

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
        device=args.device)
    print(json.dumps({k: v for k, v in summary.items() if k != "config"},
                     indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Experiment CLI — port of ``safe_exploration_tpu/runtime/main.py`` for the
episodic task:

    python -m safe_exploration_tpu_torch.runtime.main --config pendulum_episode \\
        [--set n_ep=3 n_steps=20] [--x64] [--out results/] [--device cpu]

It runs on CUDA unless ``--device cpu`` is given (and raises without a
GPU). The summary it prints has the JAX CLI's keys (``wall_time_s``,
``metrics``, ``series``; the file under ``--out`` adds ``config``). Other
tasks raise naming the ROADMAP item that brings them.
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
    "batch": "runtime/batch.py: ROADMAP Queue 1, item 7",
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
    ``draws`` (see :mod:`runtime.episode`). ``out_dir`` receives the metrics
    and the summary; checkpoints are not ported (ROADMAP Queue 1, item 12)."""
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.episode import run_episodic
    from safe_exploration_tpu_torch.runtime.metrics import AggregatedMetrics

    if cfg.task != "episodic":
        where = _TASK_ITEMS.get(cfg.task)
        if where is None:
            raise SystemExit(f"unknown task: {cfg.task}")
        raise NotImplementedError(f"task={cfg.task!r} is not ported yet "
                                  f"({where})")
    dtype = dtype or torch.float32
    exp = build_experiment(cfg, dtype=dtype, device=device)
    metrics = AggregatedMetrics(out_dir, run_name=cfg.name)
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    t0 = time.perf_counter()
    out = run_episodic(
        exp["env"], exp["init_state"], exp["get_action"], exp["a"], exp["b"],
        exp["k_fb"], kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], n_ep=cfg.n_ep,
        n_steps=cfg.n_steps, n_init_samples=cfg.n_init_samples,
        hyp_iters=cfg.hyp_iters, metrics=metrics, make_ssm=exp["make_ssm"],
        resume=resume, generator=generator, draws=draws,
        plan_noise_shape=exp["planner_noise_shape"],
    )
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

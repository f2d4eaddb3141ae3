"""Host-clock seconds of one lane SQP step (``get_action_batch``) at the
two shapes the port runs the lane SQP on the pendulum, for the commit
whose port comes first on ``sys.path``:

    PYTHONPATH=. python safe_exploration_tpu_torch/solvers/tube_times.py
    cd OTHER_CHECKOUT && PYTHONPATH=. python /path/to/this/tube_times.py

so two commits compare on one card in one call (in turns: parent, change,
change, parent). f32, on CUDA unless ``--device cpu``.

  path   one shared GP (n_max 128, 64 initial points, fitted and
         calibrated), 512 initial states, n_safe 5, 14 x 3 Gauss-Newton
         steps, 6 polish, 4 rescue (the shapes of chip_smoke's ``[path]``)
  fleet  ``pendulum_batch_sqp``: its first fitted model stacked into 256
         lanes and bucketed for one episode, states from its initial
         distribution

Each step is timed three times after one warm call; the first step's
feasible share and a checksum of its plan are printed so two commits'
plans can be compared. One JSON line goes to stdout, with the card's name
and power limit on CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from safe_exploration_tpu_torch.models import ssm_bucketed
from safe_exploration_tpu_torch.models.gp_lanes import (
    lane_shrink_to_bucket,
    lane_stack_ssm,
)
from safe_exploration_tpu_torch.models.ssm import calibrate_lipschitz, ssm_fit
from safe_exploration_tpu_torch.runtime.config import (
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.episode import collect_initial_data


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _case(cfg, n_init: int, lanes: int, stacked: bool, device: str):
    """(exp, model view, x0s) of one shape: a fitted, calibrated model on
    initial data drawn from a CPU generator seeded 0."""
    exp = build_experiment(cfg, dtype=torch.float32, device=device)
    spec = exp["env"].spec
    gen = torch.Generator().manual_seed(0)
    xs, us, r = collect_initial_data(exp["env"], n_init, exp["a"], exp["b"],
                                     exp["k_fb"], generator=gen)
    ssm = calibrate_lipschitz(
        ssm_fit(exp["make_ssm"](xs, us, r), iters=cfg.hyp_iters), spec,
        generator=gen)
    view = (lane_shrink_to_bucket(lane_stack_ssm(ssm, lanes),
                                  n_free=cfg.n_steps)
            if stacked else ssm_bucketed(ssm))
    noise = torch.randn((lanes, spec.n_s), generator=gen).to(device)
    return exp, view, spec.init_m + spec.init_std * noise


def _time_step(exp, view, x0s, device: str) -> dict:
    lanes = x0s.shape[0]

    def step():
        _sync(device)
        t0 = time.perf_counter()
        u, _, info = exp["get_action_batch"](exp["init_state_batch"](lanes),
                                             view, x0s)
        _sync(device)
        return time.perf_counter() - t0, u, info["feasible"]

    warm_s, u, feasible = step()
    return {"seconds": [step()[0] for _ in range(3)], "warm_seconds": warm_s,
            "feasible": float(feasible.float().mean()),
            "u_abs_sum": float(u.double().abs().sum())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    path_cfg = ExperimentConfig(solver="sqp", n_safe=5, n_max=128,
                                sqp_outer=14, sqp_inner=3, sqp_polish=6,
                                sqp_rescue=4)
    fleet_cfg = CONFIGS["pendulum_batch_sqp"]
    out = {
        "path": _time_step(*_case(path_cfg, 64, 512, False, dev), dev),
        "fleet": _time_step(*_case(fleet_cfg, fleet_cfg.n_init_samples,
                                   fleet_cfg.batch_lanes, True, dev), dev),
    }
    if dev == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""The stacked fleet's f32 lane models in both packages, on the CPU.

Runs ``pendulum_batch`` (BASELINE config 3) at a reduced lane count in f32
through the JAX package's CLI path and through the port's on the JAX run's
own draws (rebuilt from its key splits), and prints, for each, the first
fit's log noise, the series and how many lanes' final factors (chol, beta,
K^-1) are not finite after the episode's O(n^2) appends:

    JAX_PLATFORMS=cpu python scripts/stacked_fleet_divergence.py [--lanes 32]

One JSON line per package. The JAX package runs here only as the reference
on the CPU; the port's card run of the same configuration is chip_smoke's
``[batch-stacked]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

from safe_exploration_tpu.runtime import batch as jbatch  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
)
from safe_exploration_tpu.runtime.main import (  # noqa: E402
    run_experiment as jax_run_experiment,
)
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import CONFIGS  # noqa: E402
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    run_experiment,
)
from test_torch_bridge import jax_batch_draws  # noqa: E402


def _capture(mod, store):
    fn = mod.run_batched_episodes

    def recorded(*args, **kwargs):
        store["initial"] = args[3]
        store["traj"], store["model"] = fn(*args, **kwargs)
        return store["traj"], store["model"]

    mod.run_batched_episodes = recorded
    return fn


def _report(name, summary, rec, to_np) -> dict:
    gp = rec["model"].gp
    bad = {f: ~np.isfinite(to_np(getattr(gp, f))).reshape(
        gp.x.shape[0], -1).all(axis=1) for f in ("chol", "beta", "kinv")}
    return {"package": name,
            "log_noise_first_fit": [float(v) for v in
                                    to_np(rec["initial"].gp.log_noise)[0]],
            "series": summary["series"],
            "lanes_nonfinite": int((bad["chol"] | bad["beta"]
                                    | bad["kinv"]).sum()),
            "lanes_nonfinite_by_factor": {f: int(v.sum())
                                          for f, v in bad.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=32)
    args = ap.parse_args()
    cfg = _apply_overrides(CONFIGS["pendulum_batch"],
                           [f"batch_lanes={args.lanes}"])
    jrec, trec = {}, {}
    saved = _capture(jbatch, jrec)
    try:
        jsum = jax_run_experiment(dataclasses.replace(
            JAX_CONFIGS["pendulum_batch"], **dataclasses.asdict(cfg)),
            dtype=jnp.float32)
    finally:
        jbatch.run_batched_episodes = saved
    print(json.dumps(_report("jax", jsum, jrec, np.asarray)), flush=True)

    def plan(k_plan):
        return np.stack([np.asarray(jax.random.normal(
            k, (cfg.cem_samples, cfg.n_safe, 1), jnp.float32))
            for k in jax.random.split(k_plan, cfg.cem_iterations)])

    draws = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in jax_batch_draws(cfg, args.lanes, jnp.float32,
                                         plan=plan).items()}
    saved = _capture(tbatch, trec)
    try:
        tsum = run_experiment(cfg, dtype=torch.float32, device="cpu",
                              draws=draws)
    finally:
        tbatch.run_batched_episodes = saved
    print(json.dumps(_report("port", tsum, trec,
                             lambda t: t.detach().cpu().numpy())), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

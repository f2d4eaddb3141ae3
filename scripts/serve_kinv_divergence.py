"""The serve task's f32 model in both packages, on the CPU.

Runs ``pendulum_serve`` as registered (40 steps of the NLP at 4 x 3 + 3,
n_max 256, one O(n^2) append a step) in f32 through the JAX package's CLI
path and through the port's on the JAX run's own draws (rebuilt from its
key splits), and prints, for each, the first fit's log noise, the series
and whether the served model's final factors (chol, beta, K^-1) are finite:

    JAX_PLATFORMS=cpu python scripts/serve_kinv_divergence.py [--steps 40]

One JSON line per package. The JAX package runs here only as the reference
on the CPU; the port's card run of the same configuration is chip_smoke's
``[serve]``.
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

from safe_exploration_tpu.runtime import serve as jserve  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
)
from safe_exploration_tpu.runtime.main import (  # noqa: E402
    run_experiment as jax_run_experiment,
)
from safe_exploration_tpu_torch.runtime import serve as tserve  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import CONFIGS  # noqa: E402
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    run_experiment,
)
from test_torch_bridge import jax_init_draws, jax_region  # noqa: E402


def _capture(mod, store):
    cls = mod.ServeController

    class Recorded(cls):
        def __init__(self, exp, ssm, *args, **kwargs):
            store["initial"] = ssm
            super().__init__(exp, ssm, *args, **kwargs)
            store["ctrl"] = self

    mod.ServeController = Recorded
    return cls


def _report(name, summary, rec, to_np) -> dict:
    gp = rec["ctrl"]._ssm_full.gp
    return {"package": name,
            "log_noise_first_fit": [float(v) for v in
                                    to_np(rec["initial"].gp.log_noise)],
            "series": summary["series"],
            "n_points": int(to_np(gp.mask).sum()),
            "finite": {f: bool(np.isfinite(to_np(getattr(gp, f))).all())
                       for f in ("chol", "beta", "kinv")},
            "kinv_max_abs": float(np.nanmax(np.abs(to_np(gp.kinv))))}


def _jax_draws(cfg) -> dict:
    """The JAX CLI's serve-task draws (runtime/main.py: initial data from
    its first key, x0 and the plant noise folded from its third)."""
    k1, _, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    draws = jax_init_draws(k1, cfg.n_init_samples, jnp.float32)
    draws["region_x"], draws["region_u"] = jax_region(384, jnp.float32)
    draws["reset"] = np.asarray(jax.random.normal(
        jax.random.fold_in(k3, 1), (2,), jnp.float32))[None]
    draws["step"] = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k3, 2 + i), (2,), jnp.float32))
        for i in range(cfg.n_steps)])[None]
    return draws


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    cfg = _apply_overrides(CONFIGS["pendulum_serve"],
                           [f"n_steps={args.steps}"])
    jrec, trec = {}, {}
    saved = _capture(jserve, jrec)
    try:
        jsum = jax_run_experiment(dataclasses.replace(
            JAX_CONFIGS["pendulum_serve"], **dataclasses.asdict(cfg)),
            dtype=jnp.float32)
    finally:
        jserve.ServeController = saved
    print(json.dumps(_report("jax", jsum, jrec, np.asarray)), flush=True)

    draws = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in _jax_draws(cfg).items()}
    saved = _capture(tserve, trec)
    try:
        tsum = run_experiment(cfg, dtype=torch.float32, device="cpu",
                              draws=draws)
    finally:
        tserve.ServeController = saved
    print(json.dumps(_report("port", tsum, trec,
                             lambda t: t.detach().cpu().numpy())), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

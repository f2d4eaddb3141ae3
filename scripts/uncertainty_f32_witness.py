"""Where the uncertainty task's f32 containment comes from: the fit or the
tube.

``pendulum_uncertainty`` fits a GP (120 Adam steps) on 40 points, then
checks 256 noisy rollouts against the tube of the zero plan. In f64 the
port's card and CPU runs agree; in f32 they do not. This script runs the
task on the JAX CLI's own draws (rebuilt from its key splits) in three
steps, and holds each f32 answer against the others with the model they
were computed on:

  1. ``reference`` (the CPU, needs the JAX package): the JAX CLI's run in
     f32 (in f64 with ``--x64``); writes its draws, its results and its
     fitted model.
  2. ``port`` (the card, imports nothing of JAX): the port on those draws,
     f32 and f64, on the card and on the CPU, plus two f32 CPU runs on the
     card's model: its tube and rollouts on the card's fitted and
     calibrated model as it is, and on a CPU refit (factors and
     calibration) of the card's fitted hyperparameters; writes the results
     and the card's and the CPU's fitted f32 models.
  3. ``cross`` (the CPU, needs the JAX package): JAX's tube and rollouts on
     the card's and on the port CPU's f32 models, and the port CPU's on
     JAX's; prints the table as one JSON line.

    JAX_PLATFORMS=cpu python scripts/uncertainty_f32_witness.py reference
    JAX_PLATFORMS=cpu python scripts/uncertainty_f32_witness.py reference --x64
    python scripts/uncertainty_f32_witness.py port
    JAX_PLATFORMS=cpu python scripts/uncertainty_f32_witness.py cross

``--dir`` (default ``build/uncertainty_witness``) holds what step 1 writes;
step 2 reads it and writes into ``--out`` (default: ``--dir``), which step
3 reads besides ``--dir``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

CONFIG = "pendulum_uncertainty"
KEYS = ("per_stage_containment", "overall_containment", "violation_rate")


def _save(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _hyper(arrays: dict) -> dict:
    """A fitted model's hyperparameters and Lipschitz constants as lists."""
    out = {"log_noise": np.asarray(arrays["log_noise"]).tolist(),
           "l_mu": np.asarray(arrays["l_mu"]).tolist(),
           "l_sigma": np.asarray(arrays["l_sigma"]).tolist()}
    for d, p in enumerate(arrays["params"]):
        for k, v in p.items():
            out[f"{k}_{d}"] = np.asarray(v).tolist()
    return out


def _result(res: dict, arrays: dict | None = None) -> dict:
    out = {k: res[k] for k in KEYS}
    out["p_traj"] = np.asarray(res["p_traj"], np.float64)
    out["q_traj"] = np.asarray(res["q_traj"], np.float64)
    if arrays is not None:
        out["hyper"] = _hyper(arrays)
    return out


# ------------------------------------------------------------ 1. reference
def _jax_draws(cfg, dtype) -> tuple[dict, object]:
    """The JAX CLI's uncertainty draws (runtime/main.py: the initial data
    from the first of two keys, the rollouts from the second;
    calibrate_lipschitz's region from its PRNGKey(0)) and that key."""
    import jax

    from test_torch_bridge import jax_init_draws, jax_region

    k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    draws = jax_init_draws(k1, cfg.n_init_samples, dtype)
    draws["region_x"], draws["region_u"] = jax_region(384, dtype)
    draws["rollout"] = np.asarray(jax.vmap(lambda k: jax.vmap(
        lambda kk: jax.random.normal(kk, (2,), dtype))(
            jax.random.split(k, cfg.n_safe)))(jax.random.split(k2, 256)))
    return draws, k2


def reference(args) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    # f32 as the JAX CLI runs it (x64 off); f64 as its --x64 does
    jax.config.update("jax_enable_x64", args.x64)
    import jax.numpy as jnp

    from safe_exploration_tpu.runtime import uncertainty as juncert
    from safe_exploration_tpu.runtime.config import CONFIGS as JAX_CONFIGS
    from safe_exploration_tpu.runtime.main import run_experiment
    from test_torch_bridge import jax_gpssm_to_numpy

    cfg = JAX_CONFIGS[CONFIG]
    name, dtype = (("float64", jnp.float64) if args.x64
                   else ("float32", jnp.float32))
    fn = juncert.run_uncertainty_estimation
    seen = {}

    def keep(env, ssm, *a, **kw):
        seen["ssm"] = ssm
        seen["res"] = fn(env, ssm, *a, **kw)
        return seen["res"]

    juncert.run_uncertainty_estimation = keep
    try:
        run_experiment(cfg, dtype=dtype)
    finally:
        juncert.run_uncertainty_estimation = fn
    draws, _ = _jax_draws(cfg, dtype)
    model = jax_gpssm_to_numpy(seen["ssm"])
    _save(os.path.join(args.dir, f"jax_{name}.pkl"),
          {"draws": draws, "model": model,
           "result": _result(seen["res"], model)})
    print(f"[reference] JAX {name}: "
          f"{ {k: seen['res'][k] for k in KEYS} }", flush=True)
    return 0


# ------------------------------------------------------------------ 2. port
def port(args) -> int:
    import torch

    import safe_exploration_tpu_torch.runtime.uncertainty as unc_mod
    from safe_exploration_tpu_torch.models.convert import (
        gpssm_from_numpy,
        gpssm_to_numpy,
    )
    from safe_exploration_tpu_torch.models.gp import gp_refit
    from safe_exploration_tpu_torch.models.ssm import calibrate_lipschitz
    from safe_exploration_tpu_torch.runtime.config import (
        CONFIGS,
        build_experiment,
    )
    from safe_exploration_tpu_torch.runtime.main import run_experiment

    ref = {name: _load(os.path.join(args.dir, f"jax_{name}.pkl"))
           for name in ("float32", "float64")}
    cfg = CONFIGS[CONFIG]
    devs = ["cuda", "cpu"] if torch.cuda.is_available() else ["cpu"]
    fn = unc_mod.run_uncertainty_estimation
    out, models = {}, {}
    for name, dtype in (("float32", torch.float32),
                        ("float64", torch.float64)):
        draws = {k: torch.tensor(v, dtype=dtype)
                 for k, v in ref[name]["draws"].items()}
        for dev in devs:
            seen = {}

            def keep(env, ssm, *a, **kw):
                seen["ssm"] = ssm
                seen["res"] = fn(env, ssm, *a, **kw)
                return seen["res"]

            unc_mod.run_uncertainty_estimation = keep
            try:
                run_experiment(cfg, dtype=dtype, device=dev, draws=draws)
            finally:
                unc_mod.run_uncertainty_estimation = fn
            model = gpssm_to_numpy(seen["ssm"])
            out[f"{name}_{dev}"] = _result(
                {k: (v.cpu() if torch.is_tensor(v) else v)
                 for k, v in seen["res"].items()}, model)
            models[f"{name}_{dev}"] = model
            print(f"[port] {name} {dev}: "
                  f"{ {k: seen['res'][k] for k in KEYS} }", flush=True)
    card = "float32_cuda" if "cuda" in devs else "float32_cpu"
    exp = build_experiment(cfg, dtype=torch.float32, device="cpu")
    kw = {"dtype": torch.float32}
    noise = torch.tensor(ref["float32"]["draws"]["rollout"], **kw)
    tube = dict(x0=torch.zeros((2,), **kw),
                k_ff_all=torch.zeros((cfg.n_safe, 1), **kw),
                c_safety=cfg.c_safety, noise=noise)
    ssm = gpssm_from_numpy(models[card], exp["kern_types"], device="cpu",
                           dtype=torch.float32)
    res = fn(exp["env"], ssm, exp["a"], exp["b"], exp["k_fb"], **tube)
    out["float32_cpu_on_card_model"] = _result(res, models[card])
    # the card's hyperparameters, with the factors and the calibration
    # computed again on the CPU
    d = ref["float32"]["draws"]
    region = tuple(torch.tensor(d[k], **kw) for k in ("region_x", "region_u"))
    ssm = calibrate_lipschitz(ssm.replace(gp=gp_refit(ssm.gp)),
                              exp["env"].spec, n_region=region[0].shape[0],
                              draws=region)
    model = gpssm_to_numpy(ssm)
    res = fn(exp["env"], ssm, exp["a"], exp["b"], exp["k_fb"], **tube)
    out["float32_cpu_refit_of_card_hyper"] = _result(res, model)
    for k in ("float32_cpu_on_card_model", "float32_cpu_refit_of_card_hyper"):
        print(f"[port] {k}: { {kk: out[k][kk] for kk in KEYS} }", flush=True)
    _save(os.path.join(args.out, "port.pkl"),
          {"results": out, "models": models, "devices": devs})
    return 0


# ----------------------------------------------------------------- 3. cross
def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


def cross(args) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from safe_exploration_tpu.runtime import uncertainty as juncert
    from safe_exploration_tpu.runtime.config import (
        CONFIGS as JAX_CONFIGS,
        build_experiment as jax_build,
    )
    from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy
    from safe_exploration_tpu_torch.runtime.config import build_experiment
    from safe_exploration_tpu_torch.runtime.uncertainty import (
        run_uncertainty_estimation,
    )

    ref = {name: _load(os.path.join(args.dir, f"jax_{name}.pkl"))
           for name in ("float32", "float64")}
    got = _load(os.path.join(args.out, "port.pkl"))
    runs = dict(got["results"])
    runs["float32_jax"] = ref["float32"]["result"]
    runs["float64_jax"] = ref["float64"]["result"]
    cfg = JAX_CONFIGS[CONFIG]
    f32 = jnp.float32
    jexp = jax_build(cfg, dtype=f32)
    _, k2 = _jax_draws(cfg, f32)
    jmodel = ref["float32"]["model"]

    def jax_tube(arrays):
        return juncert.run_uncertainty_estimation(
            jexp["env"], _jax_ssm(jexp, arrays, f32), jexp["a"], jexp["b"],
            jexp["k_fb"], key=k2, x0=jnp.zeros((2,), f32),
            k_ff_all=jnp.zeros((cfg.n_safe, 1), f32), c_safety=cfg.c_safety)

    card = "float32_cuda" if "float32_cuda" in got["models"] else \
        "float32_cpu"
    runs["float32_jax_on_card_model"] = _result(
        jax_tube(got["models"][card]), got["models"][card])
    runs["float32_jax_on_port_cpu_model"] = _result(
        jax_tube(got["models"]["float32_cpu"]), got["models"]["float32_cpu"])
    texp = build_experiment(cfg, dtype=torch.float32, device="cpu")
    kw = {"dtype": torch.float32}
    res = run_uncertainty_estimation(
        texp["env"], gpssm_from_numpy(jmodel, texp["kern_types"],
                                      device="cpu", dtype=torch.float32),
        texp["a"], texp["b"], texp["k_fb"], x0=torch.zeros((2,), **kw),
        k_ff_all=torch.zeros((cfg.n_safe, 1), **kw), c_safety=cfg.c_safety,
        noise=torch.tensor(ref["float32"]["draws"]["rollout"], **kw))
    runs["float32_port_cpu_on_jax_model"] = _result(
        {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in res.items()},
        jmodel)

    table = {}
    for name, r in runs.items():
        base = "float64_jax" if name.startswith("float64") else "float32_jax"
        table[name] = {
            **{k: r[k] for k in KEYS},
            "q_rel_to_" + base: _rel(r["q_traj"], runs[base]["q_traj"]),
            "q_rel_to_float64_jax": _rel(r["q_traj"],
                                         runs["float64_jax"]["q_traj"]),
            "hyper": r.get("hyper")}
    print(json.dumps({"config": CONFIG, "devices": got["devices"],
                      "runs": table}), flush=True)
    return 0


def _jax_ssm(jexp, arrays: dict, dtype):
    """A JAX GP-SSM holding ``arrays`` (the numpy bridge's keys), built by
    replacing every array of the JAX runner's first model."""
    import jax.numpy as jnp

    from safe_exploration_tpu.models import make_gp_ssm

    n, d_in = np.asarray(arrays["x"]).shape
    e = np.asarray(arrays["y"]).shape[1]
    z = jnp.zeros((1, 2), dtype)
    base = make_gp_ssm(jexp["kern_types"], z, jnp.zeros((1, 1), dtype),
                       jnp.zeros((1, e), dtype), n_max=n, l_mu=jexp["l_mu"],
                       l_sigma=jexp["l_sigma"], log_noise=-3.0)

    def t(a):
        return jnp.asarray(np.asarray(a), dtype)

    gp = base.gp.replace(
        x=t(arrays["x"]), y=t(arrays["y"]), mask=t(arrays["mask"]),
        params=tuple({k: t(v) for k, v in p.items()}
                     for p in arrays["params"]),
        log_noise=t(arrays["log_noise"]), chol=t(arrays["chol"]),
        beta=t(arrays["beta"]), kinv=t(arrays["kinv"]),
        head=jnp.asarray(np.asarray(arrays["head"]), jnp.int32))
    zs = arrays.get("z_scale")
    return base.replace(gp=gp, l_mu=t(arrays["l_mu"]),
                        l_sigma=t(arrays["l_sigma"]),
                        z_scale=None if zs is None else t(zs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("step", choices=("reference", "port", "cross"))
    ap.add_argument("--dir", default=os.path.join("build",
                                                  "uncertainty_witness"))
    ap.add_argument("--out", default=None,
                    help="where step 2 writes and step 3 reads its results "
                    "(default: --dir)")
    ap.add_argument("--x64", action="store_true",
                    help="reference: the f64 run (JAX's x64 on)")
    args = ap.parse_args()
    args.out = args.out or args.dir
    return {"reference": reference, "port": port, "cross": cross}[
        args.step](args)


if __name__ == "__main__":
    raise SystemExit(main())

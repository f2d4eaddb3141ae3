"""PyTorch port: BASELINE config 4's episodic configurations against the
JAX package, on the CPU, in f64.

``run_experiment`` on ``pendulum_episode_sparse`` (the portable CEM, m 32)
and on ``pendulum_large_sparse`` (the single-instance NLP), each cut to one
short episode at a small buffer, fed the JAX runner's draws rebuilt from its
key splits: violations, feasibility and n_data equal, model error and mean
cost within 1e-9, the final model (the VFE fit with Z, the refit after the
episode's ``ssm_update``) within 1e-8, the exact-GP episode tests' gate for
a model through two Adam fits. And both through ``main(...
--device cpu)``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    build_experiment as jax_build,
)
from safe_exploration_tpu.runtime.episode import (  # noqa: E402
    run_episodic as jax_run_episodic,
)
from safe_exploration_tpu_torch.runtime import episode as tep  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import CONFIGS  # noqa: E402
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    main,
    run_experiment,
)
from test_torch_bridge import jax_episode_draws, one_torch_thread  # noqa: E402,F401

F64 = jnp.float64
CASES = {
    "pendulum_episode_sparse": [
        "n_ep=1", "n_steps=3", "n_max=64", "n_init_samples=40",
        "hyp_iters=10", "cem_samples=16", "cem_elites=4", "cem_iterations=2"],
    "pendulum_large_sparse": [
        "n_ep=1", "n_steps=2", "n_max=64", "n_inducing=16",
        "n_init_samples=48", "hyp_iters=5", "sqp_outer=2", "sqp_inner=2"],
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _plan_draws(cfg):
    """One portable-CEM solve's draws from its key (None for the NLP)."""
    if cfg.solver != "cem":
        return None
    return lambda k: np.stack([
        np.asarray(jax.random.normal(kk, (cfg.cem_samples, cfg.n_safe, 1),
                                     F64))
        for kk in jax.random.split(k, cfg.cem_iterations)])


@pytest.mark.parametrize("name", list(CASES))
def test_run_experiment_matches_jax_with_its_draws(monkeypatch, name):
    runs = []
    run_episodic = tep.run_episodic

    def recorded(*args, **kwargs):
        runs.append(run_episodic(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tep, "run_episodic", recorded)
    cfg = _apply_overrides(CONFIGS[name], CASES[name])
    jexp = jax_build(dataclasses.replace(JAX_CONFIGS[name],
                                         **dataclasses.asdict(cfg)),
                     dtype=F64)
    ref = jax_run_episodic(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        kern_types=jexp["kern_types"], l_mu=jexp["l_mu"],
        l_sigma=jexp["l_sigma"], make_ssm=jexp["make_ssm"], n_max=cfg.n_max,
        n_ep=cfg.n_ep, n_steps=cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters)
    draws = jax_episode_draws(cfg, 128 * 3, plan=_plan_draws(cfg))
    series = run_experiment(cfg, dtype=torch.float64, device="cpu",
                            draws={k: _t(v) for k, v in draws.items()}
                            )["series"]
    rs = ref["series"]
    for k in ("violations", "feasibility_rate", "n_data"):
        assert series[k] == rs[k], k
    assert rs["violations"] == [0] and rs["n_data"] == [cfg.n_init_samples]
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(series[k], rs[k], rtol=1e-9, atol=0)
    (out,) = runs
    jg, tg = ref["ssm"].sgp, out["ssm"].sgp
    for f in ("z", "luu", "lsig", "alpha", "vmat", "log_noise"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < 1e-8, f
    assert _rel(out["ssm"].l_mu.numpy(), ref["ssm"].l_mu) < 1e-8
    assert tg.head == int(jg.head)


def test_main_on_cpu_prints_the_summary(capsys):
    for name, sets in CASES.items():
        rc = main(["--config", name, "--device", "cpu", "--set", *sets])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out)
        assert set(summary) == {"wall_time_s", "metrics", "series"}
        assert summary["series"]["violations"] == [0]
        assert np.isfinite(summary["series"]["model_error"]).all()

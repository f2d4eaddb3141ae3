"""PyTorch port: the MC-dropout configurations' episodes against the JAX
package, on the CPU, in f64 (the model itself: tests/test_torch_mcdropout.py):

  * ``run_experiment`` on ``pendulum_episode_mcdropout`` and
    ``pendulum_episode_concrete`` cut as the JAX package's own
    ``test_episodic_with_alternative_ssm_families`` cuts them, for one
    episode of 3 steps on the JAX runner's draws (the first model's and
    the fits' included): counts and flags equal, floats and the final model
    (its buffer holds the applied controls) at 1e-8; the concrete network
    again without the Lipschitz calibration, where the plan is taken in
    some steps;
  * the other tasks with an MC model: those the JAX CLI runs run, the
    batch and serve tasks (where the JAX CLI fails) raise naming ROADMAP
    Queue 1 item 14;
  * the episodic runner's checkpoint / resume with a GP and with an
    MC-dropout network: n_ep 1, then resumed to 2, bit for bit equal to
    the uninterrupted run (the rest of checkpoint / resume:
    tests/test_torch_checkpoint.py).
"""

import dataclasses
import os

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
from safe_exploration_tpu_torch.runtime import checkpoint as tck  # noqa: E402
from safe_exploration_tpu_torch.runtime import episode as tep  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    run_experiment,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_episode_draws,
    one_torch_thread,
)
from test_torch_checkpoint import (  # noqa: E402
    EPISODIC,
    F64,
    _assert_same,
    _cfg,
    _same_series,
)

# the JAX package's own cut of the alternative families' episode
# (tests/test_runtime.py::_tiny_cfg and
# test_episodic_with_alternative_ssm_families), 3 steps
TINY = ["n_safe=3", "n_max=64", "cem_samples=32", "cem_elites=8",
        "cem_iterations=3", "n_ep=1", "n_steps=3", "n_init_samples=12",
        "hyp_iters=10", "mc_hidden=16,16", "mc_samples=4", "l_mu=0.05",
        "l_sigma=0.02", "log_noise=-4.0"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


@pytest.mark.parametrize("name,calibrate,seed", [
    ("pendulum_episode_mcdropout", True, 0),
    ("pendulum_episode_concrete", True, 0),
    ("pendulum_episode_concrete", False, 2)])
def test_run_experiment_matches_jax_with_its_draws(monkeypatch, name,
                                                   calibrate, seed):
    """As registered the calibrated Lipschitz constants leave no step
    feasible, in both packages (ROADMAP Queue 3); without the calibration
    the cut's own constants let the CEM's plan be taken (at seed 2 in one
    of the 3 steps, so both branches of the safe controller run), and the
    applied controls (the episode's rows of the buffer) are compared."""
    runs = []
    run_episodic = tep.run_episodic

    def recorded(*args, **kwargs):
        runs.append(run_episodic(*args, calibrate_lipschitz=calibrate,
                                 **kwargs))
        return runs[-1]

    monkeypatch.setattr(tep, "run_episodic", recorded)
    cfg = _apply_overrides(CONFIGS[name], TINY + [f"seed={seed}"])
    jcfg = dataclasses.replace(JAX_CONFIGS[name], **dataclasses.asdict(cfg))
    jexp = jax_build(jcfg, dtype=jnp.float64)
    ref = jax_run_episodic(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        kern_types=jexp["kern_types"], l_mu=jexp["l_mu"],
        l_sigma=jexp["l_sigma"], make_ssm=jexp["make_ssm"], n_max=cfg.n_max,
        n_ep=cfg.n_ep, n_steps=cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
        calibrate_lipschitz=calibrate)

    def plan(k):
        return np.stack([np.asarray(jax.random.normal(
            kk, (cfg.cem_samples, cfg.n_safe, 1), jnp.float64))
            for kk in jax.random.split(k, cfg.cem_iterations)])

    draws = jax_episode_draws(cfg, 128 * 3, plan=plan)
    series = run_experiment(cfg, dtype=torch.float64, device="cpu",
                            draws={k: torch.tensor(v)
                                   for k, v in draws.items()})["series"]
    rs = ref["series"]
    for k in ("violations", "feasibility_rate", "n_data"):
        assert series[k] == rs[k], k
    assert rs["violations"] == [0] and rs["n_data"] == [cfg.n_init_samples]
    assert (0.0 < rs["feasibility_rate"][0] < 1.0) == (not calibrate)
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(series[k], rs[k], rtol=1e-8, atol=0)
    (out,) = runs
    tm, jm = out["ssm"], ref["ssm"]
    for (tw, tb), (jw, jb) in zip(tm.weights, jm.weights):
        assert _rel(tw.numpy(), jw) < 1e-8 and _rel(tb.numpy(), jb) < 1e-8
    if jm.keep_logit is not None:
        assert _rel(tm.keep_logit.numpy(), jm.keep_logit) < 1e-8
    assert _rel(tm.l_mu.numpy(), jm.l_mu) < 1e-8
    assert _rel(tm.l_sigma.numpy(), jm.l_sigma) < 1e-8
    assert _rel(tm.x.numpy(), jm.x) < 1e-8          # the episode's states
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    assert tm.head == int(jm.head)


def test_other_tasks_with_an_mc_model():
    """The combinations the JAX CLI runs with an MC model run in the port
    (the episodic task on the NLP and on the lane-CEM backend, which plans
    an MC model through the portable CEM; both exploration tasks; the
    uncertainty task, which fits its own GP); the batch and serve tasks,
    where the JAX CLI fails (no incremental append), raise naming their
    item."""
    mc = ["mc_hidden=8,8", "mc_samples=2", "n_max=32", "n_init_samples=10",
          "hyp_iters=2"]
    cem = ["cem_samples=8", "cem_elites=2", "cem_iterations=1"]
    nlp = ["sqp_outer=1", "sqp_inner=1"]
    runs = {
        "pendulum_episode_mcdropout": ["n_ep=1", "n_steps=2", "solver=sqp",
                                       *nlp],
        "pendulum_episode_concrete": ["n_ep=1", "n_steps=2",
                                      "cem_backend=lanes", *cem],
        "pendulum_exploration": ["ssm=mc_dropout", "n_ep=2", *cem],
        "pendulum_exploration_static": ["ssm=mc_dropout", "n_ep=1", *nlp],
        "pendulum_uncertainty": ["ssm=mc_dropout"],
    }
    for name, sets in runs.items():
        out = run_experiment(_apply_overrides(CONFIGS[name], sets + mc),
                             dtype=torch.float64, device="cpu")
        if "series" in out:
            assert sum(out["series"]["violations"]) == 0, name
        else:
            assert out["violation_rate"] == 0.0
    for name in ("pendulum_batch", "pendulum_batch_sqp", "pendulum_serve"):
        with pytest.raises(NotImplementedError, match="item 14"):
            run_experiment(_apply_overrides(CONFIGS[name],
                                            ["ssm=mc_dropout"] + mc),
                           device="cpu")


def _episodic(cfg, n_ep, ckpt_dir=None, resume=False):
    exp = build_experiment(cfg, dtype=F64, device="cpu")
    return tep.run_episodic(
        exp["env"], exp["init_state"], exp["get_action"], exp["a"], exp["b"],
        exp["k_fb"], kern_types=exp["kern_types"], n_max=cfg.n_max,
        l_mu=exp["l_mu"], l_sigma=exp["l_sigma"], n_ep=n_ep,
        n_steps=cfg.n_steps, n_init_samples=cfg.n_init_samples,
        hyp_iters=cfg.hyp_iters, make_ssm=exp["make_ssm"],
        generator=torch.Generator().manual_seed(5),
        plan_noise_shape=exp["planner_noise_shape"],
        ssm_draw_shapes=exp["ssm_draw_shapes"], ckpt_dir=ckpt_dir,
        resume=resume)


@pytest.mark.parametrize("family", ["gp", "mc_dropout"])
def test_episodic_resume_is_bit_exact(tmp_path, family):
    """n_ep 1 with a checkpoint, then resumed to 2, against the
    uninterrupted 2-episode run (which writes ckpt_0 and ckpt_1)."""
    name, sets = EPISODIC[family]
    cfg = _cfg(name, ["n_steps=2"] + sets)
    full = _episodic(cfg, 2, str(tmp_path / "full"))
    assert sorted(os.listdir(tmp_path / "full")) == ["ckpt_0.pt",
                                                     "ckpt_1.pt"]
    _episodic(cfg, 1, str(tmp_path / "part"))
    resumed = _episodic(cfg, 2, str(tmp_path / "part"), resume=True)
    _same_series(full["series"], resumed["series"], 2)
    _assert_same(full["ssm"], resumed["ssm"])
    # the checkpoint holds the model after its fit
    ck = tck.load_checkpoint(str(tmp_path / "full" / "ckpt_1.pt"))
    _assert_same(ck["ssm"], full["ssm"])
    assert ck["episode"] == 1 and ck["config"] is None

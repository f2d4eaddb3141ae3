"""PyTorch port: the stacked fleet runner (BASELINE config 3 as the JAX
package registers it, ``pendulum_batch``) against the JAX package, on the
CPU, in f64, at a tiny size (4 lanes, n_max 48, 3 steps, M 16, 2
iterations; 10 fit steps, where the first episode falls back on every
step and the second is feasible on every step):

  * ``cem_plan`` with a lane axis, over a stacked model (one model per
    lane) and over a shared one, through the model-batched scorer and
    through the reachability functions, against ``jax.vmap(cem_plan)`` on
    JAX's draws: flags equal, k_ff, the tube centres and the next warm
    start at 1e-9;
  * ``run_experiment`` on ``pendulum_batch`` with 2 episodes, fed the JAX
    CLI's draws rebuilt from its key splits: each episode of
    ``run_batched_episodes`` (the batched SafeMPC machine against JAX's
    vmapped single-instance one: counts and flags equal, trajectories and
    the final per-lane factors at 1e-9) and the ``run_batched_learning``
    series and final model (the stacked backend's per-lane fits) at 1e-8;
  * the overflow guard; the CLI on ``--device cpu`` (the JAX CLI's keys,
    ``lane_backend`` [0]).

Each JAX program is built once for the module.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.reachability.onestep import (  # noqa: E402
    multistep_reachability as jax_multistep,
)
from safe_exploration_tpu.runtime import batch as jbatch  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    build_experiment as jax_build,
)
from safe_exploration_tpu.runtime.main import (  # noqa: E402
    run_experiment as jax_run_experiment,
)
from safe_exploration_tpu.solvers import cem as jcem  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    main,
    run_experiment,
)
from safe_exploration_tpu_torch.solvers.cem import CemConfig, cem_plan  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    jax_batch_draws,
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
KT = ("rbf", "rbf")
B = 4
SET = ["batch_lanes=4", "n_max=48", "n_steps=3", "n_ep=2",
       "n_init_samples=24", "hyp_iters=10", "cem_samples=16",
       "cem_elites=4", "cem_iterations=2"]
CFG = _apply_overrides(CONFIGS["pendulum_batch"], SET)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jcfg():
    return dataclasses.replace(JAX_CONFIGS["pendulum_batch"],
                               **dataclasses.asdict(CFG))


def _plan_draws(k_plan, dtype=F64):
    """One lane's cem_plan draws from its key: per iteration
    (M, n_safe, n_u)."""
    return np.stack([np.asarray(jax.random.normal(
        k, (CFG.cem_samples, CFG.n_safe, 1), dtype))
        for k in jax.random.split(k_plan, CFG.cem_iterations)])


def _recorder(monkeypatch, mod, name, store):
    fn = getattr(mod, name)

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append(out)
        return out

    monkeypatch.setattr(mod, name, recorded)


@pytest.fixture(scope="module")
def exps():
    """The configuration built by both packages (f64)."""
    return (jax_build(_jcfg(), dtype=F64),
            build_experiment(CFG, dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def fleet():
    """run_experiment on pendulum_batch (tiny, 2 episodes) by both
    packages, the port on the JAX run's draws; each episode's (traj,
    model) and the learning run's result recorded on both sides."""
    rec = {k: [] for k in ("j_ep", "t_ep", "j_run", "t_run")}
    draws = {k: _t(v) for k, v in jax_batch_draws(
        CFG, B, plan=_plan_draws).items()}
    with pytest.MonkeyPatch.context() as mp:
        _recorder(mp, jbatch, "run_batched_episodes", rec["j_ep"])
        _recorder(mp, jbatch, "run_batched_learning", rec["j_run"])
        _recorder(mp, tbatch, "run_batched_episodes", rec["t_ep"])
        _recorder(mp, tbatch, "run_batched_learning", rec["t_run"])
        ref = jax_run_experiment(_jcfg(), dtype=F64)
        out = run_experiment(CFG, dtype=torch.float64, device="cpu",
                             draws=draws)
    return ref, out, rec


def _assert_stacked_gp(tg, jg, tol):
    for f in ("x", "y", "mask", "chol", "beta", "kinv", "log_noise"):
        assert _rel(_np(getattr(tg, f)), getattr(jg, f)) < tol, f
    assert tg.head == int(np.max(jg.head))
    for d in range(2):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(_np(tg.params[d][k]), jg.params[d][k]) < tol, (d, k)


@pytest.mark.parametrize("episode", [0, 1])
def test_run_batched_episodes_matches_jax_with_its_draws(fleet, episode):
    """One episode of the stacked runner: feasible flags and violations
    equal (episode 1 falls back on every step, episode 2 plans on every
    step), the trajectories and the final per-lane model (3 appends) at
    1e-9."""
    _, _, rec = fleet
    assert len(rec["t_ep"]) == len(rec["j_ep"]) == CFG.n_ep
    (tt, tm), (jt, jm) = rec["t_ep"][episode], rec["j_ep"][episode]
    np.testing.assert_array_equal(_np(tt["feasible"]), jt["feasible"])
    np.testing.assert_array_equal(_np(tt["constraint_ok"]),
                                  jt["constraint_ok"])
    assert _np(tt["feasible"]).mean() == float(episode)
    assert tt["x"].shape == (B, CFG.n_steps, 2)
    for k in ("x", "u", "resid", "model_err", "violation"):
        assert _rel(_np(tt[k]), jt[k]) < 1e-9, k
    _assert_stacked_gp(tm.gp, jm.gp, 1e-9)
    for f in ("l_mu", "l_sigma"):
        assert _rel(_np(getattr(tm, f)), getattr(jm, f)) < 1e-9, f


def test_run_batched_learning_series_match_jax_with_its_draws(fleet):
    """The stacked backend of run_batched_learning: the series' counts
    equal (lane_backend 0), its floats at 1e-8."""
    ref, out, _ = fleet
    rs, ts = ref["series"], out["series"]
    for k in ("violations", "feasibility_rate", "n_data", "lane_backend",
              "lanes"):
        assert ts[k] == rs[k], k
    assert rs["lane_backend"] == [0, 0] and rs["n_data"] == [27, 30]
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(ts[k], rs[k], rtol=1e-8, atol=0)


def test_run_batched_learning_final_model_matches_jax(fleet):
    """The final per-lane model after each lane's own fit and calibration
    (the stacked backend's between-episode step) at 1e-8; lanes that saw
    distinct data carry distinct constants."""
    _, _, rec = fleet
    (tr,), (jr,) = rec["t_run"], rec["j_run"]
    tm, jm = tr["model"], jr["model"]
    assert tm.gp.x.shape == (B, 48, 3)
    _assert_stacked_gp(tm.gp, jm.gp, 1e-8)
    for f in ("l_mu", "l_sigma"):
        assert _rel(_np(getattr(tm, f)), getattr(jm, f)) < 1e-8, f
    assert not torch.equal(tm.l_mu[0], tm.l_mu[1])


@pytest.fixture(scope="module")
def cem_case(fleet, exps):
    """Per model ("stacked": the fleet's final per-lane models, each lane
    its own; "shared": lane 0's model for every lane): both packages'
    models, 4 states (some past the constraint boundary), a zero warm
    start, the JAX draws and ``jax.vmap(cem_plan)``'s answer with the
    tube centres of its plan, each JAX program compiled once."""
    _, _, rec = fleet
    (tr,), (jr,) = rec["t_run"], rec["j_run"]
    jexp, _ = exps
    spec = jexp["env"].spec
    cfg = jcem.CemConfig(n_safe=CFG.n_safe, n_samples=CFG.cem_samples,
                         n_elites=CFG.cem_elites,
                         n_iterations=CFG.cem_iterations)
    x0s = np.random.default_rng(3).uniform(-1, 1, (B, 2)) * [0.2, 0.5]
    x0s[::2] *= 8.0
    warm = np.zeros((B, CFG.n_safe, 1))
    keys = jax.random.split(jax.random.PRNGKey(11), B)

    def one(key, ssm, x0, w):
        k_ff, feas, viol, info = jcem.cem_plan(
            key, ssm, x0, jexp["k_fb"], jexp["a"], jexp["b"], spec.u_min,
            spec.u_max, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe,
            spec.h_safe, CFG.c_safety, jexp["cost_fn"], cfg, w)
        p_traj, _, _ = jax_multistep(
            ssm, x0, k_ff, jnp.tile(jexp["k_fb"][None], (CFG.n_safe, 1, 1)),
            jexp["a"], jexp["b"], CFG.c_safety)
        return k_ff, feas, viol, info["warm_next"], p_traj

    out = {}
    for model in ("stacked", "shared"):
        jm, tm = jr["model"], tr["model"]
        if model == "shared":
            jm = jax.tree.map(lambda v: v[0], jm)
            tm = gpssm_from_numpy(jax_gpssm_to_numpy(jm), KT, device="cpu")
        fn = jax.vmap(one, in_axes=(0, 0 if model == "stacked" else None,
                                    0, 0))
        args = (keys, jm, jnp.asarray(x0s), jnp.asarray(warm))
        out[model] = (tm, x0s, warm, cfg, jit_once(fn, *args)(*args),
                      _t(np.stack([_plan_draws(k) for k in keys])))
    return out


@pytest.mark.parametrize("scorer", ["cem_score", "reachability"])
@pytest.mark.parametrize("model", ["stacked", "shared"])
def test_cem_plan_lane_axis_matches_jax_vmapped(cem_case, exps, model,
                                                scorer):
    """cem_plan on a lane axis from 4 states over per-lane models or one
    shared model, scored through the model-batched scorer (its plain
    version here; ``cost_kind`` given) or through the reachability
    functions (none given), against jax.vmap(cem_plan) on JAX's draws:
    flags equal (some feasible, some not), k_ff, the tube centres and
    warm_next at 1e-9."""
    tm, x0s, warm, cfg, (jk, jf, jv, jw, jp), noise = cem_case[model]
    _, texp = exps
    tspec = texp["env"].spec
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    tk, tf, tv, ti = cem_plan(
        None, tm, _t(x0s), texp["k_fb"], texp["a"], texp["b"],
        tspec.u_min, tspec.u_max, tspec.h_mat_obs, tspec.h_obs,
        tspec.h_mat_safe, tspec.h_safe, CFG.c_safety, texp["cost_fn"],
        CemConfig(**cfg._asdict()), _t(warm), noise=noise,
        cost_kind="tracking" if scorer == "cem_score" else None,
        cost_args={"target": tspec.target})
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert _rel(tk.numpy(), jk) < 1e-9
    assert _rel(ti["warm_next"].numpy(), jw) < 1e-9
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-12)
    assert _rel(ti["p_traj"].numpy(), jp) < 1e-9


def test_overflow_guard_refuses_the_episode(fleet, exps):
    """An episode whose appends would overflow the buffer is refused before
    it runs."""
    _, _, rec = fleet
    _, texp = exps
    (_, model), _ = rec["t_ep"]
    room = CFG.n_max - int(model.gp.n_points.max())
    with pytest.raises(ValueError, match="overflow the GP buffer"):
        tbatch.run_batched_episodes(
            texp["env"], texp["get_action_batch"], texp["init_state_batch"],
            model, torch.zeros((B, 2), dtype=torch.float64), room + 1,
            texp["a"], texp["b"])


def test_cli_on_cpu_prints_jax_keys(fleet, capsys):
    """The CLI's summary and series keys equal the JAX CLI's with
    lane_backend [0], for n_ep 2 and for the single-episode branch."""
    ref, _, _ = fleet
    rc = main(["--config", "pendulum_batch", "--device", "cpu", "--set",
               *SET])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == set(ref) - {"config"}
    assert set(summary["series"]) == set(ref["series"])
    assert summary["series"]["lane_backend"] == [0, 0]
    assert summary["series"]["violations"] == [0, 0]
    one = run_experiment(_apply_overrides(CFG, ["n_ep=1", "n_steps=1"]),
                         dtype=torch.float64, device="cpu")["series"]
    assert set(one) == {"lane_backend", "violations", "feasibility_rate",
                        "model_error", "lanes", "steps_per_sec"}
    assert one["lane_backend"] == [0] and one["lanes"] == [B]

"""PyTorch port: the CLI's serving, uncertainty and active-learning tasks
against the JAX package, on the CPU, in f64 (one file: its 11 tests
placed by scripts/tier1_schedule.py's simulation of the tier-1 run).

The serving surface (``runtime/serve.py``) runs on the JAX-fitted pendulum
golden state (tools/regen_goldens.build_problem("pendulum", 5): its
hyperparameters and Lipschitz constants) refitted by the port on 30
points in a buffer of 64 and carried across to the JAX package as numpy
arrays. No JAX ``ServeController`` is built (its step is AOT-compiled at
the full optimization level); the JAX references are ``get_action`` and
``ssm_append_point``, each compiled once with the bridge's ``jit_once``:

  * ``ServeController.step`` / ``observe`` for four rounds across the
    32 -> 64 bucket crossing against JAX's ``get_action`` and
    ``ssm_append_point`` on the same states: u at ``U_TOL``, the flags
    equal, ``recompiles`` 2 (the build and the crossing), the grown model's
    factors at 1e-9. JAX plans on the unbucketed model (n_max 64, its
    identity padding adds exact zeros), so the bucketed view is held to the
    same posterior;
  * the saturation guard: ``on_full="raise"`` and ``"drop"``;
  * the latency window and the exclusion of each build's first step, as
    tests/test_serve.py pins them for the JAX controller.

The tasks:

  * ``run_uncertainty_estimation`` on the golden state with 256 rollouts of
    the JAX runner's plant noise, rebuilt from its key splits: the
    containment rates and the violation rate equal, the tube at 1e-9;
  * ``run_exploration`` (greedy, the portable CEM under the exploration
    cost) and ``run_exploration_static`` (the probe NLP on the exact-Hessian
    AL core, from the previous optimum and one restart) for three and two
    iterations on the JAX runners' draws, with a hyperparameter re-fit
    inside: counts and flags equal, the float series, the probes and the
    final model at 1e-8. The JAX runners' ``jax.jit`` compiles at the
    bridge's FAST_COMPILE here (``fast_runners``, the uncertainty
    runner's too);
  * each of the four CLI configurations (serve, uncertainty, exploration,
    exploration_static) through ``main(... --device cpu)`` at a
    ``--set``-reduced size prints the JAX CLI's keys.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.runtime import exploration as jexpl  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.runtime import uncertainty as juncert  # noqa: E402
from safe_exploration_tpu_torch.envs.base import env_step  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.models.ssm import ssm_n_points  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.exploration import (  # noqa: E402
    run_exploration,
    run_exploration_static,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    main,
)
from safe_exploration_tpu_torch.runtime.serve import ServeController  # noqa: E402
from safe_exploration_tpu_torch.runtime.uncertainty import (  # noqa: E402
    run_uncertainty_estimation,
)
from test_torch_bridge import (  # noqa: E402,F401
    golden_problem,
    jax_gpssm_to_numpy,
    jax_init_draws,
    jax_region,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
KT = ("rbf", "rbf")
N_REGION = 384   # 128 d_in probes of the operating region (pendulum d_in 3)
SERVE = dict(name="serve", solver="sqp", n_safe=3, n_max=64, sqp_outer=3,
             sqp_inner=2, sqp_polish=2)
# the fixed-budget NLP answers rounding-level changes of its inputs with up
# to ~1e-7 in u: JAX's own get_action compiled at XLA's default optimization
# level and at level 0 (jit_once) differs by 1.06e-8 at the first state
# below, and the port lies between the two (7.96e-9 from level 0)
U_TOL = 1e-7


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _models(golden_problem, n_data, n_max):
    """The golden's 16 points, ``n_data - 16`` more of the same kind from a
    seeded numpy generator (their residuals from the noiseless plant), its
    fitted hyperparameters and Lipschitz constants, refitted by the port in
    a buffer of ``n_max``: (the JAX model from those arrays, the
    experiment the port's controller runs, the port's model)."""
    from safe_exploration_tpu_torch.models import gp as tgp
    from safe_exploration_tpu_torch.models.convert import gpssm_to_numpy

    _, gssm, *_ = golden_problem("pendulum", 5)
    texp = build_experiment(ExperimentConfig(**SERVE), dtype=torch.float64,
                            device="cpu")
    rng = np.random.default_rng(5)
    n_new = n_data - 16
    x = _t(rng.uniform(-1.0, 1.0, (n_new, 2)) * [0.3, 1.0])
    u = _t(0.4 * rng.uniform(-1.0, 1.0, (n_new, 1)))
    _, xn = env_step(texp["env"], x, u, noise=torch.zeros(n_new, 2))
    y = xn - (x @ texp["a"].T + u @ texp["b"].T)
    g = gssm.gp
    gp = tgp.gp_init(
        KT, torch.cat([_t(g.x[:16]), torch.cat([x, u], dim=1)]),
        torch.cat([_t(g.y[:16]), y]), n_max=n_max,
        params=tuple({k: _t(v) for k, v in p.items()} for p in g.params))
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(gssm), KT, device="cpu")
    tssm = tssm.replace(gp=tgp.gp_refit(gp.replace(log_noise=_t(g.log_noise))))
    a = gpssm_to_numpy(tssm)
    jgp_ = jgp.GP(kern_types=KT, params=tuple(
        {k: jnp.asarray(v) for k, v in p.items()} for p in a["params"]),
        head=jnp.asarray(a["head"], jnp.int32), **{
            k: jnp.asarray(a[k]) for k in ("x", "y", "mask", "log_noise",
                                           "chol", "beta", "kinv")})
    return gssm.replace(gp=jgp_), texp, tssm


def test_serve_rounds_across_a_bucket_match_jax(golden_problem):
    jssm, texp, tssm = _models(golden_problem, 30, 64)
    jexp = jax_build(JaxConfig(**SERVE), dtype=F64)
    ctrl = ServeController(texp, tssm)
    assert ctrl._bucket_n == 32 and ctrl.recompiles == 1

    key = jax.random.PRNGKey(0)

    def jax_step(state, ssm, x):
        u, state, info = jexp["get_action"](key, state, ssm, x)
        return u, state, info["feasible"], info["n_fail"]

    x = np.array([0.05, 0.1])
    jstate = jexp["init_state"]()
    jget = jit_once(jax_step, jstate, jssm, jnp.asarray(x))
    jappend = jit_once(jssm_mod.ssm_append_point, jssm, jnp.asarray(x),
                       jnp.zeros(1, F64), jnp.zeros(2, F64))
    rng = np.random.default_rng(3)
    flags = []
    for i in range(4):                   # 30 + 4 = 34 > 32: crosses once
        u = ctrl.step(x)
        ju, jstate, jfeas, jnfail = jget(jstate, jssm, jnp.asarray(x))
        assert u.shape == (1,)
        np.testing.assert_allclose(u, np.asarray(ju), rtol=U_TOL, atol=0)
        assert ctrl.last_feasible == bool(jfeas)
        assert ctrl.last_n_fail == int(jnfail)
        flags.append(ctrl.last_feasible)
        _, xn = env_step(texp["env"], _t(x), _t(u),
                         noise=_t(rng.standard_normal(2)))
        x_next = xn.numpy()
        ctrl.observe(x, u, x_next)
        y = x_next - (np.asarray(jexp["a"]) @ x + np.asarray(jexp["b"]) @ u)
        jssm = jappend(jssm, jnp.asarray(x), jnp.asarray(u), jnp.asarray(y))
        assert ctrl._bucket_n == (32 if i < 2 else 64)
        x = x_next
    assert ctrl.recompiles == 2
    assert ctrl.dropped_points == 0
    tg, jg = ctrl._ssm_full.gp, jssm.gp
    assert tg.head == int(jg.head) == 34
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < 1e-9, f
    assert any(flags), flags


@pytest.mark.parametrize("on_full", ["raise", "drop"])
def test_serve_observe_on_a_full_buffer(golden_problem, on_full):
    """Two free slots fill; the next transition raises, or is counted in
    dropped_points while the frozen model keeps serving."""
    _, texp, tssm = _models(golden_problem, 30, 32)
    ctrl = ServeController(texp, tssm, on_full=on_full)
    x = np.array([0.05, 0.1])
    for _ in range(2):
        u = ctrl.step(x)
        _, xn = env_step(texp["env"], _t(x), _t(u), noise=torch.zeros(2))
        ctrl.observe(x, u, xn.numpy())
        x = xn.numpy()
    assert int(ssm_n_points(ctrl._ssm_full)) == 32
    u = ctrl.step(x)
    if on_full == "raise":
        with pytest.raises(RuntimeError, match="full"):
            ctrl.observe(x, u, x)
    else:
        frozen = ctrl._ssm_full
        ctrl.observe(x, u, x)
        ctrl.observe(x, u, x)
        assert ctrl.dropped_points == 2 and ctrl._ssm_full is frozen
        assert np.all(np.isfinite(ctrl.step(x)))
    assert ctrl.recompiles == 1


def test_serve_latency_window_and_per_build_exclusion(golden_problem):
    """The first step after each build is left out of the window; the window
    is bounded; no sample gives None percentiles."""
    _, texp, tssm = _models(golden_problem, 30, 64)
    ctrl = ServeController(texp, tssm, latency_window=4)
    x = np.array([0.05, 0.1])
    assert ctrl.latency_stats() == {"n": 0, "p50_ms": None, "p99_ms": None,
                                    "mean_ms": None}
    ctrl.step(x)
    assert ctrl.latency_stats()["n"] == 0      # the build's first step
    ctrl.step(x)
    ctrl.step(x)
    assert ctrl.latency_stats()["n"] == 2
    for _ in range(3):                          # the window caps at 4
        ctrl.step(x)
    assert ctrl.latency_stats()["n"] == 4
    ctrl._build_step(ctrl._ssm_plan)            # a rebuild: skip again
    assert ctrl.recompiles == 2
    ctrl.step(x)
    assert ctrl.latency_stats()["n"] == 4
    ctrl.step(x)
    stats = ctrl.latency_stats()
    assert stats["n"] == 4 and 0.0 < stats["p50_ms"] <= stats["p99_ms"]


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, F64))


def test_uncertainty_matches_jax_with_its_draws(golden_problem,
                                                fast_runners):
    """The tube of a plan from x0 on the golden model against 256 noisy
    rollouts; the plan and c_safety leave some stages' containment below
    1 so the rates are not all trivial."""
    jexp, jssm, _, x0, k_ff = golden_problem("pendulum", 5)
    texp = build_experiment(ExperimentConfig(), dtype=torch.float64,
                            device="cpu")
    key = jax.random.PRNGKey(4)
    kw = dict(x0=x0, k_ff_all=k_ff, c_safety=0.5, n_rollouts=256)
    ref = juncert.run_uncertainty_estimation(
        jexp["env"], jssm, jexp["a"], jexp["b"], jexp["k_fb"], key=key, **kw)
    t_len = k_ff.shape[0]
    noise = np.asarray(jax.vmap(lambda k: jax.vmap(
        lambda kk: jax.random.normal(kk, (2,), F64))(
            jax.random.split(k, t_len)))(jax.random.split(key, 256)))
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), KT, device="cpu")
    out = run_uncertainty_estimation(
        texp["env"], tssm, texp["a"], texp["b"], texp["k_fb"],
        noise=_t(noise), **{k: _t(v) if k in ("x0", "k_ff_all") else v
                            for k, v in kw.items()})
    for k in ("per_stage_containment", "overall_containment",
              "violation_rate"):
        assert out[k] == ref[k], k
    assert 0.0 < min(ref["per_stage_containment"]) < 1.0
    for k in ("p_traj", "q_traj"):
        assert _rel(out[k].numpy(), ref[k]) < 1e-9, k


class _FastJit:
    """The ``jax`` module as a JAX runner module sees it, with ``jax.jit``
    compiling once at the first call's shapes with the bridge's
    FAST_COMPILE (``jit_once``)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        compiled = []

        def call(*args):
            if not compiled:
                compiled.append(jit_once(fn, *args))
            return compiled[0](*args)

        return call


@pytest.fixture
def fast_runners(monkeypatch):
    for mod in (jexpl, juncert):
        monkeypatch.setattr(mod, "jax", _FastJit())


def _cfgs(name, sets):
    cfg = _apply_overrides(CONFIGS[name], sets)
    jcfg = dataclasses.replace(JAX_CONFIGS[name], **dataclasses.asdict(cfg))
    return (cfg, jax_build(jcfg, dtype=F64),
            build_experiment(cfg, dtype=torch.float64, device="cpu"))


def _common(cfg, exp, opt_hyp_every):
    return dict(kern_types=KT, n_max=cfg.n_max, l_mu=exp["l_mu"],
                l_sigma=exp["l_sigma"], n_iterations=cfg.n_ep * cfg.n_steps,
                n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
                opt_hyp_every=opt_hyp_every, make_ssm=exp["make_ssm"])


def _assert_series_and_model(out, ref, n_data):
    ts, rs = out["series"], ref["series"]
    assert set(ts) == set(rs)
    for k in ("feasibility_rate", "violations", "n_data"):
        assert ts[k] == rs[k], k
    assert rs["n_data"] == n_data and not any(rs["violations"])
    for k in ("info_gain", "pred_std_sum", "model_error"):
        np.testing.assert_allclose(ts[k], rs[k], rtol=1e-8, atol=0)
    jg, tg = ref["ssm"].gp, out["ssm"].gp
    for f in ("chol", "beta", "kinv", "log_noise"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < 1e-8, f


EXPLORATION_SET = ["n_ep=3", "n_init_samples=20", "n_max=32", "hyp_iters=5",
                   "cem_samples=16", "cem_elites=4", "cem_iterations=2"]


def test_run_exploration_matches_jax_with_its_draws(fast_runners):
    """Greedy exploration, 3 iterations (a hyperparameter re-fit after the
    second), on the JAX runner's draws (runtime/exploration.py's key
    splits, cem_plan's per-iteration keys)."""
    cfg, jexp, texp = _cfgs("pendulum_exploration", EXPLORATION_SET)
    ref = jexpl.run_exploration(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        **_common(cfg, jexp, 2))
    k_init, _, k_reset, key = jax.random.split(jax.random.PRNGKey(cfg.seed),
                                               4)
    draws = jax_init_draws(k_init, cfg.n_init_samples)
    draws["region_x"], draws["region_u"] = jax_region(N_REGION)
    plans, steps = [], []
    for _ in range(cfg.n_ep):
        k_it, key = jax.random.split(key)
        k_plan, k_step = jax.random.split(k_it)
        plans.append(np.stack([
            _normal(k, (cfg.cem_samples, cfg.n_safe, 1))
            for k in jax.random.split(k_plan, cfg.cem_iterations)]))
        steps.append(_normal(k_step, (2,)))
    draws.update(reset=_normal(k_reset, (2,))[None],
                 plan=np.stack(plans)[None], step=np.stack(steps)[None])
    out = run_exploration(
        texp["env"], texp["init_state"], texp["get_action"], texp["a"],
        texp["b"], texp["k_fb"], draws={k: _t(v) for k, v in draws.items()},
        **_common(cfg, texp, 2))
    _assert_series_and_model(out, ref, [21, 22, 23])


STATIC_SET = ["n_ep=2", "n_init_samples=20", "n_max=32", "hyp_iters=5",
              "n_safe=2", "sqp_outer=2", "sqp_inner=2"]


def test_run_exploration_static_matches_jax_with_its_draws(fast_runners):
    """Static exploration, 2 iterations of the probe NLP from the previous
    optimum and 1 restart (a hyperparameter re-fit after the second), on
    the JAX runner's draws (its key splits and uniform restart draws)."""
    cfg, jexp, texp = _cfgs("pendulum_exploration_static", STATIC_SET)
    kw = dict(n_restarts=1, n_safe=cfg.n_safe, c_safety=cfg.c_safety,
              sqp_outer=cfg.sqp_outer, sqp_inner=cfg.sqp_inner)
    ref = jexpl.run_exploration_static(
        jexp["env"], jexp["a"], jexp["b"], jexp["k_fb"],
        key=jax.random.PRNGKey(cfg.seed), **_common(cfg, jexp, 2), **kw)
    k_init, _, key = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    draws = jax_init_draws(k_init, cfg.n_init_samples)
    draws["region_x"], draws["region_u"] = jax_region(N_REGION)
    n_flat = 2 + cfg.n_safe
    restarts, steps = [], []
    for _ in range(cfg.n_ep):
        k_it, key = jax.random.split(key)
        k_restart, k_step = jax.random.split(k_it)
        restarts.append(np.asarray(jax.random.uniform(
            k_restart, (1, n_flat), F64, -1.0, 1.0)))
        steps.append(_normal(k_step, (2,)))
    draws.update(restart=np.stack(restarts), step=np.stack(steps)[None])
    out = run_exploration_static(
        texp["env"], texp["a"], texp["b"], texp["k_fb"],
        draws={k: _t(v) for k, v in draws.items()},
        **_common(cfg, texp, 2), **kw)
    _assert_series_and_model(out, ref, [21, 22])
    assert _rel(out["probes"].numpy(), ref["probes"]) < 1e-8


CLI_SETS = {
    "pendulum_serve": ["n_steps=3", "n_init_samples=30", "n_max=64",
                       "hyp_iters=3", "n_safe=3", "sqp_outer=2",
                       "sqp_inner=1", "sqp_polish=1"],
    "pendulum_uncertainty": ["n_init_samples=20", "n_max=32", "hyp_iters=3"],
    "pendulum_exploration": EXPLORATION_SET[:4] + [
        "cem_samples=8", "cem_elites=2", "cem_iterations=1"],
    "pendulum_exploration_static": ["n_ep=1", "n_init_samples=20",
                                    "n_max=32", "hyp_iters=3", "n_safe=2",
                                    "sqp_outer=1", "sqp_inner=1"],
}


@pytest.mark.parametrize("name", sorted(CLI_SETS))
def test_main_on_cpu_prints_the_jax_keys(capsys, name):
    """Each new task through the CLI on the CPU prints the JAX CLI's keys:
    the serve task's six series, the uncertainty task's containment keys,
    the exploration tasks' six series; 0 violations."""
    assert main(["--config", name, "--device", "cpu", "--set",
                 *CLI_SETS[name]]) == 0
    summary = json.loads(capsys.readouterr().out)
    if name == "pendulum_uncertainty":
        assert set(summary) == {"wall_time_s", "metrics",
                                "per_stage_containment",
                                "overall_containment", "violation_rate"}
        assert len(summary["per_stage_containment"]) == 5
        return
    assert set(summary) == {"wall_time_s", "metrics", "series"}
    series = summary["series"]
    if name == "pendulum_serve":
        assert set(series) == {"feasibility_rate", "violations",
                               "recompiles", "dropped_points",
                               "latency_p50_ms", "latency_p99_ms"}
        assert series["recompiles"] == [2] and series["dropped_points"] == [0]
        assert series["violations"] == [0]
    else:
        assert set(series) == {"info_gain", "pred_std_sum", "model_error",
                               "feasibility_rate", "violations", "n_data"}
        assert not any(series["violations"])
        assert np.isfinite(series["info_gain"]).all()

"""PyTorch port: whole episodes and the quadrotor fleet's first step held
against the JAX package on its own draws (``-m slow``: minutes each, most
of it the JAX package's compiles; outside tier-1).

  * one episode of ``cartpole_episode`` (the portable CEM with a perf
    trajectory), ``cartpole_episode_sqp`` and ``cartpole_risk_sqp`` (the
    single-instance NLP, the second under the risk objective) and
    ``quadrotor_episode`` (the portable CEM at n_s 6), each cut to a few
    steps, in f64, fed the JAX runner's draws: the counts equal, the model
    error and mean cost at 1e-9, the final model's factors and
    hyperparameters at 1e-9;
  * ``quadrotor_batch_sqp`` at full width (64 lanes) in f32: on the JAX
    CLI's first model both packages' first fleet step give the same
    feasible flags, and in f64 the first fit and calibration equal JAX's
    at 1e-8; on chip_smoke's seed-0 draws each package's own f32 first
    model gives the same flags; its first 8-step f32 episode from the JAX
    package's first model diverges in as many lanes (within 4) in both;
  * ``cartpole_risk_sqp``'s NLP at chip_smoke's cut (n_safe 5, 4 x 3 + 3):
    its spread under tiny changes of x0 in both packages, and at the
    registered 10 stages its divergence in both; the lane SQP's spread
    under the risk cost, against chip_smoke's card-vs-CPU gate.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp_lanes as jgl  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    build_experiment as jax_build,
)
from safe_exploration_tpu.runtime.episode import (  # noqa: E402
    collect_initial_data as jax_collect,
    run_episodic as jax_run_episodic,
)
from safe_exploration_tpu_torch.models import gp_lanes as tgl  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime import episode as tep  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    run_experiment,
)
from safe_exploration_tpu_torch.solvers.cem import (  # noqa: E402
    CemConfig,
    cem_warm_len,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_batch_draws,
    jax_episode_draws,
    jax_gpssm_to_numpy,
    jax_region,
    one_torch_thread,
)

F64 = jnp.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_plan_draws(key, cfg, n_u):
    """cem_plan's per-iteration draws from its key (the portable CEM)."""
    t_total = cem_warm_len(CemConfig(n_safe=cfg.n_safe, n_perf=cfg.n_perf,
                                     r_shared=cfg.r_shared))
    return np.stack([np.asarray(jax.random.normal(
        k, (cfg.cem_samples, t_total, n_u), F64))
        for k in jax.random.split(key, cfg.cem_iterations)])


SMALL = ["n_ep=1", "n_steps=3", "n_max=32", "n_init_samples=20",
         "hyp_iters=10"]
EPISODES = [
    ("cartpole_episode", SMALL + ["cem_samples=16", "cem_elites=4",
                                  "cem_iterations=2"]),
    ("cartpole_episode_sqp", SMALL + ["sqp_outer=2", "sqp_inner=2"]),
    ("cartpole_risk_sqp", SMALL + ["sqp_outer=2", "sqp_inner=2"]),
    ("quadrotor_episode", SMALL + ["cem_samples=16", "cem_elites=4",
                                   "cem_iterations=2"]),
]


@pytest.mark.slow
@pytest.mark.parametrize("config,sets", EPISODES,
                         ids=[name for name, _ in EPISODES])
def test_episode_matches_jax_with_its_draws(monkeypatch, config, sets):
    """One episode of ``config`` at the registered horizons, cut to 3 steps
    (n_max 32, 20 initial points, 10 fit steps, a small CEM or a 2 x 2
    NLP budget), f64: the JAX runner with the key of cfg.seed, and the
    port's run_experiment fed the same draws (the initial data, the
    calibration's region, the resets, the plant noise and the CEM's
    samples): counts equal, the float series at 1e-9, the final model's
    factors and hyperparameters at 1e-9. Prints both wall times."""
    runs = []
    run_episodic = tep.run_episodic

    def recorded(*args, **kwargs):
        runs.append(run_episodic(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tep, "run_episodic", recorded)
    cfg = _apply_overrides(CONFIGS[config], sets)
    jexp = jax_build(dataclasses.replace(
        JAX_CONFIGS[config], **dataclasses.asdict(cfg)), dtype=F64)
    spec = jexp["env"].spec
    n_s, n_u = spec.n_s, spec.n_u
    t0 = time.perf_counter()
    ref = jax_run_episodic(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        kern_types=jexp["kern_types"], l_mu=jexp["l_mu"],
        l_sigma=jexp["l_sigma"], make_ssm=jexp["make_ssm"], n_max=cfg.n_max,
        n_ep=cfg.n_ep, n_steps=cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters)
    t_jax = time.perf_counter() - t0
    plan = (None if cfg.solver == "sqp"
            else (lambda k: _jax_plan_draws(k, cfg, n_u)))
    draws = jax_episode_draws(cfg, 128 * (n_s + n_u), plan=plan, n_s=n_s,
                              n_u=n_u)
    t0 = time.perf_counter()
    series = run_experiment(cfg, dtype=torch.float64, device="cpu",
                            draws={k: _t(v) for k, v in draws.items()}
                            )["series"]
    t_port = time.perf_counter() - t0
    rs = ref["series"]
    print(f"{config}: JAX {t_jax:.1f} s, port {t_port:.1f} s; feasibility "
          f"{rs['feasibility_rate']}, violations {rs['violations']}")
    assert set(series) == set(rs)
    for k in ("violations", "feasibility_rate", "n_data"):
        assert series[k] == rs[k], k
    assert rs["violations"] == [0]
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(series[k], rs[k], rtol=1e-9, atol=0)
    (out,) = runs
    jg, tg = ref["ssm"].gp, out["ssm"].gp
    for f in ("chol", "beta", "kinv", "log_noise"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < 1e-9, f
    for d in range(n_s):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(tg.params[d][k].numpy(), jg.params[d][k]) < 1e-9, k


def _jax_first_fit(cfg, jexp, key, data):
    """The JAX runner's first model on ``data`` (numpy xs, us, residuals):
    ``ssm_fit`` then ``calibrate_lipschitz`` on its own region draws."""
    spec = jexp["env"].spec

    def fit(s):
        return jssm_mod.calibrate_lipschitz(
            jssm_mod.ssm_fit(s, iters=cfg.hyp_iters), spec)

    dt = jexp["a"].dtype
    return jax.jit(fit)(jexp["make_ssm"](
        key, *(jnp.asarray(v, dt) for v in data)))


@pytest.mark.slow
def test_quadrotor_full_width_f32_step_and_fit_match_jax():
    """quadrotor_batch_sqp at full width on the CPU, the JAX side with x64
    off as its CLI runs. (1) The JAX CLI's first model (its draws, fit and
    calibration) stacked into 64 lanes, and the first step of episode 1
    from its x0s through both packages' batch planners (n_safe 3, n_perf
    5, 4 x 3 SQP), f32: feasible flags equal. (2) In f64 the first fit and
    calibration on the JAX CLI's points and region draws equal JAX's at
    1e-8. (3) On the draws chip_smoke's ``[quadrotor-batch]`` makes (a CPU
    generator seeded 0) each package's own f32 first model, stacked into
    64 lanes, and the first step from the seed-0 x0s: flags equal."""
    cfg = CONFIGS["quadrotor_batch_sqp"]
    lanes, n_s, n_u = cfg.batch_lanes, 6, 2
    n_region = 128 * (n_s + n_u)
    texp = build_experiment(cfg, dtype=torch.float32, device="cpu")
    tspec = texp["env"].spec
    d = tbatch.batch_draws(torch.Generator().manual_seed(0), tspec,
                           batch=lanes, n_ep=cfg.n_ep, n_steps=cfg.n_steps,
                           n_init=cfg.n_init_samples, n_region=n_region,
                           dtype=torch.float32)
    seed0 = tep.collect_initial_data(texp["env"], cfg.n_init_samples,
                                     texp["a"], texp["b"], texp["k_fb"],
                                     draws=d)
    x0_seed0 = tspec.init_m + tspec.init_std * d["reset"][0]
    k1, k2, _, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    t0 = time.perf_counter()
    with jax.enable_x64(False):
        f32 = jnp.float32
        jexp = jax_build(JAX_CONFIGS["quadrotor_batch_sqp"], dtype=f32)
        spec = jexp["env"].spec
        get_action = jax.jit(jexp["get_action_batch"])

        def first_step(m, x0):
            view = jgl.lane_shrink_to_bucket(jgl.lane_stack_ssm(m, lanes),
                                             n_free=cfg.n_steps)
            _, _, info = get_action(jexp["init_state_batch"](lanes), view,
                                    x0)
            return np.asarray(info["feasible"])

        cli_data = [np.asarray(v) for v in jax_collect(
            jexp["env"], k1, cfg.n_init_samples, jexp["a"], jexp["b"],
            jexp["k_fb"])]
        jcli = _jax_first_fit(cfg, jexp, k2, cli_data)
        x0 = spec.init_m + spec.init_std * jnp.asarray(
            jax_batch_draws(cfg, lanes, f32, n_s, n_u)["reset"][0])
        jf = first_step(jcli, x0)
        jfit = _jax_first_fit(cfg, jexp, k2, [v.numpy() for v in seed0])
        jf0 = first_step(jfit, jnp.asarray(x0_seed0.numpy()))
        jcli_np = jax_gpssm_to_numpy(jcli)
        x0 = np.asarray(x0)
    with jax.enable_x64(True):
        jexp64 = jax_build(JAX_CONFIGS["quadrotor_batch_sqp"], dtype=F64)
        j64 = jax_gpssm_to_numpy(_jax_first_fit(cfg, jexp64, k2, cli_data))
    t_jax = time.perf_counter() - t0

    def port_first_step(m, x0):
        view = tgl.lane_shrink_to_bucket(tgl.lane_stack_ssm(m, lanes),
                                         n_free=cfg.n_steps)
        _, _, info = texp["get_action_batch"](
            texp["init_state_batch"](lanes), view, x0)
        return info["feasible"].numpy()

    t0 = time.perf_counter()
    tm = gpssm_from_numpy(jcli_np, ("rbf",) * n_s, device="cpu",
                          dtype=torch.float32)
    tf = port_first_step(tm, torch.tensor(x0))
    t64 = build_experiment(cfg, dtype=torch.float64, device="cpu")
    fit64 = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(t64["make_ssm"](*(_t(v) for v in cli_data)),
                         iters=cfg.hyp_iters), t64["env"].spec,
        n_region=n_region,
        draws=tuple(_t(v) for v in jax_region(n_region, F64, n_s, n_u)))
    tfit = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(texp["make_ssm"](*seed0), iters=cfg.hyp_iters),
        tspec, n_region=n_region, draws=(d["region_x"], d["region_u"]))
    tf0 = port_first_step(tfit, x0_seed0)
    t_port = time.perf_counter() - t0
    print(f"quadrotor fleet: JAX {t_jax:.1f} s, port {t_port:.1f} s; step 0 "
          f"on JAX's model: JAX feasible {jf.mean()}, port {tf.mean()}; on "
          f"the seed-0 draws: JAX {jf0.mean()}, port {tf0.mean()}; f64 l_mu "
          f"port {fit64.l_mu.tolist()}, JAX {j64['l_mu'].tolist()}")
    np.testing.assert_array_equal(tf, jf)
    assert _rel(fit64.gp.log_noise.numpy(), j64["log_noise"]) < 1e-8
    for d_ in range(n_s):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(fit64.gp.params[d_][k].numpy(),
                        j64["params"][d_][k]) < 1e-8, k
    assert _rel(fit64.l_mu.numpy(), j64["l_mu"]) < 1e-8
    assert _rel(fit64.l_sigma.numpy(), j64["l_sigma"]) < 1e-8
    np.testing.assert_array_equal(tf0, jf0)


def _lane_models_bad(beta, kinv):
    """Lanes whose lane model (beta, K^-1; lanes last) is not finite."""
    beta, kinv = np.asarray(beta), np.asarray(kinv)
    return ~(np.isfinite(beta).all(axis=(0, 1))
             & np.isfinite(kinv).all(axis=(0, 1, 2)))


@pytest.mark.slow
def test_quadrotor_fleet_f32_episode_matches_jax():
    """quadrotor_batch_sqp's first episode at its registered 8 steps and
    full width (64 lanes) in f32, on the draws chip_smoke's
    ``[quadrotor-batch]`` makes (a CPU generator seeded 0: initial points,
    x0 and plant noise), from the JAX package's f32 first model on those
    points, handed to both packages. The JAX side runs its lane runner's
    step (``get_action_batch``, the plant's integration, ``lane_predict``,
    ``lane_append_point``, as ``runtime/batch.py``'s scan body) with that
    plant noise. Each package's count of lanes whose model leaves the
    episode non-finite (the f32 append's divergence below the jitter) is
    within 4 of the other's, and the feasible share of each step within
    0.1. Prints both, and the port's episode from its own f32 first model
    on the same draws."""
    from safe_exploration_tpu.envs import base as jbase
    from safe_exploration_tpu_torch.envs.base import env_reset

    cfg = CONFIGS["quadrotor_batch_sqp"]
    lanes, steps = cfg.batch_lanes, cfg.n_steps
    texp = build_experiment(cfg, dtype=torch.float32, device="cpu")
    tspec = texp["env"].spec
    d = tbatch.batch_draws(torch.Generator().manual_seed(0), tspec,
                           batch=lanes, n_ep=cfg.n_ep, n_steps=steps,
                           n_init=cfg.n_init_samples, n_region=128 * 8,
                           dtype=torch.float32)
    seed0 = tep.collect_initial_data(texp["env"], cfg.n_init_samples,
                                     texp["a"], texp["b"], texp["k_fb"],
                                     draws=d)
    x0 = env_reset(texp["env"], batch=(lanes,), noise=d["reset"][0])
    noise = d["step"][0]
    k2 = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[1]
    t0 = time.perf_counter()
    with jax.enable_x64(False):
        jexp = jax_build(JAX_CONFIGS["quadrotor_batch_sqp"], dtype=jnp.float32)
        env, spec, a, b = jexp["env"], jexp["env"].spec, jexp["a"], jexp["b"]
        jfit = _jax_first_fit(cfg, jexp, k2, [v.numpy() for v in seed0])
        get_action = jax.jit(jexp["get_action_batch"])

        @jax.jit
        def plant_and_append(s, xs, u, noise_t):
            u_app = jnp.clip(u, spec.u_min, spec.u_max)
            x_next = jax.vmap(lambda x, uu: jbase._integrate(env, x, uu))(
                xs, u_app) + spec.plant_noise * noise_t
            resid = x_next - (xs @ a.T + u_app @ b.T)
            s = jgl.lane_append_point(s, xs, u_app, resid)
            return x_next, s

        s = jgl.lane_shrink_to_bucket(jgl.lane_stack_ssm(jfit, lanes),
                                      n_free=steps)
        xs, ms, jfeas = jnp.asarray(x0.numpy()), jexp["init_state_batch"](
            lanes), []
        for t in range(steps):
            u, ms, info = get_action(ms, s, xs)
            xs, s = plant_and_append(s, xs, u, jnp.asarray(noise[t].numpy()))
            jfeas.append(np.asarray(info["feasible"], np.float64).mean())
        jbad = _lane_models_bad(s.gp.beta, s.gp.kinv)
        jfit_np = jax_gpssm_to_numpy(jfit)
    t_jax = time.perf_counter() - t0

    def port_episode(m):
        view = tgl.lane_shrink_to_bucket(tgl.lane_stack_ssm(m, lanes),
                                         n_free=steps)
        traj, fin = tbatch.run_batched_episodes_lanes(
            texp["env"], texp["get_action_batch"], texp["init_state_batch"],
            view, x0, steps, texp["a"], texp["b"], step_noise=noise)
        return (_lane_models_bad(fin.gp.beta.numpy(), fin.gp.kinv.numpy()),
                traj["feasible"].double().mean(dim=0).numpy())

    t0 = time.perf_counter()
    pbad, pfeas = port_episode(gpssm_from_numpy(
        jfit_np, ("rbf",) * tspec.n_s, device="cpu", dtype=torch.float32))
    t_port = time.perf_counter() - t0
    own = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(texp["make_ssm"](*seed0), iters=cfg.hyp_iters),
        tspec, n_region=128 * 8, draws=(d["region_x"], d["region_u"]))
    obad, ofeas = port_episode(own)
    print(f"quadrotor fleet, 8 f32 steps on JAX's first model (JAX {t_jax:.1f}"
          f" s, port {t_port:.1f} s): lanes diverged JAX {int(jbad.sum())}, "
          f"port {int(pbad.sum())}; feasible share per step JAX "
          f"{np.round(jfeas, 3).tolist()}, port {np.round(pfeas, 3).tolist()}"
          f"; the port on its own first model: diverged {int(obad.sum())}, "
          f"feasible {np.round(ofeas, 3).tolist()}")
    assert abs(int(pbad.sum()) - int(jbad.sum())) <= 4
    assert np.max(np.abs(pfeas - np.asarray(jfeas))) <= 0.1


# chip_smoke ``[risk]``'s instances: cartpole_risk_sqp's first model (40
# initial points from a CPU generator seeded 0), x0 = RISK_X0, a 4 x 3 + 3
# NLP budget; the relative changes of x0 with which a fixed-budget solve's
# own spread is read
RISK_X0 = np.asarray([0.02, 0.05, 0.01, 0.02])
RISK_BUDGET = ["sqp_outer=4", "sqp_inner=3"]
RISK_EPS = (1e-13, -1e-13, 3e-13, -3e-13, 1e-12, -1e-12)


@pytest.fixture(scope="module")
def risk_models():
    """The first model each package fits to the same 40 points, f64: the
    port's (bucketed, and as numpy arrays) and the JAX package's."""
    from safe_exploration_tpu.models.ssm import ssm_bucketed as jax_bucketed
    from safe_exploration_tpu_torch.models.convert import gpssm_to_numpy

    cfg = _apply_overrides(CONFIGS["cartpole_risk_sqp"], RISK_BUDGET)
    texp = build_experiment(cfg, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    data = tep.collect_initial_data(texp["env"], cfg.n_init_samples,
                                    texp["a"], texp["b"], texp["k_fb"],
                                    generator=gen)
    tm = tssm_mod.ssm_bucketed(tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(texp["make_ssm"](*data), iters=cfg.hyp_iters),
        texp["env"].spec, gen))
    jexp = jax_build(JAX_CONFIGS["cartpole_risk_sqp"], dtype=F64)
    jm = jax_bucketed(_jax_first_fit(cfg, jexp, jax.random.PRNGKey(0),
                                     [v.numpy() for v in data]))
    return tm, gpssm_to_numpy(tm), jm


def _risk_nlp_solvers(risk_models, sets, dtype=torch.float64):
    """Each package's NLP planner of cartpole_risk_sqp at the 4 x 3 + 3
    budget and ``sets``, on its first model, as x -> (k_ff, feasible,
    violation, max multiplier) in numpy; f32 casts the f64 model."""
    tm, arrays, jm = risk_models
    cfg = _apply_overrides(CONFIGS["cartpole_risk_sqp"], RISK_BUDGET + sets)
    warm = np.zeros((cfg.n_safe + cfg.n_perf - cfg.r_shared, 1))
    texp = build_experiment(cfg, dtype=dtype, device="cpu")
    if dtype == torch.float32:
        tm = gpssm_from_numpy(arrays, texp["kern_types"], device="cpu",
                              dtype=dtype)
    jdt = F64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(jdt == F64):
        jexp = jax_build(dataclasses.replace(
            JAX_CONFIGS["cartpole_risk_sqp"], **dataclasses.asdict(cfg)),
            dtype=jdt)
        plan = jax.jit(jexp["planner"])
        jm = jax.tree_util.tree_map(
            lambda v: jnp.asarray(np.asarray(v), jdt) if np.issubdtype(
                np.asarray(v).dtype, np.floating) else v, jm)

    def jax_solve(x):
        with jax.enable_x64(jdt == F64):
            k, f, v, info = plan(jax.random.PRNGKey(0), jm,
                                 jnp.asarray(x, jdt), jnp.asarray(warm, jdt))
            return (np.asarray(k, np.float64), bool(f), float(v),
                    float(jnp.max(info["lam"])))

    def port_solve(x):
        k, f, v, info = texp["planner"](None, tm, _t(x, dtype),
                                        _t(warm, dtype))
        return (k.double().numpy(), bool(f), float(v),
                float(info["lam"].max()))

    return {"jax": jax_solve, "port": port_solve}


@pytest.mark.slow
def test_cartpole_risk_nlp_spread_matches_jax(risk_models):
    """chip_smoke ``[risk]``'s NLP instance (cartpole_risk_sqp cut to
    n_safe 5, the 4 x 3 + 3 budget), f64: each package's solve from x0
    (1 + eps), eps in RISK_EPS, moves k_ff by more than 1e-9 relative (so
    1e-9 between packages is not a property of this solve), and the port's
    largest move is within 4x the JAX package's (measured: 5.0e-5 against
    4.8e-5). Prints both spreads."""
    spreads = {}
    for name, solve in _risk_nlp_solvers(risk_models, ["n_safe=5"]).items():
        k0 = solve(RISK_X0)[0]
        spreads[name] = max(_rel(solve(RISK_X0 * (1.0 + eps))[0], k0)
                            for eps in RISK_EPS)
    print(f"risk NLP spread of k_ff over x0 (1 + eps), eps {RISK_EPS}: "
          f"{spreads}")
    assert spreads["jax"] > 1e-9 and spreads["port"] > 1e-9
    assert spreads["port"] <= 4.0 * spreads["jax"]


@pytest.mark.slow
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_cartpole_risk_nlp_registered_horizon_diverges_as_jax(risk_models,
                                                              dtype):
    """The same instance at cartpole_risk_sqp's registered 10 safety stages
    (the horizon chip_smoke cuts to 5): the JAX package's solve diverges as
    the port's does. f64: both infeasible, violation > 1e15 and
    multipliers > 1e18 (measured 5.8e18 / 6.2e20 JAX, 4.0e18 / 4.2e20
    port). f32 (the f64 model cast): both infeasible with a violation that
    is > 1e15 or not finite (measured 3.3e18 JAX, NaN port)."""
    out = {name: solve(RISK_X0) for name, solve in _risk_nlp_solvers(
        risk_models, ["n_safe=10"], dtype).items()}
    print(f"risk NLP at n_safe 10, {dtype}: (feasible, violation, max lam) "
          f"{ {k: v[1:] for k, v in out.items()} }")
    for name, (_, feasible, viol, lam) in out.items():
        assert not feasible, name
        assert not viol <= 1e15, (name, viol)
        if dtype == torch.float64:
            assert lam > 1e18, (name, lam)


@pytest.mark.slow
def test_cartpole_risk_lane_sqp_spread(risk_models):
    """chip_smoke ``[risk]``'s lane-SQP parity lanes (cartpole_batch_sqp's
    solver under risk_tracking, w_sigma 5, on the first model; the first 4
    of 128 initial states uniform over 0.3 of the safe box, numpy seed
    11), f64 on the CPU: the solve from x0 (1 + eps), eps in RISK_EPS,
    moves k_ff by more than 1e-9 relative (measured 5.8e-8), so 1e-9
    between devices is not a property of this solve, and by at most the
    1e-7 at which chip_smoke holds the card's f64 solve to the CPU's.
    Prints the spread."""
    tm = risk_models[0]
    cfg = _apply_overrides(CONFIGS["cartpole_batch_sqp"],
                           ["objective=risk_tracking", "w_sigma=5.0"])
    texp = build_experiment(cfg, dtype=torch.float64, device="cpu")
    spec = texp["env"].spec
    hi = spec.h_safe[:spec.n_s].numpy()
    x0s = _t(np.random.default_rng(11).uniform(
        -1.0, 1.0, (cfg.batch_lanes, spec.n_s))[:4] * 0.3 * hi)
    warm = torch.zeros((4, cfg.n_safe + cfg.n_perf - cfg.r_shared, 1),
                       dtype=torch.float64)
    k0 = texp["batch_planner"](tm, x0s, warm)[0].numpy()
    spread = max(_rel(texp["batch_planner"](tm, x0s * (1.0 + eps), warm)[0]
                      .numpy(), k0) for eps in RISK_EPS)
    print(f"risk lane SQP spread of k_ff over x0 (1 + eps), eps {RISK_EPS}: "
          f"{spread:.3e}")
    assert 1e-9 < spread <= 1e-7

"""PyTorch port: BASELINE config 5, the planar quadrotor (n_s = 6, n_u = 2, a
GP of e = 6 outputs over d = 8 inputs, n_safe 3 + n_perf 5), against the
JAX package on the CPU in f64.

The JAX-fitted cfg5 golden state (tools/regen_goldens.build_problem
("quadrotor", 3, 5, n_data=32): 32 points, n_max 32, the fit and the
Lipschitz estimate) is built once for the module and carried across as
numpy arrays; each JAX program is compiled once with the fast options of
test_torch_bridge.jit_once:

  * the env: ``a``, ``b`` and the 6 x 6 DARE's ``k_fb`` at 1e-10, the
    dynamics at 1e-12 (the thrust enters through sin / cos of phi);
  * the cfg5 golden: posterior and tube at 1e-4 relative, margins 1e-3
    absolute (f64; f32 at 2e-3 with the goldens' Q floor), the port's NLP
    and lane SQP feasible with cost within 1e-3 of the golden's;
  * the lane tube with the perf trajectory's covariance recursion
    (``want_sigma``) at n_s 6, both methods, and the lane risk cost
    against the JAX package's (1e-9 / 1e-10);
  * the lane CEM at n_s 6 with a perf trajectory on the JAX draws (flags
    equal, plans and costs at 1e-8);
  * the refit at e 6, d 8, n_max 96, single and lane-stacked (1e-10);
  * ``runtime.main --config quadrotor_batch_sqp --device cpu`` at a tiny
    size, and ``quadrotor_episode`` on both CEM backends.

The JAX lane SQP's compile at n_s 6 (the JAX package's own quadrotor fleet
test takes minutes) is left to the ``slow`` tests of
tests/test_torch_slow_episodes.py.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models.gp import gp_predict_batch  # noqa: E402
from safe_exploration_tpu.solvers import sqp_lanes as jl  # noqa: E402
from safe_exploration_tpu.solvers.cem import CemConfig as JaxCemConfig  # noqa: E402
from safe_exploration_tpu.solvers.cem_lanes import (  # noqa: E402
    cem_plan_lanes as jax_cem_plan_lanes,
)
from safe_exploration_tpu.solvers.sqp import SqpConfig as JaxSqpConfig  # noqa: E402
from safe_exploration_tpu_torch.envs import make_quadrotor  # noqa: E402
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import gp_lanes as tgl  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.reachability import onestep as tos  # noqa: E402
from safe_exploration_tpu_torch.reachability import safety as tsafe  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import main  # noqa: E402
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem import CemConfig  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem_lanes import cem_plan_lanes  # noqa: E402
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
KT = ("rbf",) * 6
N_S, N_U = 6, 2
T_LEN, N_PERF, R = 3, 5, 1
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "goldens", "cfg5_quadrotor_h3p5.npz")

# the JAX CLI's batch-task summary keys for n_ep > 1 (runtime/main.py:176-
# 183 over runtime/batch.py::run_batched_learning's series)
BATCH_KEYS = {"wall_time_s", "metrics", "series"}
BATCH_SERIES = {"violations", "feasibility_rate", "model_error", "mean_cost",
                "episode_time_s", "n_data", "lane_backend", "lanes",
                "steps_per_sec"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def quad():
    """The JAX-fitted cfg5 golden state, its experiment, probes and x0, with
    the port's experiment and model."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        from regen_goldens import build_problem
    finally:
        sys.path.pop(0)
    jexp, jssm, probes, x0, _ = build_problem("quadrotor", T_LEN, N_PERF,
                                              n_data=32)
    arrays = jax_gpssm_to_numpy(jssm)
    texp = build_experiment(dataclasses.replace(
        ExperimentConfig(), **dataclasses.asdict(jexp["cfg"])),
        dtype=torch.float64, device="cpu")
    return dict(jexp=jexp, texp=texp, jssm=jssm, arrays=arrays,
                tssm=gpssm_from_numpy(arrays, KT, device="cpu"),
                probes=np.asarray(probes), x0=np.asarray(x0))


def _consts(jexp):
    k_fb = np.asarray(jexp["k_fb"])
    s_lift = np.concatenate([np.eye(N_S), k_fb], axis=0)
    return k_fb, np.asarray(jexp["a"]), np.asarray(jexp["b"]), \
        s_lift.T @ s_lift


def _polys(spec):
    return [np.asarray(v) for v in (spec.h_mat_obs, spec.h_obs,
                                    spec.h_mat_safe, spec.h_safe)]


# ------------------------------------------------------------------ the env


def test_quadrotor_env_matches_jax(quad):
    """a, b (the ZOH of the Jacobian at hover) and the LQR gain from the
    6 x 6 DARE at 1e-10; the dynamics at random states and thrusts at
    1e-12; the boxes (12 rows each), norm_x = hi_o and the spec equal."""
    jexp, texp = quad["jexp"], quad["texp"]
    assert texp["a"].shape == (6, 6) and texp["k_fb"].shape == (2, 6)
    for k in ("a", "b", "k_fb"):
        assert _rel(texp[k].numpy(), jexp[k]) < 1e-10, k
    jspec, tspec = jexp["env"].spec, texp["env"].spec
    for f in ("h_mat_safe", "h_safe", "h_mat_obs", "h_obs", "norm_x",
              "norm_u", "u_min", "u_max", "init_std", "plant_noise",
              "init_m", "target", "dt"):
        np.testing.assert_array_equal(getattr(tspec, f).numpy(),
                                      np.asarray(getattr(jspec, f)), f)
    assert tspec.h_mat_obs.shape == (12, 6) and tspec.h_safe.shape == (12,)
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.8, 0.8, (7, 6))
    u = rng.uniform(-1.5, 1.5, (7, 2))
    jd = jax.vmap(jexp["env"].dynamics)(jnp.asarray(x), jnp.asarray(u))
    td = make_quadrotor(dtype=torch.float64, device="cpu").dynamics(_t(x),
                                                                    _t(u))
    assert _rel(td.numpy(), jd) < 1e-12


# ---------------------------------------------------------- the cfg5 golden


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cfg5_golden_posterior_and_tube(quad, dtype):
    """The cfg5 golden on the JAX-fitted state: posterior mean and variance
    at the probes (the variance normalized by the prior kzz), the tube
    (p_traj, q_traj, var_traj) at the golden plan at 1e-4 relative and its
    margins at 1e-3 absolute (tests/test_goldens.py); in f32 2e-3 (the
    goldens' f32 gate as tests/test_goldens.py's docstring states it; its
    code runs 5e-2), with its small-tube floor on Q; the lane array-form
    tube's margins at the same plan."""
    g = np.load(GOLDEN)
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float64" else 2e-3
    tssm = gpssm_from_numpy(quad["arrays"], KT, device="cpu", dtype=tdt)
    np.testing.assert_allclose(quad["probes"], g["probes"], rtol=0,
                               atol=1e-6)
    mean, var = tgp.gp_predict(tssm.gp, _t(quad["probes"], tdt))
    assert _rel(mean.numpy(), g["posterior_mean"]) < tol
    kzz = max(float(np.exp(2.0 * p["log_sf"]))
              for p in quad["arrays"]["params"])
    assert np.max(np.abs(var.numpy() - g["posterior_var"])) / kzz < tol
    k_fb, a, b, bmat = (_t(v, tdt) for v in _consts(quad["jexp"]))
    k_ff = _t(g["k_ff_eval"], tdt)
    p, q, v = tos.multistep_reachability(
        tssm, _t(quad["x0"], tdt), k_ff, k_fb.expand(T_LEN, N_U, N_S), a, b,
        2.5)
    spec = quad["jexp"]["env"].spec
    assert _rel(p.numpy(), g["p_traj"]) < tol
    err_q = np.max(np.abs(q.numpy() - g["q_traj"]))
    q_floor = 2e-4 * float(np.max(np.abs(np.asarray(spec.h_safe))))
    assert err_q / np.max(np.abs(g["q_traj"])) < tol or (
        dtype == "float32" and err_q < q_floor), err_q
    polys = [_t(h, tdt) for h in _polys(spec)]
    d_stage = tsafe.lin_ellipsoid_safety_distance(p, q, *polys[:2])
    d_term = tsafe.lin_ellipsoid_safety_distance(p[-1], q[-1], *polys[2:])
    assert np.max(np.abs(d_stage.numpy() - g["d_stage"])) < 10 * tol
    assert np.max(np.abs(d_term.numpy() - g["d_term"])) < 10 * tol
    if dtype == "float64":
        assert _rel(v.numpy(), g["var_traj"]) < tol
        y = tl._rollout_lanes_array(
            tssm, k_ff.reshape(T_LEN * N_U, 1), _t(quad["x0"][:, None]),
            k_fb, a, b, SqpConfig(n_safe=T_LEN, c_safety=2.5), bmat)
        d = tl._dist_lanes(y, T_LEN, N_S, *polys)[:, 0].numpy()
        ref = np.concatenate([g["d_stage"].reshape(-1), g["d_term"]])
        assert np.max(np.abs(d - ref)) < 10 * tol


@pytest.mark.parametrize("solver", ["nlp", "lanes"])
def test_cfg5_golden_solvers_feasible_at_its_cost(quad, solver):
    """The port's single-instance NLP (``planner``) and lane SQP
    (``batch_planner``, one lane) at the golden's 8 x 4 budget from zeros
    (7 control rows: 3 safety stages, 4 free perf stages): feasible where
    the golden was, cost within 1e-3 relative of the golden's
    (tests/test_goldens.py:143-160)."""
    g = np.load(GOLDEN)
    texp, tssm = quad["texp"], quad["tssm"]
    warm = torch.zeros((T_LEN + N_PERF - R, N_U), dtype=torch.float64)
    if solver == "nlp":
        k_ff, feasible, violation, info = texp["planner"](
            None, tssm, _t(g["x0"]), warm)
        cost = float(info["cost"])
    else:
        k_ff, feasible, violation, info = texp["batch_planner"](
            tssm, _t(g["x0"])[None], warm[None])
        k_ff, feasible, violation = k_ff[0], feasible[0], violation[0]
        cost = float(info["cost"][0])
    assert bool(g["opt_feasible"])
    assert bool(feasible), float(violation)
    scale = abs(float(g["opt_cost"])) + 1e-9
    assert abs(cost - float(g["opt_cost"])) / scale < 1e-3, (
        cost, float(g["opt_cost"]))
    assert k_ff.shape == (T_LEN, N_U)


# ------------------------------------ the lane tube with the perf covariance


def _lane_case(quad, lanes=4, seed=3):
    k_fb, a, b, bmat = _consts(quad["jexp"])
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.05, 0.05, (N_S, lanes))
    u = 0.3 * rng.standard_normal(((T_LEN + N_PERF - R) * N_U, lanes))
    return x0, u, (k_fb, a, b), bmat


@pytest.fixture(scope="module")
def jax_rollout_sigma(quad):
    """The JAX lane rollout with the perf covariance, per perf method, run
    op by op (its scalar-list Sigma recursion at n_s 6 is thousands of
    tiny ops, which take far longer to compile than to run)."""
    x0, u, consts, bmat = _lane_case(quad)
    return {method: np.asarray(jl._rollout_y_lanes(
        quad["jssm"], jnp.asarray(u), [jnp.asarray(row) for row in x0],
        *(jnp.asarray(v) for v in consts),
        JaxSqpConfig(n_safe=T_LEN, n_perf=N_PERF, r_shared=R,
                     perf_method=method),
        jnp.asarray(bmat), R, N_U, want_sigma=True))
        for method in ("taylor", "mean_equivalent")}


@pytest.mark.parametrize("method", ["taylor", "mean_equivalent"])
def test_lane_rollout_with_sigma_matches_jax(quad, jax_rollout_sigma, method):
    """The packed lane rollout at n_s 6 with the perf trajectory's
    covariance (Sigma+ = H Sigma H^T + diag(var + noise) under taylor,
    Sigma + diag(var + noise) under mean_equivalent): tube, perf means,
    variances and Sigma at 1e-9; the lane risk cost on it at 1e-10; the
    two methods' Sigma differ."""
    x0, u, consts, bmat = _lane_case(quad)
    jy = jax_rollout_sigma[method]
    cfg = SqpConfig(n_safe=T_LEN, n_perf=N_PERF, r_shared=R,
                    perf_method=method)
    ty = tl._rollout_y_lanes(quad["tssm"], _t(u), _t(x0),
                             *(_t(v) for v in consts), cfg, _t(bmat), r=R,
                             want_sigma=True)
    n_tube = T_LEN * (2 * N_S + N_S * N_S)
    assert ty.shape == jy.shape == (n_tube + N_PERF * (2 * N_S + N_S * N_S),
                                    4)
    assert _rel(ty.numpy(), jy) < 1e-9
    other = jax_rollout_sigma[{"taylor": "mean_equivalent",
                               "mean_equivalent": "taylor"}[method]]
    assert np.max(np.abs(jy[n_tube + 2 * N_PERF * N_S:]
                         - other[n_tube + 2 * N_PERF * N_S:])) > 1e-9
    *_, (_, _, sig) = tl._unpack_y(ty, T_LEN, N_S, N_PERF, with_sigma=True)
    assert sig.shape == (N_PERF, N_S, N_S, 4)
    assert torch.allclose(sig, sig.transpose(1, 2), rtol=0, atol=1e-15)
    args = {"target": np.full(N_S, 0.01), "w_sigma": 5.0}
    jc = jl._cost_lanes("risk_tracking",
                        {k: jnp.asarray(v) for k, v in args.items()},
                        jnp.asarray(jy), jnp.asarray(u), T_LEN, N_S, N_U,
                        n_perf=N_PERF, r=R)
    tc = tl._cost_lanes("risk_tracking",
                        {"target": _t(args["target"]), "w_sigma": 5.0}, ty,
                        _t(u), T_LEN, N_S, N_U, n_perf=N_PERF, r=R)
    assert _rel(tc.numpy(), jc) < 1e-10


# ------------------------------------------------------------ the lane CEM


def _jax_draws(key, n_it, shape, dtype=F64):
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype))
                     for k in jax.random.split(key, n_it)])


@pytest.mark.parametrize("cost_kind", [
    "tracking", pytest.param("risk_tracking", marks=pytest.mark.slow)])
def test_cem_plan_lanes_at_six_states_with_perf_matches_jax(quad, cost_kind):
    """The lane CEM at n_s 6 with a 5-stage perf trajectory (r_shared 1)
    on the cfg5 model, 4 instances, some pushed past the boundary, fed the
    JAX solve's noise: flags equal and mixed, k_ff, violation and cost at
    1e-8. The risk cost (the lane covariance recursion inside the JAX
    solve's scan) costs ~100 s of JAX compile, so it is ``slow``; its
    rollout and cost are held in tier-1 by the Sigma test above."""
    jexp, jssm, tssm = quad["jexp"], quad["jssm"], quad["tssm"]
    spec = jexp["env"].spec
    k_fb, a, b, _ = _consts(jexp)
    args = (k_fb, a, b, np.asarray(spec.u_min), np.asarray(spec.u_max),
            *_polys(spec))
    rng = np.random.default_rng(11)
    x0s = rng.uniform(-0.05, 0.05, (4, N_S))
    x0s[0] = [0.7, 0.0, 0.0, 0.0, 0.4, 0.0]      # past the boundary
    warm = rng.uniform(-0.3, 0.3, (4, T_LEN + N_PERF - R, N_U))
    kw = dict(n_safe=T_LEN, n_samples=8, n_elites=3, n_iterations=2,
              n_perf=N_PERF, r_shared=R)
    target = np.zeros(N_S)
    jcost = {"target": jnp.asarray(target)}
    tcost = {"target": _t(target)}
    if cost_kind == "risk_tracking":
        jcost["w_sigma"] = tcost["w_sigma"] = 5.0
    key = jax.random.PRNGKey(5)

    def solve(x, w):
        return jax_cem_plan_lanes(key, jssm, x, *(jnp.asarray(v)
                                                 for v in args),
                                  1.5, cost_kind, jcost, JaxCemConfig(**kw),
                                  warm=w)

    ref = jit_once(solve, jnp.asarray(x0s), jnp.asarray(warm))(
        jnp.asarray(x0s), jnp.asarray(warm))
    n_var = (T_LEN + N_PERF - R) * N_U
    out = cem_plan_lanes(None, tssm, _t(x0s), *(_t(v) for v in args), 1.5,
                         cost_kind, tcost, CemConfig(**kw), warm=_t(warm),
                         noise=_t(_jax_draws(key, 2, (8, n_var, 4))))
    k, f, v, info = out
    jk, jf, jv, jinfo = ref
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(info["cost"].numpy(), np.asarray(jinfo["cost"]),
                               rtol=1e-8, atol=1e-12)
    assert info["warm_next"].shape == (4, T_LEN + N_PERF - R, N_U)


# -------------------------------------------------------------- the refit


def test_refit_at_six_outputs_eight_inputs_matches_jax():
    """``make_ssm``'s refit at the quadrotor fleet's shape (e 6, d 8,
    n_max 96, 64 points, log noise -4.5): chol, beta and K^-1 at 1e-10
    against the JAX package's; the lane-stacked refit (2 lanes, a leading
    lane axis in every launch, as the fleet runs it) equal to the single
    one; the posterior at 1e-10."""
    cfg = ExperimentConfig(env="quadrotor", kern_types=("rbf",),
                           solver="sqp", n_max=96, log_noise=-4.5)
    from safe_exploration_tpu.runtime.config import (
        ExperimentConfig as JaxConfig,
        build_experiment as jax_build,
    )

    jexp = jax_build(JaxConfig(**dataclasses.asdict(cfg)), dtype=F64)
    texp = build_experiment(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    xs = rng.uniform(-1.0, 1.0, (64, N_S)) * 0.3 * np.asarray(
        jexp["env"].spec.norm_x)
    us = rng.uniform(-0.5, 0.5, (64, N_U))
    resid = 0.01 * np.sin(3.0 * xs) + 0.002 * us.sum(-1, keepdims=True)
    jssm = jexp["make_ssm"](jax.random.PRNGKey(0), *(jnp.asarray(v)
                                                      for v in (xs, us,
                                                                resid)))
    tssm = texp["make_ssm"](_t(xs), _t(us), _t(resid))
    assert tssm.gp.x.shape == (96, 8) and tssm.gp.kinv.shape == (6, 96, 96)
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(tssm.gp, f).numpy(), getattr(jssm.gp, f)) < 1e-10
    stacked = tgl.lane_unstack_ssm(tgl.lane_stack_ssm(tssm, 2)).gp
    for f in ("chol", "beta", "kinv"):
        for lane in range(2):
            assert _rel(getattr(stacked, f)[lane].numpy(),
                        getattr(jssm.gp, f)) < 1e-10
    z = rng.uniform(-0.5, 0.5, (5, 8))
    jm, jv = gp_predict_batch(jssm.gp, jnp.asarray(z))
    tm, tv = tgp.gp_predict(tssm.gp, _t(z))
    assert _rel(tm.numpy(), jm) < 1e-10 and _rel(tv.numpy(), jv) < 1e-10


# ----------------------------------------------------------------- the CLI


def test_quadrotor_cli_on_cpu_prints_jax_keys(capsys):
    """The quadrotor fleet through the CLI on the CPU at a tiny size: the
    JAX CLI's batch keys, 0 violations, finite model errors; then
    quadrotor_episode for 2 steps on each CEM backend (the lane CEM at
    n_s 6 with its 12-stage perf trajectory), 0 violations."""
    rc = main(["--config", "quadrotor_batch_sqp", "--device", "cpu", "--set",
               "batch_lanes=2", "n_steps=1", "n_ep=2", "n_max=16",
               "n_init_samples=8", "hyp_iters=1", "sqp_outer=1",
               "sqp_inner=1"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == BATCH_KEYS
    assert set(summary["series"]) == BATCH_SERIES
    assert summary["series"]["violations"] == [0, 0]
    assert summary["series"]["lane_backend"] == [1, 1]
    for backend in ("portable", "lanes"):
        rc = main(["--config", "quadrotor_episode", "--device", "cpu",
                   "--set", "n_ep=1", "n_steps=2", "n_max=16",
                   "n_init_samples=8", "hyp_iters=2", "cem_samples=8",
                   "cem_elites=2", "cem_iterations=1",
                   f"cem_backend={backend}"])
        assert rc == 0
        series = json.loads(capsys.readouterr().out)["series"]
        assert series["violations"] == [0] and series["n_data"] == [8]
        assert np.isfinite(series["model_error"]).all()

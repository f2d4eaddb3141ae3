"""PyTorch port: the lane-major SQP and everything else that runs on the
JAX-fitted golden state, against the JAX package, f64 on the CPU.

The state is built once for the module (tools/regen_goldens.build_problem,
as tests/test_goldens.py does: its hyperparameter fit dominates the run
time) and carried across as numpy arrays:

  * the lane GP posterior and the tube rollout (p, q, var) at 1e-9;
  * the cfg3 golden batch block: ``batch_feasible`` exact, ``batch_k_ff``
    at 1e-4, ``batch_cost`` at 1e-3 (the gates of tests/test_goldens.py);
  * the numpy bridge round trip and the cfg1 golden's posterior, held at
    1e-4 (variance normalized by the prior kzz), and the port's own refit of
    the carried data against JAX's factors at 1e-9;
  * the port's ``multistep_reachability`` and the lane scorer's margins on
    the cfg1 golden's plan, at the goldens' gates: 1e-4 relative on the
    tube, 1e-4 absolute on the margins;
  * ``solve_safempc_lanes`` against the JAX lane solve on the same inputs
    at H=5, B=8 with a small budget, feasible and infeasible lanes, for the
    tracking and the exploration objective: feasible flags exact, k_ff at
    1e-4.

The JAX solves are compiled once per objective; the port runs eagerly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.runtime.config import (  # noqa: E402
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.solvers import sqp_lanes as jl  # noqa: E402
from safe_exploration_tpu.solvers.sqp import (  # noqa: E402
    SqpConfig as JaxSqpConfig,
    _solve_spd_unrolled as jax_solve_spd,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    gpssm_from_numpy,
    gpssm_to_numpy,
)
from safe_exploration_tpu_torch.ops.kernels import tube_score_plain  # noqa: E402
from safe_exploration_tpu_torch.reachability import onestep as tos  # noqa: E402
from safe_exploration_tpu_torch.reachability import safety as tsafe  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem import tube_violation  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem_lanes import _TubeCfg  # noqa: E402
from safe_exploration_tpu_torch.solvers.sqp import (  # noqa: E402
    SqpConfig,
    _solve_spd_unrolled,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(_REPO, "tests", "goldens")
GOLDEN = os.path.join(GOLDEN_DIR, "cfg1_pendulum_h5.npz")
KT = ("rbf", "rbf")
SMALL = dict(sqp_outer=2, sqp_inner=1, sqp_polish=0, sqp_rescue=0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def golden_state():
    """The JAX-fitted golden state (cfg1 and cfg3 share it: the horizon
    changes only the experiment) with cfg1's experiment, probes and x0, on
    both sides."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        from regen_goldens import build_problem
    finally:
        sys.path.pop(0)
    exp, jssm, probes, x0, _ = build_problem("pendulum", 5, 0)
    arrays = jax_gpssm_to_numpy(jssm)
    return dict(exp=exp, jssm=jssm, arrays=arrays, probes=np.asarray(probes),
                x0=np.asarray(x0),
                tssm=gpssm_from_numpy(arrays, KT, device="cpu"))


@pytest.fixture(scope="module")
def fitted(golden_state):
    return golden_state["jssm"], golden_state["tssm"]


@pytest.fixture(scope="module")
def cfg1_state(golden_state):
    g = golden_state
    return g["arrays"], g["probes"], g["jssm"]


@pytest.fixture(scope="module")
def cfg1(golden_state):
    """The JAX-fitted cfg1 state (both sides) and its golden."""
    g = golden_state
    return g["exp"], g["jssm"], g["tssm"], g["x0"], np.load(GOLDEN)


def _lane_inputs(b=8, h=5, seed=0):
    rng = np.random.default_rng(seed)
    x0s = rng.uniform(-1.0, 1.0, (b, 2)) * [0.15, 0.4]
    u = 0.05 * rng.standard_normal((h, b))
    return x0s, u


@pytest.mark.parametrize("want_jac", [False, True])
def test_gp_predict_lanes_matches_jax(fitted, want_jac):
    jssm, tssm = fitted
    z = np.random.default_rng(1).uniform(-0.5, 0.5, (3, 8))
    jout = jl._gp_predict_lanes(jssm, jnp.asarray(z), want_jac=want_jac)
    tout = tl._gp_predict_lanes(tssm, _t(z), want_jac=want_jac)
    for j, t in zip(jout, tout):
        assert _rel(t.numpy(), j) < 1e-9


def test_rollout_lanes_tube_matches_jax(fitted):
    jssm, tssm = fitted
    jexp = jax_build(JaxConfig(solver="sqp"), dtype=jnp.float64)
    texp = build_experiment(ExperimentConfig(solver="sqp"), dtype=torch.float64,
                            device="cpu")
    x0s, u = _lane_inputs()
    k_fb, n_s = np.asarray(jexp["k_fb"]), 2
    s_lift = np.concatenate([np.eye(n_s), k_fb], axis=0)
    bmat = s_lift.T @ s_lift
    cfg_j, cfg_t = JaxSqpConfig(n_safe=5), SqpConfig(n_safe=5)
    jout = jl._rollout_lanes(
        jssm, jnp.asarray(u), [jnp.asarray(r) for r in x0s.T],
        jexp["k_fb"], jexp["a"], jexp["b"], cfg_j, jnp.asarray(bmat))
    ty = tl._rollout_y_lanes(tssm, _t(u), _t(x0s.T), texp["k_fb"],
                             texp["a"], texp["b"], cfg_t, _t(bmat))
    jy = jl._pack_y(*jout)
    assert ty.shape == jy.shape == (5 * (2 + 4 + 2), 8)
    for block, rows in (("p", slice(0, 10)), ("q", slice(10, 30)),
                        ("var", slice(30, 40))):
        assert _rel(ty[rows].numpy(), jy[rows]) < 1e-9, block
    jd = jl._dist_lanes(jy, 5, 2, jexp["env"].spec.h_mat_obs,
                        jexp["env"].spec.h_obs, jexp["env"].spec.h_mat_safe,
                        jexp["env"].spec.h_safe)
    spec = texp["env"].spec
    td = tl._dist_lanes(ty, 5, 2, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe,
                        spec.h_safe)
    assert _rel(td.numpy(), jd) < 1e-9


@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_eig_lanes_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((6, n, n))
    m = np.einsum("bij,bkj->ikb", a, a)          # PSD lane matrices
    jm = [[jnp.asarray(m[i, j]) for j in range(n)] for i in range(n)]
    assert _rel(tl._max_eig_lanes_array(_t(m)).numpy(),
                jl._max_eig_lanes(jm)) < 1e-9


def test_solve_spd_unrolled_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((5, 5, 7))
    h = np.einsum("ikb,jkb->ijb", a, a) + 5.0 * np.eye(5)[:, :, None]
    rhs = rng.standard_normal((5, 7))
    d = _solve_spd_unrolled(_t(h), _t(rhs)).numpy()
    assert _rel(d, jax_solve_spd(jnp.asarray(h), jnp.asarray(rhs))) < 1e-9


def test_cfg3_golden_batch_block(fitted):
    """The port's batched lane solve on the JAX-fitted cfg3 state reproduces
    the frozen golden plans (the gates of tests/test_goldens.py)."""
    _, tssm = fitted
    g = np.load(os.path.join(GOLDEN_DIR, "cfg3_pendulum_batch_h3.npz"))
    # tools/regen_goldens.build_problem's configuration for cfg3
    cfg = ExperimentConfig(name="golden_pendulum", solver="sqp", n_safe=3,
                           n_max=32, sqp_outer=8, sqp_inner=4,
                           kern_types=("rbf",), c_safety=2.0)
    exp = build_experiment(cfg, dtype=torch.float64, device="cpu")
    x0s = _t(g["batch_x0s"])
    warm = torch.zeros((x0s.shape[0], 3, 1), dtype=torch.float64)
    kb, feas, _, info = exp["batch_planner"](tssm, x0s, warm)
    np.testing.assert_array_equal(feas.numpy(), g["batch_feasible"])
    scale = np.max(np.abs(g["batch_k_ff"])) + 1e-12
    assert np.max(np.abs(kb.numpy() - g["batch_k_ff"])) / scale < 1e-4
    scale_c = np.max(np.abs(g["batch_cost"])) + 1e-9
    assert np.max(np.abs(info["cost"].numpy() - g["batch_cost"])) / scale_c \
        < 1e-3


@pytest.mark.parametrize("objective", ["tracking", "exploration"])
def test_solve_safempc_lanes_matches_jax_lane_solve(fitted, objective):
    jssm, tssm = fitted
    kw = dict(solver="sqp", n_safe=5, n_max=32, objective=objective, **SMALL)
    jexp = jax_build(JaxConfig(**kw), dtype=jnp.float64)
    texp = build_experiment(ExperimentConfig(**kw), dtype=torch.float64,
                            device="cpu")
    x0s, _ = _lane_inputs(seed=3)
    x0s[::3] *= 6.0          # push some lanes past the constraint boundary
    warm = np.zeros((8, 5, 1))
    lam = np.abs(np.random.default_rng(4).normal(0.0, 0.1, (8, 24)))
    args = (jssm, jnp.asarray(x0s), jnp.asarray(warm), jnp.asarray(lam))
    jk, jf, jv, ji = jit_once(jexp["batch_planner"], *args)(*args)
    tk, tf, tv, ti = texp["batch_planner"](tssm, _t(x0s), _t(warm), _t(lam))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    assert _rel(tk.numpy(), jk) < 1e-4
    assert _rel(ti["cost"].numpy(), ji["cost"]) < 1e-3
    assert _rel(ti["p_traj"].numpy(), ji["p_traj"]) < 1e-4
    assert _rel(ti["lam"].numpy(), ji["lam"]) < 1e-4
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-9)


def test_lanes_supported_covers_the_ported_slice(fitted):
    """The lane SQP covers performance trajectories (either perf method),
    the risk objective (its perf covariance recursion, want_sigma) and
    the cart-pole and the quadrotor build, and so do sparse models; the
    MC-dropout models and the batched fallback to the portable NLP raise
    naming their ROADMAP items."""
    _, tssm = fitted
    for kind in ("tracking", "exploration", "risk_tracking"):
        assert tl.lanes_supported(tssm, SqpConfig(), kind)
    for method in ("taylor", "mean_equivalent"):
        assert tl.lanes_supported(
            tssm, SqpConfig(n_perf=3, perf_method=method), "risk_tracking")
    assert not tl.lanes_supported(tssm, SqpConfig(), "unknown")
    assert not tl.lanes_supported(tssm, SqpConfig(opt_k_fb=True), "tracking")
    for kw in (dict(env="cartpole", kern_types=("rbf",)), dict(n_perf=3),
               dict(env="cartpole", kern_types=("rbf",), n_perf=3,
                    r_shared=2),
               dict(env="quadrotor", kern_types=("rbf",), n_perf=3),
               dict(objective="risk_tracking", n_perf=3)):
        for solver in ("cem", "sqp"):
            exp = build_experiment(ExperimentConfig(solver=solver, **kw),
                                   device="cpu")
            assert exp["kern_types"] == ("rbf",) * exp["env"].spec.n_s
    for solver in ("cem", "sqp"):
        assert build_experiment(ExperimentConfig(solver=solver,
                                                 ssm="sparse_gp"),
                                device="cpu")["cfg"].ssm == "sparse_gp"
    with pytest.raises(NotImplementedError, match="item 12"):
        build_experiment(ExperimentConfig(solver="cem", ssm="mc_dropout"),
                         device="cpu")
    exp = build_experiment(ExperimentConfig(solver="sqp"), device="cpu")
    ff = tssm.replace(gp=tssm.gp.replace(precision="ff"))
    assert not tl.lanes_supported(ff, SqpConfig(), "tracking")
    with pytest.raises(NotImplementedError, match="item 7"):
        exp["batch_planner"](ff, None, None)


def test_numpy_bridge_round_trip(cfg1_state):
    arrays, _, _ = cfg1_state
    back = gpssm_to_numpy(gpssm_from_numpy(arrays, KT, device="cpu"))
    for k, v in arrays.items():
        if k == "params":
            for pa, pb in zip(v, back[k]):
                for name in pa:
                    np.testing.assert_array_equal(pa[name], pb[name])
        elif v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(np.asarray(v), back[k])


def test_cfg1_golden_posterior_on_the_jax_fitted_state(cfg1_state):
    arrays, probes, jax_ssm = cfg1_state
    path = os.path.join(GOLDEN_DIR, "cfg1_pendulum_h5.npz")
    g = np.load(path)
    np.testing.assert_allclose(probes, g["probes"], rtol=0, atol=1e-6)
    ssm = gpssm_from_numpy(arrays, KT, device="cpu")
    mean, var = tgp.gp_predict(ssm.gp, _t(probes))
    scale_m = np.max(np.abs(g["posterior_mean"])) + 1e-12
    assert np.max(np.abs(mean.numpy() - g["posterior_mean"])) / scale_m < 1e-4
    kzz = max(float(np.exp(2.0 * p["log_sf"])) for p in arrays["params"])
    assert np.max(np.abs(var.numpy() - g["posterior_var"])) / kzz < 1e-4
    # and the port's own refit of the carried data reproduces JAX's factors
    refit = tgp.gp_refit(ssm.gp)
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(refit, f).numpy(), getattr(jax_ssm.gp, f)) < 1e-9


def test_multistep_reachability_matches_cfg1_golden(cfg1):
    exp, _, tssm, x0, g = cfg1
    k_fb = _t(exp["k_fb"])
    p, q, var = tos.multistep_reachability(
        tssm, _t(x0), _t(g["k_ff_eval"]), k_fb.expand(5, 1, 2), _t(exp["a"]),
        _t(exp["b"]), 2.5)
    assert _rel(p.numpy(), g["p_traj"]) < 1e-4
    assert _rel(q.numpy(), g["q_traj"]) < 1e-4
    assert _rel(var.numpy(), g["var_traj"]) < 1e-4
    spec = exp["env"].spec
    d_stage = tsafe.lin_ellipsoid_safety_distance(
        p, q, _t(spec.h_mat_obs), _t(spec.h_obs))
    d_term = tsafe.lin_ellipsoid_safety_distance(
        p[-1], q[-1], _t(spec.h_mat_safe), _t(spec.h_safe))
    assert np.max(np.abs(d_stage.numpy() - g["d_stage"])) < 1e-4
    assert np.max(np.abs(d_term.numpy() - g["d_term"])) < 1e-4
    viol = tube_violation(p, q, _t(spec.h_mat_obs), _t(spec.h_obs),
                          _t(spec.h_mat_safe), _t(spec.h_safe))
    ref = (np.maximum(g["d_stage"], 0.0).sum()
           + np.maximum(g["d_term"], 0.0).sum())
    assert abs(float(viol) - ref) < 1e-4


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lane_scorer_margins_match_cfg1_golden(cfg1, impl):
    """The lane tube (plain form, and the fused posterior's plain version)
    and the whole-tube scorer's plain version on the golden's state and
    plan: stage and terminal margins at 1e-4."""
    exp, _, tssm, x0, g = cfg1
    spec = exp["env"].spec
    k_fb, a, b = (np.asarray(exp[k]) for k in ("k_fb", "a", "b"))
    s_lift = np.concatenate([np.eye(2), k_fb], 0)
    bmat = s_lift.T @ s_lift
    u = _t(g["k_ff_eval"].reshape(5, 1))
    y = tl._rollout_y_lanes(tssm, u, _t(x0[:, None]), _t(k_fb), _t(a),
                            _t(b), _TubeCfg(5, 2.5, 0), _t(bmat), impl=impl)
    polys = [_t(v) for v in (spec.h_mat_obs, spec.h_obs, spec.h_mat_safe,
                             spec.h_safe)]
    d = tl._dist_lanes(y, 5, 2, *polys)[:, 0].numpy()
    ref = np.concatenate([g["d_stage"].reshape(-1), g["d_term"]])
    assert np.max(np.abs(d - ref)) < 1e-4
    _, viol = tube_score_plain(
        tssm, u, _t(x0[:, None]), *(_t(v) for v in (k_fb, a, b, bmat)),
        *(_t(v) for v in polys), 2.5, 5, "tracking",
        {"target": _t(spec.target)})
    assert abs(float(viol[0]) - np.maximum(ref, 0.0).sum()) < 1e-4

"""PyTorch port: the lane-major SQP and everything else that runs on the
JAX-fitted golden state, against the JAX package, f64 on the CPU.

The state is built once for the module (tools/regen_goldens.build_problem,
as tests/test_goldens.py does: its hyperparameter fit dominates the run
time) and carried across as numpy arrays:

  * the lane GP posterior and the tube rollout (p, q, var) at 1e-9;
  * the cfg3 golden batch block: ``batch_feasible`` exact, ``batch_k_ff``
    at 1e-4, ``batch_cost`` at 1e-3 (the gates of tests/test_goldens.py);
  * ``solve_safempc_lanes`` against the JAX lane solve on the same inputs
    at H=5, B=8 with a small budget, feasible and infeasible lanes, for the
    tracking and the exploration objective: feasible flags exact, k_ff at
    1e-4.

The cfg1 golden's checks on the same state are in
tests/test_torch_cfg1_golden.py (a file of its own, so that pytest-xdist,
which hands files out by their test counts, starts the long JAX files
first).

The JAX solves are compiled once per objective; the port runs eagerly.
"""

import os

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
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    golden_problem,
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.sqp import (  # noqa: E402
    SqpConfig,
    _solve_spd_unrolled,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(_REPO, "tests", "goldens")
KT = ("rbf", "rbf")
SMALL = dict(sqp_outer=2, sqp_inner=1, sqp_polish=0, sqp_rescue=0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def golden_state(golden_problem):
    """The JAX-fitted golden state (cfg1 and cfg3 share it: the horizon
    changes only the experiment) with cfg1's experiment, probes and x0, on
    both sides."""
    exp, jssm, probes, x0, _ = golden_problem("pendulum", 5, 0)
    arrays = jax_gpssm_to_numpy(jssm)
    return dict(exp=exp, jssm=jssm, arrays=arrays, probes=np.asarray(probes),
                x0=np.asarray(x0),
                tssm=gpssm_from_numpy(arrays, KT, device="cpu"))


@pytest.fixture(scope="module")
def fitted(golden_state):
    return golden_state["jssm"], golden_state["tssm"]


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
    for solver in ("cem", "sqp"):
        exp = build_experiment(ExperimentConfig(solver=solver,
                                                ssm="mc_dropout"),
                               device="cpu")
        assert set(exp["ssm_draw_shapes"]) == {"mc_w0", "mc_w1", "mc_w2",
                                               "mc_u0", "mc_u1"}
    exp = build_experiment(ExperimentConfig(solver="sqp"), device="cpu")
    ff = tssm.replace(gp=tssm.gp.replace(precision="ff"))
    assert not tl.lanes_supported(ff, SqpConfig(), "tracking")
    with pytest.raises(NotImplementedError, match="item 7"):
        exp["batch_planner"](ff, None, None)

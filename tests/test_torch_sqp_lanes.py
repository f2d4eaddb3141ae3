"""PyTorch port: the lane-major SQP against the JAX package, f64 on the CPU.

  * the lane GP posterior and the tube rollout (p, q, var) at 1e-9;
  * the cfg3 golden batch block on the JAX-fitted state carried across as
    numpy arrays: ``batch_feasible`` exact, ``batch_k_ff`` at 1e-4,
    ``batch_cost`` at 1e-3 (the gates of tests/test_goldens.py);
  * ``solve_safempc_lanes`` against the JAX lane solve on the same inputs at
    H=5, B=8 with a small budget, for the tracking and the exploration
    objective: feasible flags exact, k_ff at 1e-4.

The JAX solve is compiled once for the module (its compile dominates the
run time); the port runs eagerly.
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
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from test_torch_bridge import jax_gpssm_to_numpy, one_torch_thread  # noqa: E402,F401
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
def fitted():
    """The JAX-fitted golden state (cfg1/cfg3 share it) on both sides."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        from regen_goldens import build_problem
    finally:
        sys.path.pop(0)
    _, jssm, _, _, _ = build_problem("pendulum", 3, 0)
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), KT, device="cpu")
    return jssm, tssm


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
    tout = tl._rollout_lanes(
        tssm, _t(u), [_t(r) for r in x0s.T], texp["k_fb"], texp["a"],
        texp["b"], cfg_t, _t(bmat))
    jy, ty = jl._pack_y(*jout), tl._pack_y(*tout)
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
    tm = [[_t(m[i, j]) for j in range(n)] for i in range(n)]
    assert _rel(tl._max_eig_lanes(tm).numpy(), jl._max_eig_lanes(jm)) < 1e-9


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
    x0s[::3] *= 2.5          # push some lanes toward the constraint boundary
    warm = np.zeros((8, 5, 1))
    lam = np.abs(np.random.default_rng(4).normal(0.0, 0.1, (8, 24)))
    jk, jf, jv, ji = jax.jit(jexp["batch_planner"])(
        jssm, jnp.asarray(x0s), jnp.asarray(warm), jnp.asarray(lam))
    tk, tf, tv, ti = texp["batch_planner"](tssm, _t(x0s), _t(warm), _t(lam))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert _rel(tk.numpy(), jk) < 1e-4
    assert _rel(ti["cost"].numpy(), ji["cost"]) < 1e-3
    assert _rel(ti["p_traj"].numpy(), ji["p_traj"]) < 1e-4
    assert _rel(ti["lam"].numpy(), ji["lam"]) < 1e-4
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-9)


def test_lanes_supported_covers_the_ported_slice(fitted):
    _, tssm = fitted
    assert tl.lanes_supported(tssm, SqpConfig(), "tracking")
    assert tl.lanes_supported(tssm, SqpConfig(), "exploration")
    assert not tl.lanes_supported(tssm, SqpConfig(), "risk_tracking")
    assert not tl.lanes_supported(tssm, SqpConfig(n_perf=3), "tracking")
    assert not tl.lanes_supported(tssm, SqpConfig(opt_k_fb=True), "tracking")
    for kw in (dict(objective="risk_tracking"), dict(env="cartpole"),
               dict(ssm="sparse_gp"), dict(n_perf=3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_experiment(ExperimentConfig(solver="cem", **kw),
                             device="cpu")
    exp = build_experiment(ExperimentConfig(solver="sqp"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        exp["planner"](None, tssm, None, None)

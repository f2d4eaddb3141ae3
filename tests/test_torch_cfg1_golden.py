"""PyTorch port: the cfg1 golden (``tests/goldens/cfg1_pendulum_h5.npz``)
on the JAX-fitted golden state, f64 on the CPU:

  * the numpy bridge round trip and the cfg1 golden's posterior, held at
    1e-4 (variance normalized by the prior kzz), and the port's own refit of
    the carried data against JAX's factors at 1e-9;
  * the port's ``multistep_reachability`` and the lane scorer's margins on
    the cfg1 golden's plan, at the goldens' gates: 1e-4 relative on the
    tube, 1e-4 absolute on the margins.

The state is the session's shared golden state
(``test_torch_bridge.golden_problem``), as in tests/test_torch_sqp_lanes.py,
whose lane-SQP checks run on it too; this file holds the golden's checks
apart so that each file's test count, by which pytest-xdist hands files
out, places it well in the tier-1 run's schedule.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    gpssm_from_numpy,
    gpssm_to_numpy,
)
from safe_exploration_tpu_torch.ops.kernels import tube_score_plain  # noqa: E402
from safe_exploration_tpu_torch.reachability import onestep as tos  # noqa: E402
from safe_exploration_tpu_torch.reachability import safety as tsafe  # noqa: E402
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem import tube_violation  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem_lanes import _TubeCfg  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    golden_problem,
    jax_gpssm_to_numpy,
    one_torch_thread,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(_REPO, "tests", "goldens")
GOLDEN = os.path.join(GOLDEN_DIR, "cfg1_pendulum_h5.npz")
KT = ("rbf", "rbf")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def golden_state(golden_problem):
    """The JAX-fitted golden state with cfg1's experiment, probes and x0,
    on both sides."""
    exp, jssm, probes, x0, _ = golden_problem("pendulum", 5, 0)
    arrays = jax_gpssm_to_numpy(jssm)
    return dict(exp=exp, jssm=jssm, arrays=arrays, probes=np.asarray(probes),
                x0=np.asarray(x0),
                tssm=gpssm_from_numpy(arrays, KT, device="cpu"))


@pytest.fixture(scope="module")
def cfg1_state(golden_state):
    g = golden_state
    return g["arrays"], g["probes"], g["jssm"]


@pytest.fixture(scope="module")
def cfg1(golden_state):
    """The JAX-fitted cfg1 state (both sides) and its golden."""
    g = golden_state
    return g["exp"], g["jssm"], g["tssm"], g["x0"], np.load(GOLDEN)


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

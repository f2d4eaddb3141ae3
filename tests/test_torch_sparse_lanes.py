"""PyTorch port: BASELINE config 4's solvers on a sparse (inducing-point)
model against the JAX package, on the CPU, in f64.

The JAX-fitted cfg4 golden state (``tools/regen_goldens.build_problem``:
256 points in a buffer of 512, m 64, the VFE fit and the Lipschitz
estimate) is carried into the port by ``sparse_gpssm_from_numpy``:

  * the posterior at the golden's probes and the tube at its plan within
    1e-4 of ``tests/goldens/cfg4_pendulum_sparse.npz`` (the gates of
    tests/test_goldens.py), and its safety margins; the lane tube and the
    whole-tube scorer's plain version give the same margins;
  * the single-instance NLP planner from zeros: feasible, cost within 1e-3
    of the golden's ``opt_cost``;
  * the lane posterior over the inducing rows (the lane SQP's plain form
    and the fused kernel's plain version on ``prepare_posterior``) against
    ``sparse_gp_predict_mean_jac`` at 1e-12, with and without ``z_scale``;
  * the support predicates (lane SQP, lane CEM, both kernels; not the
    fleet's per-lane appends);
  * the lane SQP (3 stages) and the lane CEM ("auto", "xla"; 5 stages) on
    6 and 4 lanes against the JAX package's (the CEM on JAX's draws):
    flags equal, k_ff within 1e-6.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.solvers.cem import CemConfig as JaxCemConfig  # noqa: E402
from safe_exploration_tpu.solvers.cem_lanes import (  # noqa: E402
    cem_plan_lanes as jax_cem_plan_lanes,
)
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    sparse_gpssm_from_numpy,
)
from safe_exploration_tpu_torch.models.sparse_gp import (  # noqa: E402
    sparse_gp_predict,
    sparse_gp_predict_mean_jac,
)
from safe_exploration_tpu_torch.ops.kernels import (  # noqa: E402
    cem_score_supported,
    gp_pallas_supported,
    posterior_plain,
    prepare_posterior,
    tube_score_plain,
)
from safe_exploration_tpu_torch.reachability import onestep as tos  # noqa: E402
from safe_exploration_tpu_torch.reachability import safety as tsafe  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem import CemConfig  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem_lanes import (  # noqa: E402
    _TubeCfg,
    cem_lanes_supported,
    cem_plan_lanes,
)
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    jax_sparse_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "goldens", "cfg4_pendulum_sparse.npz")
KT = ("rbf", "rbf")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def cfg4():
    """The JAX-fitted cfg4 golden state and its experiment, built by both
    packages (the port's model from the JAX state's arrays)."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        from regen_goldens import CASES, build_problem
    finally:
        sys.path.pop(0)
    env_name, n_safe, n_perf, _, kw = next(
        c for c in CASES if c[3] == "cfg4_pendulum_sparse")
    jexp, jssm, probes, x0, _ = build_problem(env_name, n_safe, n_perf, **kw)
    texp = build_experiment(dataclasses.replace(
        ExperimentConfig(), **dataclasses.asdict(jexp["cfg"])),
        dtype=torch.float64, device="cpu")
    tssm = sparse_gpssm_from_numpy(jax_sparse_gpssm_to_numpy(jssm), KT,
                                   device="cpu")
    return dict(jexp=jexp, jssm=jssm, texp=texp, tssm=tssm,
                probes=np.asarray(probes), x0=np.asarray(x0),
                g=np.load(GOLDEN))


def test_cfg4_posterior_and_tube_match_the_golden(cfg4):
    g, tssm, texp = cfg4["g"], cfg4["tssm"], cfg4["texp"]
    np.testing.assert_allclose(cfg4["probes"], g["probes"], rtol=0, atol=1e-6)
    mean, var = sparse_gp_predict(tssm.sgp, _t(cfg4["probes"]))
    assert _rel(mean.numpy(), g["posterior_mean"]) < 1e-4
    # the variance is a cancellation against the prior: normalized by it
    kzz = max(float(torch.exp(2.0 * p["log_sf"])) for p in tssm.sgp.params)
    assert np.max(np.abs(var.numpy() - g["posterior_var"])) / kzz < 1e-4
    a, b, k_fb = texp["a"], texp["b"], texp["k_fb"]
    p, q, v = tos.multistep_reachability(
        tssm, _t(cfg4["x0"]), _t(g["k_ff_eval"]), k_fb.expand(5, 1, 2), a, b,
        2.5)
    for t, ref in ((p, "p_traj"), (q, "q_traj"), (v, "var_traj")):
        assert _rel(t.numpy(), g[ref]) < 1e-4, ref
    spec = texp["env"].spec
    d_stage = tsafe.lin_ellipsoid_safety_distance(p, q, spec.h_mat_obs,
                                                  spec.h_obs)
    d_term = tsafe.lin_ellipsoid_safety_distance(p[-1], q[-1],
                                                 spec.h_mat_safe, spec.h_safe)
    assert np.max(np.abs(d_stage.numpy() - g["d_stage"])) < 1e-4
    assert np.max(np.abs(d_term.numpy() - g["d_term"])) < 1e-4
    # the lane tube (plain form, the fused posterior's plain version) and
    # the whole-tube scorer's plain version at 2.5 sigma on the same plan
    s_lift = torch.cat([torch.eye(2, dtype=torch.float64), k_fb], 0)
    bmat = s_lift.T @ s_lift
    u = _t(g["k_ff_eval"].reshape(5, 1))
    x0 = _t(cfg4["x0"][:, None])
    polys = (spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe)
    ref = np.concatenate([g["d_stage"].reshape(-1), g["d_term"]])
    for impl in ("xla", "pallas"):
        y = tl._rollout_y_lanes(tssm, u, x0, k_fb, a, b, _TubeCfg(5, 2.5, 0),
                                bmat, impl=impl)
        d = tl._dist_lanes(y, 5, 2, *polys)[:, 0].numpy()
        assert np.max(np.abs(d - ref)) < 1e-4, impl
    _, viol = tube_score_plain(tssm, u, x0, k_fb, a, b, bmat, *polys, 2.5, 5,
                               "tracking", {"target": spec.target})
    assert abs(float(viol[0]) - np.maximum(ref, 0.0).sum()) < 1e-4


def test_cfg4_planner_meets_the_golden(cfg4):
    """``build_experiment``'s NLP planner at the golden's 8 x 4 budget from
    zeros: feasible where the golden was, cost within 1e-3 relative."""
    g = cfg4["g"]
    k_ff, feasible, violation, info = cfg4["texp"]["planner"](
        None, cfg4["tssm"], _t(g["x0"]), torch.zeros((5, 1),
                                                     dtype=torch.float64))
    assert bool(g["opt_feasible"])
    assert bool(feasible), float(violation)
    scale = abs(float(g["opt_cost"])) + 1e-9
    assert abs(float(info["cost"]) - float(g["opt_cost"])) / scale < 1e-3


def test_lane_posterior_matches_sparse_predict(cfg4):
    """The lane SQP's posterior over the m inducing rows (alpha, vmat, no
    mask) and the fused kernel's plain version on ``prepare_posterior``,
    against ``sparse_gp_predict_mean_jac`` (the z_scale chain rule applied
    to its Jacobian) at 1e-12; the variance, a cancellation against the
    prior, normalized by the prior as in tests/test_goldens.py."""
    z = np.random.default_rng(7).uniform(-0.5, 0.5, (16, 3))
    for z_scale in (None, _t([0.5, 2.0, 1.0])):
        tssm = cfg4["tssm"].replace(z_scale=z_scale)
        zz = _t(z) if z_scale is None else _t(z) / z_scale
        mu, var, jac = sparse_gp_predict_mean_jac(tssm.sgp, zz)
        if z_scale is not None:
            jac = jac / z_scale
        post = prepare_posterior(tssm)
        kzz = max(float(torch.exp(2.0 * p["log_sf"]))
                  for p in tssm.sgp.params)
        for out in (tl._gp_predict_lanes(tssm, _t(z.T), want_jac=True),
                    posterior_plain(post, _t(z.T), want_jac=True)):
            assert _rel(out[0].T.numpy(), mu.numpy()) < 1e-12
            assert float(torch.max(torch.abs(out[1].T - var))) / kzz < 1e-12
            assert _rel(out[2].permute(2, 0, 1).numpy(), jac.numpy()) < 1e-12
        assert post.x.shape == (64, 3) and post.w_var_t.shape == (2, 64, 64)


def test_support_predicates_take_the_sparse_model(cfg4):
    tssm, texp = cfg4["tssm"], cfg4["texp"]
    for kind in ("tracking", "exploration"):
        assert tl.lanes_supported(tssm, SqpConfig(n_safe=5), kind)
        assert cem_lanes_supported(tssm, kind)
        assert cem_score_supported(tssm, 2, kind, 0)
    assert not tl.lanes_supported(tssm, SqpConfig(opt_k_fb=True), "tracking")
    assert gp_pallas_supported(tssm)
    assert not cem_score_supported(tssm, 2, "tracking", 3)
    # the sparse model rides the lane batch planner, not the fleet runner's
    # per-lane appends
    assert not texp["lane_batch_supported"](tssm)


def test_lane_sqp_matches_jax_on_the_sparse_model(cfg4):
    """The lane SQP (3 stages, a 3 x 2 + 1 budget) on 6 lanes, some pushed
    past the constraint boundary: flags equal, k_ff within 1e-6."""
    kw = dict(solver="sqp", n_safe=3, n_max=512, c_safety=1.8, sqp_outer=3,
              sqp_inner=2, sqp_polish=1, sqp_rescue=0)
    jexp = dataclasses.replace(cfg4["jexp"]["cfg"], **kw)
    from safe_exploration_tpu.runtime.config import build_experiment as jb

    jplanner = jb(jexp, dtype=jnp.float64)["batch_planner"]
    texp = build_experiment(ExperimentConfig(**kw), dtype=torch.float64,
                            device="cpu")
    x0s = np.random.default_rng(3).uniform(-1.0, 1.0, (6, 2)) * [0.15, 0.4]
    x0s[::3] *= 4.0
    warm = np.zeros((6, 3, 1))
    jssm = cfg4["jssm"]
    jk, jf, jv, ji = jit_once(jplanner, jssm, jnp.asarray(x0s),
                              jnp.asarray(warm))(jssm, jnp.asarray(x0s),
                                                 jnp.asarray(warm))
    tk, tf, tv, ti = texp["batch_planner"](cfg4["tssm"], _t(x0s), _t(warm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    assert _rel(tk.numpy(), jk) < 1e-6
    assert _rel(ti["cost"].numpy(), ji["cost"]) < 1e-6
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-12)


LANE_CEM = dict(n_safe=5, n_samples=8, n_elites=3, n_iterations=3)


@pytest.fixture(scope="module")
def lane_cem_ref(cfg4):
    """The JAX lane CEM's plan on the cfg4 model from one key, with its
    draws."""
    jexp = cfg4["jexp"]
    spec = jexp["env"].spec
    x0s = np.random.default_rng(6).uniform(-1.0, 1.0, (4, 2)) * [0.15, 0.4]
    x0s[0] = [0.42, 1.1]
    warm = np.random.default_rng(7).uniform(-0.3, 0.3, (4, 5, 1))
    key = jax.random.PRNGKey(3)
    ref = jax_cem_plan_lanes(
        key, cfg4["jssm"], jnp.asarray(x0s), jexp["k_fb"], jexp["a"],
        jexp["b"], spec.u_min, spec.u_max, spec.h_mat_obs, spec.h_obs,
        spec.h_mat_safe, spec.h_safe, 1.8, "tracking",
        {"target": spec.target}, JaxCemConfig(**LANE_CEM),
        warm=jnp.asarray(warm))
    draws = np.stack([np.asarray(jax.random.normal(k, (8, 5, 4), jnp.float64))
                      for k in jax.random.split(key, 3)])
    return x0s, warm, ref, draws


def test_lane_cem_matches_jax_on_the_sparse_model(cfg4, lane_cem_ref):
    """The lane CEM with JAX's draws, under "auto" (the two kernels' plain
    versions: the whole-tube scorer and the fused posterior on the sparse
    model) and "xla": flags equal, k_ff within 1e-6."""
    x0s, warm, ref, draws = lane_cem_ref
    texp = cfg4["texp"]
    spec = texp["env"].spec
    jk, jf, jv, jinfo = ref
    assert np.asarray(jf).any()
    for gp_impl in ("auto", "xla"):
        out = cem_plan_lanes(
            None, cfg4["tssm"], _t(x0s), texp["k_fb"], texp["a"], texp["b"],
            spec.u_min, spec.u_max, spec.h_mat_obs, spec.h_obs,
            spec.h_mat_safe, spec.h_safe, 1.8, "tracking",
            {"target": spec.target}, CemConfig(**LANE_CEM, gp_impl=gp_impl),
            warm=_t(warm), noise=_t(draws))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jf))
        assert _rel(out[0].numpy(), jk) < 1e-6, gp_impl
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jv),
                                   rtol=1e-6, atol=1e-12)
        assert _rel(out[3]["cost"].numpy(), jinfo["cost"]) < 1e-6, gp_impl

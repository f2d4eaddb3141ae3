"""PyTorch port: the lane CEM, the portable CEM and the two CEM kernels'
plain versions against the JAX package, on the CPU.

  * ``gp_predict_plain`` against the JAX lane posterior ``_gp_predict_lanes``
    in f64 at 1e-10 relative (the distance is taken in another form, so only
    rounding differs), and against the Pallas kernel in interpret mode in
    f32 at rtol 3e-5, atol 3e-6 (the gates of tests/test_pallas_gp_predict);
  * ``tube_score_plain`` against the JAX scorer chain ``_rollout_y_lanes`` +
    ``_dist_lanes`` + ``_cost_lanes`` in f64 at 1e-10, and against the
    Pallas scorer in interpret mode in f32 at rtol 2e-4, atol 1e-6 on cost
    and 2e-5 on viol (the gates of tests/test_pallas_cem_score);
  * ``cem_plan_lanes`` and the ``planner`` of ``build_experiment`` (portable
    and lane backends) fed JAX's own draws (``jax.random.split`` then
    ``jax.random.normal`` per iteration, as the JAX planners draw them) in
    f64: the same feasible flags, and k_ff, cost and violation at 1e-8; the
    fused scorer prepared once per solve;
  * two closed-loop ``get_action_batch`` steps of ``build_experiment(solver=
    "cem")`` against JAX's in f64: the same flags and u at 1e-8.

Shapes are small (B 4, M 8, 2-3 iterations, n_max 16, H 3-5) and the JAX
models are built once per module.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.envs import env_step as jax_env_step  # noqa: E402
from safe_exploration_tpu.envs.base import _integrate as jax_integrate  # noqa: E402
from safe_exploration_tpu.envs import linearize_discretize as jax_lin  # noqa: E402
from safe_exploration_tpu.envs import make_pendulum as jax_pendulum  # noqa: E402
from safe_exploration_tpu.models import make_gp_ssm as jax_make_ssm  # noqa: E402
from safe_exploration_tpu.models.gp import gp_refit as jax_refit  # noqa: E402
from safe_exploration_tpu.ops.linalg import dlqr as jax_dlqr  # noqa: E402
from safe_exploration_tpu.ops.pallas.cem_score import (  # noqa: E402
    tube_score_lanes_pallas,
)
from safe_exploration_tpu.ops.pallas.gp_predict import (  # noqa: E402
    gp_predict_lanes_pallas,
)
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.solvers import sqp_lanes as jl  # noqa: E402
from safe_exploration_tpu.solvers.cem import CemConfig as JaxCemConfig  # noqa: E402
from safe_exploration_tpu.solvers.cem_lanes import (  # noqa: E402
    cem_plan_lanes as jax_cem_plan_lanes,
)
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.ops.kernels import (  # noqa: E402
    cem_score_supported,
    gp_predict_lanes,
    gp_predict_plain,
    prepare_tube_score,
    tube_score_lanes,
    tube_score_plain,
    tube_score_prepared,
)
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
from safe_exploration_tpu_torch.solvers.safempc import (  # noqa: E402
    SafeMPCConfig,
    make_safempc_batch,
)
from test_torch_bridge import jax_gpssm_to_numpy, one_torch_thread  # noqa: E402,F401

KT = ("rbf", "rbf")
B = 4
N_MAX = 16
N_DATA = 12
SSM_KW = dict(l_mu=0.05, l_sigma=0.02, log_noise=-4.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_ssm(dtype, z_scale):
    """bench-style GP-SSM (log_sf -3) on JAX-drawn pendulum data."""
    env = jax_pendulum(dtype=dtype)
    a, b = jax_lin(env)
    key = jax.random.PRNGKey(0)
    xs = (jax.random.uniform(key, (N_DATA, 2), dtype, -1.0, 1.0)
          * jnp.asarray([0.3, 1.0], dtype))
    us = jax.random.uniform(jax.random.fold_in(key, 1), (N_DATA, 1), dtype,
                            -1.0, 1.0)
    _, x_next = jax.vmap(lambda x, u: jax_env_step(env, key, x, u))(xs, us)
    resid = x_next - (xs @ a.T + us @ b.T)
    ssm = jax_make_ssm(
        KT, xs, us, resid, n_max=N_MAX, l_mu=jnp.full((2,), 0.05, dtype),
        l_sigma=jnp.full((2,), 0.02, dtype), log_noise=-4.0,
        z_scale=jnp.asarray([0.5, 2.0, 1.0], dtype) if z_scale else None)
    params = tuple({**p, "log_sf": jnp.asarray(-3.0, dtype)}
                   for p in ssm.gp.params)
    return ssm.replace(gp=jax_refit(ssm.gp.replace(params=params)))


@pytest.fixture(scope="module")
def models():
    """(jax ssm, port ssm) per (dtype name, z_scale), built on first use."""
    cache = {}

    def get(dtype, z_scale):
        if (dtype, z_scale) not in cache:
            jdt = {"f64": jnp.float64, "f32": jnp.float32}[dtype]
            tdt = {"f64": torch.float64, "f32": torch.float32}[dtype]
            jssm = _jax_ssm(jdt, z_scale)
            cache[dtype, z_scale] = (jssm, gpssm_from_numpy(
                jax_gpssm_to_numpy(jssm), KT, device="cpu", dtype=tdt))
        return cache[dtype, z_scale]

    return get


@pytest.fixture(scope="module")
def plant():
    """The JAX pendulum's prior, LQR gain and polytopes (f64)."""
    env = jax_pendulum(dtype=jnp.float64)
    a, b = jax_lin(env)
    k_lqr, _ = jax_dlqr(a, b, jnp.eye(2), jnp.eye(1))
    k_fb = np.asarray(-k_lqr)
    s_lift = np.concatenate([np.eye(2), k_fb], axis=0)
    spec = env.spec
    return dict(env=env, a=np.asarray(a), b=np.asarray(b), k_fb=k_fb,
                bmat=s_lift.T @ s_lift, u_min=np.asarray(spec.u_min),
                u_max=np.asarray(spec.u_max),
                polys=[np.asarray(v) for v in (spec.h_mat_obs, spec.h_obs,
                                               spec.h_mat_safe, spec.h_safe)],
                target=np.asarray(spec.target))


def _lanes(n_lanes, t_len, seed):
    rng = np.random.default_rng(seed)
    u = 0.4 * rng.standard_normal((t_len, n_lanes))
    x0 = rng.uniform(-1.0, 1.0, (2, n_lanes)) * np.array([[0.15], [0.4]])
    return u, x0


def _masked(ssm_np):
    m = ssm_np["mask"]
    return (ssm_np["beta"] * m[None], ssm_np["kinv"] * (m[None, :, None]
                                                         * m[None, None, :]))


@pytest.mark.parametrize("z_scale", [True, False])
@pytest.mark.parametrize("want_jac", [False, True])
def test_gp_predict_plain_matches_jax_lane_form_f64(models, want_jac, z_scale):
    jssm, tssm = models("f64", z_scale)
    z = np.random.default_rng(1).uniform(-0.6, 0.6, (3, 37))
    ref = jl._gp_predict_lanes(jssm, jnp.asarray(z), want_jac=want_jac)
    out = tl._gp_predict_lanes(tssm, _t(z), want_jac=want_jac, impl="pallas")
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10


@pytest.mark.parametrize("want_jac", [False, True])
def test_gp_predict_plain_matches_pallas_interpret_f32(models, want_jac):
    jssm, _ = models("f32", True)
    arr = jax_gpssm_to_numpy(jssm)
    w_mean, w_var = _masked(arr)
    log_ls = np.stack([p["log_lengthscales"] for p in arr["params"]])
    log_sf = np.stack([p["log_sf"] for p in arr["params"]])
    zz = np.random.default_rng(2).uniform(-1.0, 1.0, (3, 37)).astype(np.float32)
    ins = (arr["x"], w_mean, w_var, log_ls, log_sf, zz)
    ref = gp_predict_lanes_pallas(*(jnp.asarray(v, jnp.float32) for v in ins),
                                  want_jac=want_jac, block_l=16,
                                  interpret=True)
    out = gp_predict_plain(*(_t(v, torch.float32) for v in ins),
                           want_jac=want_jac)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=3e-5,
                                   atol=3e-6)


def _jax_chain(jssm, plant, u, x0, t_len, cost_kind, c_safety=2.0):
    cost_args = ({"target": jnp.asarray(plant["target"])}
                 if cost_kind == "tracking" else {})
    cfg = _TubeCfg(n_safe=t_len, c_safety=c_safety, n_perf=0)
    dt = jssm.gp.x.dtype
    y = jl._rollout_y_lanes(jssm, jnp.asarray(u, dt),
                            [jnp.asarray(r, dt) for r in x0],
                            jnp.asarray(plant["k_fb"], dt),
                            jnp.asarray(plant["a"], dt),
                            jnp.asarray(plant["b"], dt), cfg,
                            jnp.asarray(plant["bmat"], dt), 0, 1)
    g = jl._dist_lanes(y, t_len, 2, *(jnp.asarray(v, dt)
                                      for v in plant["polys"]))
    viol = jnp.sum(jnp.maximum(g, 0.0), axis=0)
    cost = jl._cost_lanes(cost_kind, cost_args, y, jnp.asarray(u, dt), t_len,
                          2, 1)
    return np.asarray(cost), np.asarray(viol)


def _port_score(tssm, plant, u, x0, t_len, cost_kind, dtype, fn):
    cost_args = ({"target": _t(plant["target"], dtype)}
                 if cost_kind == "tracking" else {})
    return fn(tssm, _t(u, dtype), _t(x0, dtype),
              *(_t(plant[k], dtype) for k in ("k_fb", "a", "b", "bmat")),
              *(_t(v, dtype) for v in plant["polys"]), 2.0, t_len, cost_kind,
              cost_args)


@pytest.mark.parametrize("z_scale", [True, False])
@pytest.mark.parametrize("cost_kind", ["tracking", "exploration"])
def test_tube_score_plain_matches_jax_chain_f64(models, plant, cost_kind,
                                                z_scale):
    jssm, tssm = models("f64", z_scale)
    u, x0 = _lanes(37, 4, 3)
    c_ref, v_ref = _jax_chain(jssm, plant, u, x0, 4, cost_kind)
    assert v_ref.max() > 0 and (v_ref == 0).any()   # both kinds of lane
    cost, viol = _port_score(tssm, plant, u, x0, 4, cost_kind, torch.float64,
                             tube_score_plain)
    assert _rel(cost.numpy(), c_ref) < 1e-10
    assert _rel(viol.numpy(), v_ref) < 1e-10
    assert cem_score_supported(tssm, 2, cost_kind, 0)


@pytest.mark.parametrize("z_scale", [True, False])
@pytest.mark.parametrize("cost_kind", ["tracking", "exploration"])
def test_tube_score_plain_matches_pallas_interpret_f32(models, plant,
                                                       cost_kind, z_scale):
    jssm, tssm = models("f32", z_scale)
    u, x0 = _lanes(37, 4, 4)
    u, x0 = u.astype(np.float32), x0.astype(np.float32)
    f32 = jnp.float32
    cost_args = ({"target": jnp.asarray(plant["target"], f32)}
                 if cost_kind == "tracking" else {})
    c_ref, v_ref = tube_score_lanes_pallas(
        jssm, jnp.asarray(u), jnp.asarray(x0),
        *(jnp.asarray(plant[k], f32) for k in ("k_fb", "a", "b", "bmat")),
        *(jnp.asarray(v, f32) for v in plant["polys"]), 2.0, 4, cost_kind,
        cost_args, block_l=16, interpret=True)
    cost, viol = _port_score(tssm, plant, u, x0, 4, cost_kind, torch.float32,
                             tube_score_plain)
    np.testing.assert_allclose(cost.numpy(), np.asarray(c_ref), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(viol.numpy(), np.asarray(v_ref), rtol=2e-4,
                               atol=2e-5)


def test_cpu_wrappers_take_plain_versions(models, plant):
    """On CPU tensors the two CEM wrappers are their plain versions and
    count no launch."""
    _, tssm = models("f64", True)
    before = (gp_predict_lanes.launches, tube_score_prepared.launches)
    u, x0 = _lanes(9, 3, 5)
    a = _port_score(tssm, plant, u, x0, 3, "tracking", torch.float64,
                    tube_score_lanes)
    b = _port_score(tssm, plant, u, x0, 3, "tracking", torch.float64,
                    tube_score_plain)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (gp_predict_lanes.launches, tube_score_prepared.launches) == before


def _jax_draws(key, n_it, shape, dtype=jnp.float64):
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype))
                     for k in jax.random.split(key, n_it)])


def _assert_plans(out, ref):
    k, f, v, info = out
    jk, jf, jv, jinfo = ref
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(info["cost"].numpy(), np.asarray(jinfo["cost"]),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("gp_impl", ["auto", "xla"])
@pytest.mark.parametrize("cost_kind", ["tracking", "exploration"])
def test_cem_plan_lanes_matches_jax_with_its_draws(models, plant, cost_kind,
                                                   gp_impl):
    jssm, tssm = models("f64", True)
    cfg = dict(n_safe=3, n_samples=8, n_elites=3, n_iterations=3)
    x0s = np.random.default_rng(6).uniform(-1.0, 1.0, (B, 2)) * [0.15, 0.4]
    x0s[0] = [0.42, 1.1]                    # a lane near the boundary
    warm = np.random.default_rng(7).uniform(-0.3, 0.3, (B, 3, 1))
    key = jax.random.PRNGKey(3)
    args = (plant["k_fb"], plant["a"], plant["b"], plant["u_min"],
            plant["u_max"], *plant["polys"])
    jargs = (jnp.asarray(v) for v in args)
    jcost = {"target": jnp.asarray(plant["target"])} \
        if cost_kind == "tracking" else {}
    ref = jax_cem_plan_lanes(key, jssm, jnp.asarray(x0s), *jargs, 2.0,
                             cost_kind, jcost, JaxCemConfig(**cfg),
                             warm=jnp.asarray(warm))
    tcost = {"target": _t(plant["target"])} if cost_kind == "tracking" else {}
    prepared = prepare_tube_score.calls
    out = cem_plan_lanes(None, tssm, _t(x0s), *(_t(v) for v in args), 2.0,
                         cost_kind, tcost, CemConfig(**cfg, gp_impl=gp_impl),
                         warm=_t(warm),
                         noise=_t(_jax_draws(key, 3, (8, 3, B))))
    # the fused scorer prepares the model once per solve
    assert prepare_tube_score.calls == prepared + (gp_impl == "auto")
    _assert_plans(out, ref)
    assert np.asarray(ref[1]).any() and not np.asarray(ref[1]).all()
    np.testing.assert_allclose(out[3]["p_traj"].numpy(),
                               np.asarray(ref[3]["p_traj"]), rtol=1e-8)
    assert cem_lanes_supported(tssm, cost_kind)


def _experiment_data(jexp, seed=2):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1.0, 1.0, (N_DATA, 2)) * [0.3, 1.0]
    us = rng.uniform(-1.0, 1.0, (N_DATA, 1))
    a, b = np.asarray(jexp["a"]), np.asarray(jexp["b"])
    x_next = np.asarray(jax.vmap(
        lambda x, u: jax_env_step(jexp["env"], jax.random.PRNGKey(0), x, u)
    )(jnp.asarray(xs), jnp.asarray(us))[1])
    return xs, us, x_next - (xs @ a.T + us @ b.T)


def _both(**kw):
    cfg = dict(solver="cem", n_safe=3, n_max=N_MAX, cem_samples=8,
               cem_elites=3, cem_iterations=2, **SSM_KW, **kw)
    jexp = jax_build(JaxConfig(**cfg), dtype=jnp.float64)
    texp = build_experiment(ExperimentConfig(**cfg), dtype=torch.float64,
                            device="cpu")
    xs, us, resid = _experiment_data(jexp)
    jssm = jexp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(xs),
                            jnp.asarray(us), jnp.asarray(resid))
    tssm = texp["make_ssm"](_t(xs), _t(us), _t(resid))
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(tssm.gp, f).numpy(), getattr(jssm.gp, f)) < 1e-9
    return jexp, texp, jssm, tssm


@pytest.mark.parametrize("backend", ["portable", "lanes"])
@pytest.mark.parametrize("objective", ["tracking", "exploration"])
def test_planner_matches_jax_with_its_draws(objective, backend):
    """build_experiment's single-instance planner: the portable cem_plan
    (draws (n_it, M, T, n_u)) or the lane CEM at B = 1 (draws (n_it, M,
    n_var, 1)), each fed the draws of the JAX planner's PRNGKey(0)."""
    jexp, texp, jssm, tssm = _both(objective=objective, cem_backend=backend)
    x0 = np.array([0.1, -0.25])
    warm = np.full((3, 1), 0.05)
    ref = jexp["planner"](jax.random.PRNGKey(0), jssm, jnp.asarray(x0),
                          jnp.asarray(warm))
    # (M, T, n_u) for cem_plan, (M, n_var, B = 1) for the lane CEM
    draws = _jax_draws(jax.random.PRNGKey(0), 2, (8, 3, 1))
    out = texp["planner"](None, tssm, _t(x0), _t(warm), noise=_t(draws))
    _assert_plans(out, ref)
    np.testing.assert_allclose(out[3]["warm_next"].numpy(),
                               np.asarray(ref[3]["warm_next"]), rtol=1e-8,
                               atol=1e-12)


def test_two_closed_loop_steps_match_jax():
    """get_action_batch of build_experiment(solver="cem") twice around a
    plant step and an ssm_update; the port's batch planner gets the draws
    of the JAX batch planner's PRNGKey(0) (the same every call)."""
    from safe_exploration_tpu.models.ssm import ssm_update as jax_update
    from safe_exploration_tpu_torch.envs import env_step
    from safe_exploration_tpu_torch.models.ssm import ssm_update

    jexp, texp, jssm, tssm = _both()
    draws = _t(_jax_draws(jax.random.PRNGKey(0), 2, (8, 3, B)))
    cfg = texp["cfg"]
    init, step = make_safempc_batch(
        texp["env"], SafeMPCConfig(n_safe=3, c_safety=cfg.c_safety),
        partial(texp["batch_planner"], noise=draws), warm_len=3)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1.0, 1.0, (B, 2)) * [0.15, 0.4]
    x[0] *= 3.0
    jstate, tstate = jexp["init_state_batch"](B), init(B)
    jx, tx = jnp.asarray(x), _t(x)
    flags = []
    for k in range(2):
        ju, jstate, jinfo = jexp["get_action_batch"](jstate, jssm, jx)
        tu, tstate, tinfo = step(tstate, tssm, tx)
        np.testing.assert_array_equal(tinfo["feasible"].numpy(),
                                      np.asarray(jinfo["feasible"]))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_array_equal(tstate.plan_idx.numpy(),
                                      np.asarray(jstate.plan_idx))
        np.testing.assert_allclose(tstate.warm_mean.numpy(),
                                   np.asarray(jstate.warm_mean), rtol=1e-8,
                                   atol=1e-12)
        flags.append(np.asarray(jinfo["feasible"]))
        if k == 0:
            noise = rng.standard_normal((B, 2))
            env = jexp["env"]
            u_app = jnp.clip(ju, env.spec.u_min, env.spec.u_max)
            jx1 = jax.vmap(lambda xx, uu: jax_integrate(env, xx, uu))(
                jx, u_app) + env.spec.plant_noise * jnp.asarray(noise)
            _, tx1 = env_step(texp["env"], tx, tu, noise=_t(noise))
            assert _rel(tx1.numpy(), jx1) < 1e-10
            jres = jx1 - (jx @ jexp["a"].T + ju @ jexp["b"].T)
            tres = tx1 - (tx @ texp["a"].T + tu @ texp["b"].T)
            jssm = jax_update(jssm, jx, ju, jres)
            tssm = ssm_update(tssm, tx, tu, tres)
            jx, tx = jx1, tx1
    assert np.concatenate(flags).any()


def test_batched_safempc_without_planner_centers_uses_multistep(models):
    """A batch planner that returns no p_traj: make_safempc_batch recomputes
    the centers with multistep_reachability, and they equal the lane CEM's
    own tube centers."""
    _, tssm = models("f64", True)
    exp = build_experiment(ExperimentConfig(
        solver="cem", n_safe=3, cem_samples=8, cem_elites=3,
        cem_iterations=2), dtype=torch.float64, device="cpu")

    def no_centers(ssm, x0s, warm):
        k, f, v, info = exp["batch_planner"](ssm, x0s, warm)
        return k, f, v, {k_: v_ for k_, v_ in info.items() if k_ != "p_traj"}

    x = _t(np.random.default_rng(9).uniform(-1.0, 1.0, (B, 2)) * [0.05, 0.1])
    init, step = make_safempc_batch(
        exp["env"], SafeMPCConfig(n_safe=3, c_safety=2.0), no_centers,
        warm_len=3)
    _, state, info = step(init(B), tssm, x)
    _, ref_state, ref_info = exp["get_action_batch"](
        exp["init_state_batch"](B), tssm, x)
    feas = ref_info["feasible"].numpy()
    assert feas.any()
    assert _rel(state.p_plan.numpy()[feas], ref_state.p_plan.numpy()[feas]) \
        < 1e-10


def test_cold_start_feasibility_matches_jax_on_bench_draws():
    """bench.py's bench_cem_solves configuration at full size (B 256, M 64,
    4 iterations, n_max 64 with 48 points, H 5, f32) on bench.py's own
    jax.random model and x0s, the port fed the JAX planner's draws: the
    feasible flags agree on >= 95 % of the lanes (f32 sums in another order
    may flip a marginal lane's elites) and the feasible fractions within
    2 / 256. BENCH_r05.json records 0.273 for this configuration on a TPU."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    try:
        import bench
    finally:
        sys.path.pop(0)
    from safe_exploration_tpu.models.ssm import ssm_bucketed as jax_bucketed

    f32 = jnp.float32
    _, jssm, x0s, _ = bench.build(256, 64, 48, 5, f32)
    kw = dict(solver="cem", n_safe=5, n_max=64, cem_samples=64, cem_elites=12,
              cem_iterations=4)
    jexp = jax_build(JaxConfig(**kw), dtype=f32)
    plan = jax_bucketed(jssm)
    warm = np.zeros((256, 5, 1), np.float32)
    ref = jax.jit(jexp["batch_planner"])(plan, x0s, jnp.asarray(warm))
    texp = build_experiment(ExperimentConfig(**kw), dtype=torch.float32,
                            device="cpu")
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(plan), KT, device="cpu",
                            dtype=torch.float32)
    draws = _jax_draws(jax.random.PRNGKey(0), 4, (64, 5, 256), f32)
    out = texp["batch_planner"](tssm, _t(x0s, torch.float32),
                                _t(warm, torch.float32),
                                noise=_t(draws, torch.float32))
    jf, tf = np.asarray(ref[1]), out[1].numpy()
    print(f"cold-start feasible_frac: JAX {jf.mean():.4f}, port {tf.mean():.4f}"
          f", flags agree on {(jf == tf).sum()} of 256 lanes")
    assert (jf == tf).mean() >= 0.95
    assert abs(jf.mean() - tf.mean()) <= 2 / 256

"""PyTorch port: the lane fleet runner against the JAX package, on the CPU,
in f64, at a tiny size (4 lanes, n_max 32, 3 steps, 2 episodes, the lane
SQP at n_safe 2, 2 outer x 2 inner; 8 fit steps, where the first episode
falls back on every step and the second is feasible on every step — at 3
every step would fall back):

  * ``models/gp_lanes.py``: 3 lockstep appends, ``lane_predict`` with its
    Jacobian on shared and on per-lane hyperparameters, the
    stack -> unstack -> restack round trip, shrink and expand, at 1e-9;
    the full-buffer no-op and the lockstep guard;
  * the stacked GP: ``gp_nll`` per lane, ``gp_refit`` and ``gp_fit``, and
    the per-lane fit plus Lipschitz calibration, against JAX's vmapped
    ones at 1e-8;
  * one lane-SQP solve on a per-lane model at the lane-SQP parity gates
    of tests/test_torch_sqp_lanes.py;
  * what raises naming its ROADMAP item (the stacked backend itself:
    tests/test_torch_stacked.py).

The fleet run as a whole (``run_experiment`` on this configuration against
the JAX CLI's) and the single-model entries on a stacked model are in
tests/test_torch_fleet.py: two files of 9 tests, so that pytest-xdist,
which hands files out by their test counts, starts the long JAX files
first.

Each JAX program is built once for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu.models import gp_lanes as jgl  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    build_experiment as jax_build,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import gp_lanes as tgl  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    run_experiment,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_gpssm_to_numpy,
    jax_region,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
KT = ("rbf", "rbf")
B = 4
N_REGION = 384   # 128 d_in probes of the operating region
SET = ["batch_lanes=4", "n_max=32", "n_steps=3", "n_ep=2",
       "n_init_samples=8", "hyp_iters=8", "n_safe=2", "sqp_outer=2",
       "sqp_inner=2"]
CFG = _apply_overrides(CONFIGS["pendulum_batch_sqp"], SET)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jcfg():
    return dataclasses.replace(JAX_CONFIGS["pendulum_batch_sqp"],
                               **dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def exps():
    """The configuration built by both packages (f64)."""
    return (jax_build(_jcfg(), dtype=F64),
            build_experiment(CFG, dtype=torch.float64, device="cpu"))


def _transitions(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2)) * [0.3, 1.0]
    u = rng.uniform(-0.5, 0.5, (n, 1))
    y = 0.05 * np.sin(2.0 * x) + 0.01 * rng.standard_normal((n, 2))
    return x, u, y


@pytest.fixture(scope="module")
def lanes(exps):
    """One model fitted by JAX (12 points, n_max 32, z_scale), stacked into
    4 lanes by both packages, 3 lockstep appends of per-lane transitions,
    then the between-episode step: unstack (refit), the per-lane fit and
    calibration, restack."""
    jexp, texp = exps
    spec = jexp["env"].spec
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (12, 3)) * [0.3, 1.0, 1.0]
    y = 0.05 * np.sin(2.0 * x[:, :2]) + 0.01 * rng.standard_normal((12, 2))
    jm = jssm_mod.make_gp_ssm(
        KT, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]), jnp.asarray(y),
        n_max=32, l_mu=jexp["l_mu"], l_sigma=jexp["l_sigma"], log_noise=-3.0,
        z_scale=jnp.concatenate([spec.norm_x, spec.norm_u]))
    jm = jm.replace(gp=jax.jit(jgp.gp_fit, static_argnames="iters")(
        jm.gp, iters=5))
    tm = gpssm_from_numpy(jax_gpssm_to_numpy(jm), KT, device="cpu")
    j = {"stack": jgl.lane_stack_ssm(jm, B)}
    t = {"stack": tgl.lane_stack_ssm(tm, B)}
    append = jax.jit(jgl.lane_append_point)
    js, ts = j["stack"], t["stack"]
    for k in range(3):
        xs, us, ys = _transitions(10 + k)
        js = append(js, jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ys))
        ts = tgl.lane_append_point(ts, _t(xs), _t(us), _t(ys))
    j["appended"], t["appended"] = js, ts
    j["unstacked"] = jax.jit(jgl.lane_unstack_ssm)(js)
    t["unstacked"] = tgl.lane_unstack_ssm(ts)

    def fit_one(s):
        s = jssm_mod.ssm_fit(s, iters=3)
        return jssm_mod.calibrate_lipschitz(s, spec)

    j["fitted"] = jax.jit(jax.vmap(fit_one))(j["unstacked"])
    t["fitted"] = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(t["unstacked"], iters=3), texp["env"].spec,
        n_region=N_REGION, draws=jax_region(N_REGION))
    j["restacked"] = jgl.lane_restack_ssm(j["fitted"])
    t["restacked"] = tgl.lane_restack_ssm(t["fitted"])
    return j, t


def _assert_lane_gp(tg, jg, tol):
    for f in ("x", "y", "mask", "beta", "kinv"):
        assert _rel(_np(getattr(tg, f)), getattr(jg, f)) < tol, f
    assert tg.head == int(jg.head)
    for d in range(2):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(_np(tg.params[d][k]), jg.params[d][k]) < tol, (d, k)
    assert _rel(_np(tg.log_noise), jg.log_noise) < tol


def test_lane_append_matches_jax(lanes):
    j, t = lanes
    _assert_lane_gp(t["appended"].gp, j["appended"].gp, 1e-9)
    assert t["appended"].gp.head == 15
    # every lane learned its own points
    x = t["appended"].gp.x
    assert not torch.equal(x[12:, :, 0], x[12:, :, 1])


def test_lane_append_full_buffer_noop_and_lockstep_guard(exps):
    """A full buffer: the append leaves every lane as it was, in both
    packages; an append that does not carry one transition per lane
    raises, in both."""
    jexp, _ = exps
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0, 1.0, (8, 3)) * [0.3, 1.0, 1.0]
    y = 0.05 * np.sin(2.0 * x[:, :2])
    jm = jssm_mod.make_gp_ssm(
        KT, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]), jnp.asarray(y),
        n_max=8, l_mu=jexp["l_mu"], l_sigma=jexp["l_sigma"], log_noise=-3.0)
    tm = gpssm_from_numpy(jax_gpssm_to_numpy(jm), KT, device="cpu")
    js, ts = jgl.lane_stack_ssm(jm, B), tgl.lane_stack_ssm(tm, B)
    xs, us, ys = _transitions(5)
    jn = jgl.lane_append_point(js, jnp.asarray(xs), jnp.asarray(us),
                               jnp.asarray(ys))
    tn = tgl.lane_append_point(ts, _t(xs), _t(us), _t(ys))
    _assert_lane_gp(tn.gp, jn.gp, 1e-9)
    _assert_lane_gp(tn.gp, js.gp, 1e-9)
    for bad in (xs[:3], xs[0]):
        with pytest.raises(ValueError, match="lockstep"):
            tgl.lane_append_point(ts, _t(bad), _t(us[: len(bad)]),
                                  _t(ys[: len(bad)]))
        with pytest.raises(ValueError, match="lockstep"):
            jgl.lane_append_point(js, jnp.asarray(bad), jnp.asarray(us),
                                  jnp.asarray(ys))


@pytest.mark.parametrize("which", ["appended", "restacked"])
def test_lane_predict_with_jacobian_matches_jax(lanes, which):
    """Shared hyperparameters (after the appends) and per-lane ones (after
    the per-lane fit), at 1e-9; the lane SQP's folded copies (width 3 B)
    give each copy its own lane's answer."""
    j, t = lanes
    jm, tm = j[which], t[which]
    assert tm.gp.per_lane_hypers == (which == "restacked")
    z = np.random.default_rng(7).uniform(-1, 1, (3, B)) * [[0.5], [2.], [1.]]
    jo = jax.jit(jgl.lane_predict, static_argnames="want_jac")(
        jm, jnp.asarray(z), want_jac=True)
    to = tgl.lane_predict(tm, _t(z), want_jac=True)
    for a, b_ in zip(to, jo):
        assert _rel(_np(a), b_) < 1e-9
    wide = tgl.lane_predict(tm, _t(np.tile(z, 3)), want_jac=True)
    for a, w in zip(to, wide):
        for c in range(3):
            np.testing.assert_allclose(_np(w)[..., c * B:(c + 1) * B],
                                       _np(a), rtol=1e-10, atol=1e-15)


def test_stack_unstack_restack_round_trip(lanes):
    """unstack refits every lane (one batched refit) as JAX's vmapped
    gp_refit does; restack gives the lane model back with per-lane
    (batch-last) hyperparameters and constants."""
    j, t = lanes
    tu, ju = t["unstacked"], j["unstacked"]
    # the lockstep mask stays one shared (n_max,) row (JAX's vmapped GP
    # carries it per lane; every lane's is the same)
    assert tu.gp.x.shape == (B, 32, 3) and tu.gp.mask.shape == (32,)
    for f in ("chol", "beta", "kinv", "x", "y", "mask"):
        assert _rel(_np(getattr(tu.gp, f)), getattr(ju.gp, f)) < 1e-9, f
    for f in ("l_mu", "l_sigma", "z_scale"):
        assert _rel(_np(getattr(tu, f)), getattr(ju, f)) < 1e-12, f
    # the stacked refit reproduces the appended lanes' own beta and K^-1
    back = tgl.lane_restack_ssm(tu)
    for f in ("beta", "kinv"):
        assert _rel(_np(getattr(back.gp, f)),
                    _np(getattr(t["appended"].gp, f))) < 1e-9, f
    tr, jr = t["restacked"], j["restacked"]
    assert tr.gp.per_lane_hypers and jr.gp.per_lane_hypers
    assert tr.gp.params[0]["log_lengthscales"].shape == (3, B)
    assert tr.l_mu.shape == (2, B)
    _assert_lane_gp(tr.gp, jr.gp, 1e-8)
    for f in ("l_mu", "l_sigma", "z_scale"):
        assert _rel(_np(getattr(tr, f)), getattr(jr, f)) < 1e-8, f


def test_stacked_nll_refit_and_fit_match_jax_vmapped(lanes):
    """The stacked GP (4 lanes of distinct data): gp_nll per lane at 1e-10,
    gp_fit (3 Adam steps, then the batched refit) at 1e-8, against
    jax.vmap of the JAX functions; the per-lane fit + calibration of the
    fixture at 1e-8."""
    j, t = lanes
    jg, tg = j["unstacked"].gp, t["unstacked"].gp
    jn = jax.jit(jax.vmap(jgp.gp_nll))(jg.params, jg.log_noise, jg)
    tn = tgp.gp_nll(tg.params, tg.log_noise, tg)
    assert tn.shape == (B,)
    assert _rel(_np(tn), jn) < 1e-10
    jf = jax.jit(jax.vmap(lambda g: jgp.gp_fit(g, iters=3)))(jg)
    tf = tgp.gp_fit(tg, iters=3)
    for f in ("chol", "beta", "kinv", "log_noise"):
        assert _rel(_np(getattr(tf, f)), getattr(jf, f)) < 1e-8, f
    for d in range(2):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(_np(tf.params[d][k]), jf.params[d][k]) < 1e-8
    jfit, tfit = j["fitted"], t["fitted"]
    for f in ("l_mu", "l_sigma"):
        assert _rel(_np(getattr(tfit, f)), getattr(jfit, f)) < 1e-8, f
    # lanes with distinct data get distinct constants
    assert not torch.equal(tfit.l_mu[0], tfit.l_mu[1])


def test_shrink_and_expand_match_jax(lanes):
    j, t = lanes
    jm, tm = j["appended"], t["appended"]
    js = jgl.lane_shrink_to_bucket(jm, n_free=1, min_bucket=16)
    ts = tgl.lane_shrink_to_bucket(tm, n_free=1, min_bucket=16)
    assert ts.gp.n_max == js.gp.n_max == 16
    _assert_lane_gp(ts.gp, js.gp, 1e-9)
    assert tgl.lane_shrink_to_bucket(tm, n_free=2, min_bucket=16) is tm
    je, te = jgl.lane_expand_to(js, 32), tgl.lane_expand_to(ts, 32)
    _assert_lane_gp(te.gp, je.gp, 1e-9)
    _assert_lane_gp(te.gp, jm.gp, 1e-9)


def test_lane_sqp_solve_on_per_lane_model_matches_jax(exps, lanes):
    """The batched planner on the per-lane model (line-search candidates
    folded over its lanes, per-lane l_mu / l_sigma through the tube), at the lane-SQP gates of
    tests/test_torch_sqp_lanes.py; a per-lane model on a configuration the
    lane backend does not cover raises TypeError."""
    jexp, texp = exps
    j, t = lanes
    # the fitted lanes at a small per-lane signal and noise (refitted, both
    # sides) and small per-lane constants, so that some lanes are feasible
    lane = np.arange(B)
    log_sf, l_mu = -3.0 + 0.1 * lane, 0.05 * np.outer(1.0 + 0.1 * lane, [1, 1])
    log_noise = -4.5 - 0.05 * np.outer(lane, [1, 1])

    def small(fitted, refit, arr):
        gp = fitted.gp.replace(
            params=tuple({**p, "log_sf": arr(log_sf)} for p in fitted.gp.params),
            log_noise=arr(log_noise))
        return fitted.replace(gp=refit(gp), l_mu=arr(l_mu),
                              l_sigma=arr(0.5 * l_mu))

    jm = jgl.lane_restack_ssm(small(j["fitted"], jax.vmap(jgp.gp_refit),
                                    jnp.asarray))
    tm = tgl.lane_restack_ssm(small(t["fitted"], tgp.gp_refit, _t))
    x0s = np.random.default_rng(3).uniform(-1, 1, (B, 2)) * [0.2, 0.5]
    x0s[::2] *= 6.0          # push some lanes past the constraint boundary
    warm = np.zeros((B, 2, 1))
    args = (jm, jnp.asarray(x0s), jnp.asarray(warm))
    jk, jf, jv, ji = jit_once(jexp["batch_planner"], *args)(*args)
    tk, tf, tv, ti = texp["batch_planner"](tm, _t(x0s), _t(warm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    assert _rel(tk.numpy(), jk) < 1e-4
    assert _rel(ti["cost"].numpy(), ji["cost"]) < 1e-3
    assert _rel(ti["p_traj"].numpy(), ji["p_traj"]) < 1e-4
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-9)
    ff = tm.replace(gp=tm.gp.replace(precision="ff"))
    assert not texp["lane_batch_supported"](ff)
    with pytest.raises(TypeError, match="LaneGPSSM"):
        texp["batch_planner"](ff, _t(x0s), _t(warm))


def test_unported_batch_choices_raise_naming_their_item(exps, lanes):
    """What the fleet does not carry yet raises naming its Queue 1 item:
    the portable NLP over a stacked model (item 7: the SQP configurations
    on the stacked runner, and the batched planner handed a stacked
    model), the device mesh (item 13) and the kernel menu (item 3); an
    MC-dropout network in the fleet, where the JAX CLI fails too (item
    14)."""
    _, texp = exps
    _, t = lanes
    for backend in ("auto", "vmapped"):
        with pytest.raises(NotImplementedError, match="item 7"):
            run_experiment(_apply_overrides(CFG, [f"batch_backend={backend}"]),
                           device="cpu")
    x0s = torch.zeros((B, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="item 7"):
        texp["batch_planner"](t["unstacked"], x0s,
                              torch.zeros((B, 2, 1), dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="item 14"):
        run_experiment(_apply_overrides(CFG, ["ssm=mc_dropout"]),
                       device="cpu")
    for run in (tbatch.run_batched_episodes, tbatch.run_batched_episodes_lanes):
        with pytest.raises(NotImplementedError, match="item 13"):
            run(texp["env"], None, None, None, x0s, 1, texp["a"], texp["b"],
                mesh="lanes")
    with pytest.raises(NotImplementedError, match="item 13"):
        tbatch.run_batched_learning(texp["env"], texp, None, B, 1, 1,
                                    mesh="lanes")
    with pytest.raises(NotImplementedError, match="item 3"):
        tgl.lane_stack_ssm(type("S", (), {"gp": type("G", (), {
            "kern_types": ("rbf", "mat52")})()})(), B)

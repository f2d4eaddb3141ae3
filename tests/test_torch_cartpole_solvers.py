"""PyTorch port: BASELINE config 2, the cart-pole, through its solvers and
runners against the JAX package on the CPU in f64: the cfg2 golden's
posterior, tube and margins at the gates of tests/test_goldens.py; the
single-instance NLP's closures and derivatives at 1e-10 and its planner
against the golden's feasibility and cost; the portable CEM with n_perf on
the same noise; ``run_experiment`` on ``cartpole_batch_sqp`` at a small
size fed the JAX run's draws; both cart-pole configurations through the
CLI on ``--device cpu``.

Split from tests/test_torch_cartpole.py (the env, the propagation, the
tube, the perf trajectory, the lane models and one lane solve), whose
fixture and helpers it takes, so that each file's test count (pytest-xdist
hands files out by it) places it well in the tier-1 run's schedule.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.runtime import batch as jbatch  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
)
from safe_exploration_tpu.runtime.main import (  # noqa: E402
    run_experiment as jax_run_experiment,
)
from safe_exploration_tpu.solvers.cem import (  # noqa: E402
    CemConfig as JaxCemConfig,
    cem_plan as jax_cem_plan,
)
from safe_exploration_tpu.solvers.costs import (  # noqa: E402
    tracking_cost as jax_tracking_cost,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.reachability import (  # noqa: E402
    onestep as tos,
)
from safe_exploration_tpu_torch.reachability import (  # noqa: E402
    safety as tsafe,
)
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    main,
    run_experiment,
)
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.cem import (  # noqa: E402
    CemConfig,
    cem_plan,
)
from safe_exploration_tpu_torch.solvers.costs import (  # noqa: E402
    tracking_cost,
)
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    check_nlp_closures,
    jax_batch_draws,
    jit_once,
    one_torch_thread,
)
from test_torch_cartpole import (  # noqa: E402,F401
    CFG,
    F64,
    GOLDEN,
    N_S,
    N_U,
    _consts,
    _np,
    _polys,
    _recorder,
    _rel,
    _t,
    golden,
)


def test_cfg2_golden_posterior_and_tube(golden):
    """The cfg2 golden (tests/goldens/cfg2_cartpole_h10.npz) on the
    JAX-fitted state: posterior mean and variance at the probes, the port's
    tube (p_traj, q_traj, var_traj) at k_ff_eval and its stage and
    terminal margins, at the gates of tests/test_goldens.py (1e-4
    relative; the variance normalized by the prior kzz); the lane
    array-form tube's margins at the same plan."""
    g = np.load(GOLDEN)
    jexp, tssm, arrays = golden["jexp"], golden["tssm"], golden["arrays"]
    np.testing.assert_allclose(golden["probes"], g["probes"], rtol=0,
                               atol=1e-6)
    mean, var = tgp.gp_predict(tssm.gp, _t(golden["probes"]))
    assert _rel(mean.numpy(), g["posterior_mean"]) < 1e-4
    kzz = max(float(np.exp(2.0 * p["log_sf"])) for p in arrays["params"])
    assert np.max(np.abs(var.numpy() - g["posterior_var"])) / kzz < 1e-4
    k_fb, a, b, bmat = _consts(jexp)
    t_len = g["k_ff_eval"].shape[0]
    p, q, v = tos.multistep_reachability(
        tssm, _t(golden["x0"]), _t(g["k_ff_eval"]),
        _t(k_fb).expand(t_len, N_U, N_S), _t(a), _t(b), 2.5)
    assert _rel(p.numpy(), g["p_traj"]) < 1e-4
    assert _rel(q.numpy(), g["q_traj"]) < 1e-4
    assert _rel(v.numpy(), g["var_traj"]) < 1e-4
    spec = jexp["env"].spec
    polys = [_t(h) for h in _polys(spec)]
    d_stage = tsafe.lin_ellipsoid_safety_distance(p, q, *polys[:2])
    d_term = tsafe.lin_ellipsoid_safety_distance(p[-1], q[-1], *polys[2:])
    assert np.max(np.abs(d_stage.numpy() - g["d_stage"])) < 1e-4
    assert np.max(np.abs(d_term.numpy() - g["d_term"])) < 1e-4
    y = tl._rollout_lanes_array(
        tssm, _t(g["k_ff_eval"].reshape(t_len, 1)), _t(golden["x0"][:, None]),
        _t(k_fb), _t(a), _t(b), SqpConfig(n_safe=t_len, c_safety=2.5),
        _t(bmat))
    d = tl._dist_lanes(y, t_len, N_S, *polys)[:, 0].numpy()
    ref = np.concatenate([g["d_stage"].reshape(-1), g["d_term"]])
    assert np.max(np.abs(d - ref)) < 1e-4


def test_nlp_closures_match_jax(golden):
    """The single-instance NLP's closures on the cfg2 instance (n_safe 5,
    n_perf 10: the perf trajectory carries the objective), the rollout's
    forward-mode Jacobian and the GN step's y-space derivatives at 1e-10
    (test_torch_bridge.check_nlp_closures)."""
    check_nlp_closures(golden["jexp"], golden["jssm"], golden["texp"],
                       golden["tssm"], golden["x0"], n_safe=5, n_perf=10,
                       r_shared=1)


def test_nlp_planner_meets_the_cfg2_golden(golden):
    """``build_experiment``'s SQP planner (``make_sqp_planner`` at the
    golden's 8 x 4 budget, 14 decision variables) from zeros: feasible
    where the golden was, cost within 1e-3 relative of the golden's
    (tests/test_goldens.py:143-160)."""
    g = np.load(GOLDEN)
    k_ff, feasible, violation, info = golden["texp"]["planner"](
        None, golden["tssm"], _t(g["x0"]),
        torch.zeros((14, 1), dtype=torch.float64))
    assert bool(g["opt_feasible"])
    assert bool(feasible), float(violation)
    scale = abs(float(g["opt_cost"])) + 1e-9
    assert abs(float(info["cost"]) - float(g["opt_cost"])) / scale < 1e-3
    assert k_ff.shape == (5, 1) and info["warm_next"].shape == (14, 1)


def test_cem_plan_with_perf_matches_jax(golden):
    """The portable CEM with a performance trajectory (n_safe 3, n_perf 6,
    r_shared 1 as cartpole_episode has it; M 16, 2 iterations) on the same
    noise, from a state it can hold and one it cannot: flags equal,
    violation at 1e-8, warm_next (the whole decision matrix) at 1e-6."""
    jexp, jssm, tssm = golden["jexp"], golden["jssm"], golden["tssm"]
    spec = jexp["env"].spec
    jcfg = JaxCemConfig(n_safe=3, n_samples=16, n_elites=4, n_iterations=2,
                        n_perf=6, r_shared=1)
    tcfg = CemConfig(n_safe=3, n_samples=16, n_elites=4, n_iterations=2,
                     n_perf=6, r_shared=1)
    k_fb, a, b, _ = _consts(jexp)
    polys = _polys(spec)
    target = np.zeros(N_S)
    flags = []
    for k, x0 in enumerate((np.full(N_S, 0.02), np.array([0.9, 0., 0., 0.]))):
        key = jax.random.PRNGKey(20 + k)
        noise = np.stack([np.asarray(jax.random.normal(kk, (16, 8, 1), F64))
                          for kk in jax.random.split(key, 2)])
        jk, jfeas, jv, ji = jit_once(
            lambda key_, x: jax_cem_plan(
                key_, jssm, x, *(jnp.asarray(v) for v in (k_fb, a, b)),
                spec.u_min, spec.u_max, *(jnp.asarray(v) for v in polys),
                2.0, jax_tracking_cost(jnp.asarray(target)), jcfg),
            key, jnp.asarray(x0))(key, jnp.asarray(x0))
        tk, tfeas, tv, ti = cem_plan(
            None, tssm, _t(x0), *(_t(v) for v in (k_fb, a, b)),
            _t(spec.u_min), _t(spec.u_max), *(_t(v) for v in polys), 2.0,
            tracking_cost(_t(target)), tcfg, noise=_t(noise))
        flags.append(bool(jfeas))
        assert bool(tfeas) == flags[-1]
        assert abs(float(tv) - float(jv)) < 1e-8
        assert ti["warm_next"].shape == (8, 1)
        assert _rel(ti["warm_next"].numpy(), ji["warm_next"]) < 1e-6
        assert _rel(tk.numpy(), jk) < 1e-6
    assert flags == [True, False]


@pytest.fixture(scope="module")
def fleet():
    """run_experiment on cartpole_batch_sqp at a small size (SET: one
    episode of the JAX package's own test's size at a shorter horizon) by
    both packages, the port on the JAX run's draws; the episode's (traj,
    model) recorded on both sides."""
    rec = {"j": [], "t": []}
    with pytest.MonkeyPatch.context() as mp:
        _recorder(mp, jbatch, "run_batched_episodes_lanes", rec["j"])
        _recorder(mp, tbatch, "run_batched_episodes_lanes", rec["t"])
        ref = jax_run_experiment(dataclasses.replace(
            JAX_CONFIGS["cartpole_batch_sqp"], **dataclasses.asdict(CFG)),
            dtype=F64)
        draws = jax_batch_draws(CFG, CFG.batch_lanes, F64, N_S, N_U)
        out = run_experiment(CFG, dtype=torch.float64, device="cpu",
                             draws={k: _t(v) for k, v in draws.items()})
    return ref, out, rec


def test_cartpole_fleet_matches_jax_with_its_draws(fleet):
    """The series' keys and counts equal (0 violations), the model error at
    1e-8; in the episode the feasible flags equal, the states and applied
    controls at 1e-6 (SQP solutions, as in the pendulum fleet test),
    residuals and model errors at 1e-8, and the lane model handed back (3
    appends on 4-D states) at 1e-8."""
    ref, out, rec = fleet
    rs, ts = ref["series"], out["series"]
    assert set(ts) == set(rs)
    for k in ("violations", "feasibility_rate", "lane_backend", "lanes"):
        assert ts[k] == rs[k], k
    assert rs["violations"] == [0]
    np.testing.assert_allclose(ts["model_error"], rs["model_error"],
                               rtol=1e-8, atol=0)
    assert rs["feasibility_rate"] == [1.0]
    assert len(rec["t"]) == len(rec["j"]) == CFG.n_ep
    for (tt, tm), (jt, jm) in zip(rec["t"], rec["j"]):
        np.testing.assert_array_equal(_np(tt["feasible"]), jt["feasible"])
        assert tt["x"].shape == (CFG.batch_lanes, CFG.n_steps, N_S)
        for k, tol in (("x", 1e-6), ("u", 1e-6), ("resid", 1e-8),
                       ("model_err", 1e-8)):
            assert _rel(_np(tt[k]), jt[k]) < tol, k
        for f in ("x", "y", "beta", "kinv"):
            assert _rel(_np(getattr(tm.gp, f)), getattr(jm.gp, f)) < 1e-8, f


def test_cartpole_cli_on_cpu_prints_jax_keys(fleet, capsys):
    """Both cart-pole configurations through the CLI on the CPU: the fleet
    at the documented small size (the JAX CLI's keys, 0 violations), and
    cartpole_episode for a few steps."""
    ref, _, _ = fleet
    rc = main(["--config", "cartpole_batch_sqp", "--device", "cpu", "--set",
               "batch_lanes=3", "n_steps=3", "n_ep=1", "n_max=48",
               "n_init_samples=32", "hyp_iters=10", "n_safe=2", "n_perf=4"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == set(ref) - {"config"}
    assert set(summary["series"]) == set(ref["series"])
    assert summary["series"]["violations"] == [0]
    rc = main(["--config", "cartpole_episode", "--device", "cpu", "--set",
               "n_ep=1", "n_steps=2", "n_max=32", "n_init_samples=10",
               "hyp_iters=2", "cem_samples=8", "cem_elites=2",
               "cem_iterations=1"])
    assert rc == 0
    series = json.loads(capsys.readouterr().out)["series"]
    assert series["violations"] == [0] and series["n_data"] == [10]
    assert np.isfinite(series["model_error"]).all()

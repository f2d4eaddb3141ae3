"""PyTorch port: the single-instance safe-MPC NLP (``solvers/sqp.py``)
against the JAX package, on the CPU, in f64.

The JAX-fitted cfg1 golden state (tools/regen_goldens.build_problem
("pendulum", 5): 16 points, n_max 32, the fit and the Lipschitz estimate)
is built once for the module and carried across as numpy arrays; each JAX
program is compiled once and evaluated at every input:

  * ``_build_constraint_fn``'s five closures, the rollout's forward-mode
    Jacobian (the GN path's ``jy``) and the exact path's AL gradient and
    Hessian through the whole tube (forward over reverse) at 1e-10;
  * ``solve_safempc_nlp`` on the Gauss-Newton core with ``opt_k_fb`` (15
    decision variables) at a small budget (2 outer x 2 inner, 1 polish, 1
    rescue outer, 1 extra polish) from a feasible and an infeasible start
    (the gated extra polish off and on): u, lam, g, k_fb_delta and the cost
    at 1e-8, the flags equal;
  * the schedules of both cores, ``solve_al_nlp`` (exact Hessian) and
    ``solve_al_nlp_gn`` with the linearized line search, on a small
    nonconvex NLP with active bounds and constraints, at the same budget
    and tolerance;
  * ``make_sqp_planner`` at the golden's budget against the cfg1 golden's
    ``opt_feasible`` / ``opt_cost`` (the gate of tests/test_goldens.py);
  * the slice as a whole: ``run_experiment`` on ``pendulum_episode_sqp`` at
    a tiny size, fed the JAX runner's draws: counts equal, the float series
    and the final model at 1e-8.

The cart-pole instance (cfg2: n_perf 10, the perf trajectory in the NLP)
is held in tests/test_torch_cartpole.py on that file's cfg2 state, with the
same closure check (``check_nlp_closures``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    build_experiment as jax_build,
)
from safe_exploration_tpu.runtime.episode import (  # noqa: E402
    run_episodic as jax_run_episodic,
)
from safe_exploration_tpu.solvers import sqp as jsqp  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.runtime import episode as tep  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    run_experiment,
)
from safe_exploration_tpu_torch.solvers import sqp as tsqp  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    check_nlp_closures,
    golden_problem,
    jax_episode_draws,
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "goldens", "cfg1_pendulum_h5.npz")
SMALL = dict(n_outer=2, n_inner=2, n_polish=1, n_rescue_outer=1,
             n_polish_extra=1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def cfg1(golden_problem):
    """The JAX-fitted cfg1 golden state and its experiment, built by both
    packages (the port's model from the JAX state's arrays)."""
    jexp, jssm, _, x0, _ = golden_problem("pendulum", 5, 0)
    texp = build_experiment(dataclasses.replace(
        ExperimentConfig(), **dataclasses.asdict(jexp["cfg"])),
        dtype=torch.float64, device="cpu")
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), ("rbf",) * 2,
                            device="cpu")
    return dict(jexp=jexp, jssm=jssm, texp=texp, tssm=tssm,
                x0=np.asarray(x0))


def test_constraint_closures_and_derivatives_match_jax(cfg1):
    """The five closures, ``jy`` and the AL's gradient and Hessian through
    the tube at 1e-10, at two decision vectors."""
    check_nlp_closures(cfg1["jexp"], cfg1["jssm"], cfg1["texp"],
                       cfg1["tssm"], cfg1["x0"], n_safe=5, n_perf=0,
                       r_shared=1, hessians=True)


def _spec_args(spec):
    return (spec.u_min, spec.u_max, spec.h_mat_obs, spec.h_obs,
            spec.h_mat_safe, spec.h_safe)


def test_gn_solve_with_feedback_gains_matches_jax_at_small_budget(cfg1):
    """``solve_safempc_nlp`` (GN core, ``opt_k_fb``: 5 controls + 10 gain
    deltas) at the small budget from the golden x0 (feasible, the gate's
    extra polish off) and from 3 x0 (infeasible at this budget, active
    multipliers, the extra polish on): every output at 1e-8."""
    jexp, texp = cfg1["jexp"], cfg1["texp"]
    cfg = jsqp.SqpConfig(n_safe=5, c_safety=2.0, opt_k_fb=True, **SMALL)
    tcfg = tsqp.SqpConfig(**cfg._asdict())
    jspec, tspec = jexp["env"].spec, texp["env"].spec

    def jax_solve(x0, lam):
        return jsqp.solve_safempc_nlp(
            cfg1["jssm"], x0, jnp.zeros((5, 1), F64), jexp["k_fb"],
            jexp["a"], jexp["b"], *_spec_args(jspec), jexp["cost_fn"], cfg,
            lam_init=lam)

    jax_solve = jit_once(jax_solve, jnp.zeros(2), jnp.zeros(24))

    flags = []
    for scale in (1.0, 3.0):
        x0 = cfg1["x0"] * scale
        lam0 = np.full(24, 0.5)
        jk, jf, jv, ji = jax_solve(jnp.asarray(x0), jnp.asarray(lam0))
        tk, tf, tv, ti = tsqp.solve_safempc_nlp(
            cfg1["tssm"], _t(x0), torch.zeros((5, 1), dtype=torch.float64),
            texp["k_fb"], texp["a"], texp["b"], *_spec_args(tspec),
            texp["cost_fn"], tcfg, lam_init=_t(lam0))
        assert bool(tf) == bool(jf)
        flags.append(bool(jf))
        assert set(ti) == set(ji)
        assert _rel(tk.numpy(), jk) < 1e-8
        assert abs(float(tv) - float(jv)) <= 1e-8 * max(1.0, abs(float(jv)))
        for k in ("warm_next", "lam", "k_fb_delta", "cost",
                  "max_constraint"):
            assert _rel(ti[k].numpy(), ji[k]) < 1e-8, k
    assert flags == [True, False]
    assert np.abs(np.asarray(ji["lam"])).max() > 0.0


# --------------------------------------------------- the cores' schedules
# a small nonconvex NLP whose solve hits the box and the constraints:
#   min 0.5 |u - c|^2 + 0.3 sum sin(2 u),  c = (1.5, 1.2, 0.2)
#   s.t. |u|^2 - 1.2 <= 0,  u_0 u_1 - 0.2 <= 0,  0.5 - u_2 - u_0^2 <= 0

_C = np.array([1.5, 1.2, 0.2])


def _nlp(xp):
    """The NLP's closures in ``xp`` (jnp or torch); outputs and dist_small
    take leading batch dims, as the port's GN core asks."""
    c = xp.asarray(_C) if xp is jnp else _t(_C)

    def outputs(u):
        u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
        return xp.stack([u0, u1, u2, u0 * u1, u0 * u0,
                         xp.sin(2.0 * u0) + xp.sin(2.0 * u1)
                         + xp.sin(2.0 * u2)], -1)

    def cost_small(y, u):
        d = y[:3] - c
        return 0.5 * (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) + 0.3 * y[5]

    def dist_small(y):
        y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
        return xp.stack([y0 * y0 + y1 * y1 + y2 * y2 - 1.2,
                         y[..., 3] - 0.2, 0.5 - y2 - y[..., 4]], -1)

    def objective(u):
        return cost_small(outputs(u), u)

    def constraints(u):
        return dist_small(outputs(u))

    return outputs, cost_small, dist_small, objective, constraints


@pytest.mark.parametrize("core", ["exact", "gn_linearized"])
def test_nlp_cores_match_jax_on_a_small_nlp(core):
    """``solve_al_nlp`` and ``solve_al_nlp_gn`` (linearized line search)
    iterate for iterate at the small budget from two starts, at a 1e-9
    feasibility gate, which the schedule's violation passes at one start
    and not at the other (the gated extra polish runs there): u, lam and g
    at 1e-8."""
    cfg = jsqp.SqpConfig(**SMALL, hessian=core.split("_")[0],
                         linesearch="linearized" if "lin" in core
                         else "exact", feas_tol=1e-9)
    tcfg = tsqp.SqpConfig(**cfg._asdict())
    jo, jc_, jd, jobj, jcon = _nlp(jnp)
    to, tc_, td, tobj, tcon = _nlp(torch)
    lo, hi = np.array([-1.0, -1.0, -0.3]), np.array([1.0, 0.8, 1.0])

    def jax_solve(u0, lam):
        if core == "exact":
            return jsqp.solve_al_nlp(jobj, jcon, u0, jnp.asarray(lo),
                                     jnp.asarray(hi), cfg, lam_init=lam)
        return jsqp.solve_al_nlp_gn(jo, jc_, jd, u0, jnp.asarray(lo),
                                    jnp.asarray(hi), cfg, lam)

    jax_solve = jit_once(jax_solve, jnp.zeros(3), jnp.zeros(3))

    def port_solve(u0, lam0, c):
        if core == "exact":
            return tsqp.solve_al_nlp(tobj, tcon, _t(u0), _t(lo), _t(hi), c,
                                     lam_init=_t(lam0))
        return tsqp.solve_al_nlp_gn(to, tc_, td, _t(u0), _t(lo), _t(hi), c,
                                    _t(lam0))

    gate = []
    for u0 in (np.array([0.2, -0.3, 0.6]), np.array([-0.9, 0.7, -0.2])):
        lam0 = np.zeros(3)
        ju, jl, jg = jax_solve(jnp.asarray(u0), jnp.asarray(lam0))
        tu, tl, tg = port_solve(u0, lam0, tcfg)
        for t, j in ((tu, ju), (tl, jl), (tg, jg)):
            assert _rel(t.numpy(), j) < 1e-8
        assert np.asarray(jl).max() > 0.0
        # the violation the gate reads (the schedule without the extra
        # polish): above feas_tol at one start, below at the other
        _, _, g0 = port_solve(u0, lam0, tcfg._replace(n_polish_extra=0))
        gate.append(float(torch.clamp(g0, min=0.0).sum()))
    assert min(gate) <= cfg.feas_tol < max(gate), gate


def test_exact_core_gates_the_extra_polish_start_by_start():
    """``solve_al_nlp`` on a batch of starts (the static exploration
    planner's bank) with the violation-gated extra polish: the two starts
    above, one gated and one not at a 1e-9 feasibility gate, solved
    together give each start's own solve (u, lam, g at 1e-12)."""
    tcfg = tsqp.SqpConfig(**SMALL, hessian="exact", feas_tol=1e-9)
    _, _, _, tobj, tcon = _nlp(torch)
    lo, hi = _t([-1.0, -1.0, -0.3]), _t([1.0, 0.8, 1.0])
    u0 = _t([[0.2, -0.3, 0.6], [-0.9, 0.7, -0.2]])
    bu, bl, bg = tsqp.solve_al_nlp(tobj, tcon, u0, lo, hi, tcfg)
    gate = []
    for r in range(2):
        su, sl, sg = tsqp.solve_al_nlp(tobj, tcon, u0[r], lo, hi, tcfg)
        for b, s in ((bu[r], su), (bl[r], sl), (bg[r], sg)):
            assert _rel(b.numpy(), s.numpy()) < 1e-12
        _, _, g0 = tsqp.solve_al_nlp(tobj, tcon, u0[r], lo, hi,
                                     tcfg._replace(n_polish_extra=0))
        gate.append(float(torch.clamp(g0, min=0.0).sum()))
    assert min(gate) <= tcfg.feas_tol < max(gate), gate


def test_planner_meets_the_cfg1_golden(cfg1):
    """``build_experiment``'s SQP planner (``make_sqp_planner`` at the
    golden's 8 x 4 budget) from zeros: feasible where the golden was, cost
    within 1e-3 relative of the golden's (tests/test_goldens.py:143-160)."""
    g = np.load(GOLDEN)
    k_ff, feasible, violation, info = cfg1["texp"]["planner"](
        None, cfg1["tssm"], _t(g["x0"]),
        torch.zeros((5, 1), dtype=torch.float64))
    assert bool(g["opt_feasible"])
    assert bool(feasible), float(violation)
    scale = abs(float(g["opt_cost"])) + 1e-9
    assert abs(float(info["cost"]) - float(g["opt_cost"])) / scale < 1e-3
    assert k_ff.shape == (5, 1) and set(info) == {
        "cost", "max_constraint", "warm_next", "lam"}


EPISODE_SET = ["n_ep=1", "n_steps=3", "n_max=32", "n_init_samples=20",
               "hyp_iters=10", "sqp_outer=2", "sqp_inner=2"]


def test_episode_sqp_matches_jax_with_its_draws(monkeypatch):
    """``run_experiment`` on ``pendulum_episode_sqp`` at a tiny size (1
    episode of 3 steps, n_max 32, 20 initial points, a 2 x 2 budget), fed
    the JAX runner's draws (the SQP draws none): the counts equal, the
    model error and mean cost at 1e-8, the final model's factors and
    hyperparameters at 1e-8."""
    runs = []
    run_episodic = tep.run_episodic

    def recorded(*args, **kwargs):
        runs.append(run_episodic(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tep, "run_episodic", recorded)

    cfg = _apply_overrides(CONFIGS["pendulum_episode_sqp"], EPISODE_SET)
    jexp = jax_build(dataclasses.replace(
        JAX_CONFIGS["pendulum_episode_sqp"], **dataclasses.asdict(cfg)),
        dtype=F64)
    ref = jax_run_episodic(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        kern_types=("rbf", "rbf"), l_mu=jexp["l_mu"],
        l_sigma=jexp["l_sigma"], make_ssm=jexp["make_ssm"], n_max=cfg.n_max,
        n_ep=cfg.n_ep, n_steps=cfg.n_steps,
        n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters)
    draws = jax_episode_draws(cfg, 128 * 3)
    series = run_experiment(cfg, dtype=torch.float64, device="cpu",
                            draws={k: _t(v) for k, v in draws.items()}
                            )["series"]
    rs = ref["series"]
    assert set(series) == set(rs)
    for k in ("violations", "feasibility_rate", "n_data"):
        assert series[k] == rs[k], k
    assert rs["violations"] == [0] and rs["n_data"] == [20]
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(series[k], rs[k], rtol=1e-8, atol=0)
    (out,) = runs
    jg, tg = ref["ssm"].gp, out["ssm"].gp
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < 1e-8, f
    assert _rel(tg.log_noise.numpy(), jg.log_noise) < 1e-8

"""Experiment configuration — port of
``safe_exploration_tpu/runtime/config.py``.

:class:`ExperimentConfig` has the JAX package's fields and defaults, and
:data:`CONFIGS` its registry of named configurations, so a name means the
same thing on both sides. :func:`build_experiment` wires what the port
carries: the pendulum, the cart-pole and the planar quadrotor (with or
without a performance trajectory), the exact and the sparse
(inducing-point) GP state-space models and the MC-dropout networks (plain
and concrete), the tracking, exploration and
risk-priced tracking objectives, and the two solvers with the
single-instance and the batched SafeMPC machines — the SQP (the single-instance ``planner`` on
the portable NLP, the batched ``batch_planner`` on the lane SQP, and the
fleet runner's test ``lane_batch_supported``) and the CEM (the
single-instance ``planner`` on the portable or the lane backend, the
batched one on the lane CEM for a shared model inside its envelope, else,
and for every stacked model, on the portable CEM's lane axis). Other
choices raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import partial

import torch

from safe_exploration_tpu_torch import resolve_device
from safe_exploration_tpu_torch.envs import (
    linearize_discretize,
    make_cartpole,
    make_pendulum,
    make_quadrotor,
)
from safe_exploration_tpu_torch.models.gp_lanes import LaneGPSSM
from safe_exploration_tpu_torch.models.nn_ssm import (
    make_mc_dropout_ssm,
    mc_draw_shapes,
)
from safe_exploration_tpu_torch.models.sparse_gp import make_sparse_gp_ssm
from safe_exploration_tpu_torch.models.ssm import GPSSM, make_gp_ssm
from safe_exploration_tpu_torch.ops.linalg import dlqr
from safe_exploration_tpu_torch.solvers.cem import (
    CemConfig,
    cem_plan,
    cem_warm_len,
)
from safe_exploration_tpu_torch.solvers.cem_lanes import (
    cem_lanes_supported,
    make_cem_lane_solver,
)
from safe_exploration_tpu_torch.solvers.costs import (
    exploration_cost,
    risk_tracking_cost,
    tracking_cost,
)
from safe_exploration_tpu_torch.solvers.safempc import (
    SafeMPCConfig,
    make_safempc,
    make_safempc_batch,
)
from safe_exploration_tpu_torch.solvers.sqp import (
    SqpConfig,
    make_sqp_planner,
    shift_duals,
    sqp_n_duals,
    sqp_warm_len,
)
from safe_exploration_tpu_torch.solvers.sqp_lanes import (
    lanes_supported,
    make_sqp_lane_solver,
)

__all__ = ["ExperimentConfig", "CONFIGS", "MC_FAMILIES", "build_experiment",
           "register_config"]

MC_FAMILIES = ("mc_dropout", "mc_dropout_concrete")

ENV_FACTORIES = {"pendulum": make_pendulum, "cartpole": make_cartpole,
                 "quadrotor": make_quadrotor}


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One experiment = env + SSM + solver + runtime schedule (the JAX
    package's fields and defaults; see its docstrings for each knob)."""

    name: str = "pendulum_episode"
    task: str = "episodic"
    batch_lanes: int = 256
    batch_backend: str = "auto"
    env: str = "pendulum"
    solver: str = "cem"
    objective: str = "tracking"
    w_sigma: float = 1.0

    ssm: str = "gp"
    kern_types: tuple = ("rbf", "rbf")
    n_max: int = 512
    m_subset: int = 0
    n_inducing: int = 64
    mc_hidden: tuple = (64, 64)
    mc_samples: int = 16
    l_mu: float = 0.5
    l_sigma: float = 0.25
    log_noise: float = -3.0
    normalize_inputs: bool = True
    precision: str = "f32"

    n_safe: int = 5
    n_perf: int = 0
    r_shared: int = 1
    perf_trajectory: str = "taylor"
    c_safety: float = 2.0
    feas_tol: float = 1e-4
    lqr_w_x: float = 1.0
    lqr_w_u: float = 1.0

    cem_samples: int = 128
    cem_elites: int = 16
    cem_iterations: int = 6
    cem_backend: str = "portable"
    cem_gp_impl: str = "auto"

    sqp_outer: int = 12
    sqp_inner: int = 6
    sqp_polish: int = 3
    sqp_rescue: int = 0
    sqp_polish_extra: int = 0

    n_ep: int = 6
    n_steps: int = 50
    n_init_samples: int = 40
    hyp_iters: int = 120
    seed: int = 0

    def __post_init__(self):
        choices = {
            "batch_backend": ("auto", "lanes", "vmapped"),
            "cem_backend": ("portable", "lanes"),
            "perf_trajectory": ("taylor", "mean_equivalent"),
            "cem_gp_impl": ("auto", "xla", "pallas", "fused"),
        }
        for field, allowed in choices.items():
            if getattr(self, field) not in allowed:
                raise ValueError(
                    f"config '{self.name}': unknown {field} "
                    f"{getattr(self, field)!r} ({'|'.join(allowed)})"
                )


def _require_ported(cfg: ExperimentConfig) -> None:
    """Raise for the choices the port does not carry yet."""
    if cfg.solver not in ("sqp", "cem"):
        raise ValueError(f"unknown solver {cfg.solver!r} (sqp|cem)")
    if cfg.env not in ENV_FACTORIES:
        raise ValueError(f"unknown env {cfg.env!r} ({'|'.join(ENV_FACTORIES)})")
    if cfg.objective not in ("tracking", "exploration", "risk_tracking"):
        raise ValueError(f"unknown objective {cfg.objective!r}")
    if cfg.ssm not in ("gp", "sparse_gp") + MC_FAMILIES:
        raise ValueError(f"unknown ssm family: {cfg.ssm}")


def _warn_ignored_knobs(cfg: ExperimentConfig, ignored: tuple) -> None:
    """Warn when a config sets a knob the selected solver or objective never
    reads away from its default (almost certainly a config bug)."""
    defaults = ExperimentConfig()
    for name in ignored:
        if getattr(cfg, name) != getattr(defaults, name):
            warnings.warn(
                f"config '{cfg.name}': field '{name}'={getattr(cfg, name)!r} "
                f"is ignored by solver='{cfg.solver}'", stacklevel=3)


def _kern_tuple(cfg: ExperimentConfig, n_s: int) -> tuple:
    kt = tuple(cfg.kern_types)
    if len(kt) == 1:
        kt = kt * n_s
    if len(kt) != n_s:
        raise ValueError(f"kern_types has {len(kt)} entries for n_s={n_s}")
    return kt


def build_experiment(cfg: ExperimentConfig, dtype=torch.float32,
                     device=None) -> dict:
    """Wire the experiment on ``device`` (CUDA unless ``"cpu"`` is given;
    raises when CUDA is meant and absent). Returns the single-instance
    ``planner(generator, ssm, x0, warm_mean[, lam], noise=None)`` with its
    SafeMPC machine ``init_state`` / ``get_action`` and the shape of one
    solve's draws ``planner_noise_shape`` (None for the SQP, which draws
    nothing), the batch entries (``batch_planner``,
    ``init_state_batch``, ``get_action_batch``, ``lane_batch_supported``:
    None for the CEM; ``batch_noise_shape``, one lane's draws of the
    batched planner on a stacked model: None for the SQP), ``make_ssm``
    (``make_ssm(xs, us, resid[, init])``; ``init`` the MC-dropout
    network's draws), ``ssm_draw_shapes`` (the draws a first model takes:
    for the MC-dropout networks ``mc_*`` keys as ``mc_draw_shapes``' with
    the prefix, else None), ``env``,
    ``a``, ``b``, ``k_fb``, ``cost_fn``, ``kern_types``, ``l_mu``,
    ``l_sigma`` and ``cfg``."""
    dev = resolve_device(device)
    _require_ported(cfg)
    env = ENV_FACTORIES[cfg.env](dtype=dtype, device=dev)
    spec = env.spec
    kw = {"dtype": dtype, "device": dev}
    mpc_cfg = SafeMPCConfig(n_safe=cfg.n_safe, c_safety=cfg.c_safety,
                            lqr_w_x=cfg.lqr_w_x, lqr_w_u=cfg.lqr_w_u)
    a, b = linearize_discretize(env)
    k_lqr, _ = dlqr(a, b, cfg.lqr_w_x * torch.eye(spec.n_s, **kw),
                    cfg.lqr_w_u * torch.eye(spec.n_u, **kw))
    k_fb = -k_lqr

    if cfg.objective == "tracking":
        cost_fn, cost_args = tracking_cost(spec.target), {"target": spec.target}
    elif cfg.objective == "risk_tracking":
        cost_fn = risk_tracking_cost(spec.target, w_sigma=cfg.w_sigma)
        cost_args = {"target": spec.target, "w_sigma": cfg.w_sigma}
    else:
        cost_fn, cost_args = exploration_cost(), {}
    if cfg.objective != "risk_tracking":
        _warn_ignored_knobs(cfg, ignored=("w_sigma",))
    n_duals, dual_shift = 0, None
    lane_batch_supported = None
    if cfg.solver == "cem":
        _warn_ignored_knobs(cfg, ignored=("sqp_outer", "sqp_inner", "sqp_polish",
                                          "sqp_rescue", "sqp_polish_extra"))
        cem_cfg = CemConfig(
            n_safe=cfg.n_safe, n_samples=cfg.cem_samples,
            n_elites=cfg.cem_elites, n_iterations=cfg.cem_iterations,
            feas_tol=cfg.feas_tol, n_perf=cfg.n_perf, r_shared=cfg.r_shared,
            perf_method=cfg.perf_trajectory, gp_impl=cfg.cem_gp_impl,
        )
        warm_len = cem_warm_len(cem_cfg)
        cem_lane_solver = make_cem_lane_solver(
            env, k_fb, a, b, cfg.c_safety, cfg.objective, cost_args, cem_cfg)

        def batch_planner(ssm, x0s, warm, *, generator=None, noise=None):
            """The lane CEM for a shared model inside its envelope; every
            stacked model (one per lane) and a shared model outside it
            through the portable CEM on a lane axis (the JAX package's
            ``vmap`` of the portable planner). ``generator`` / ``noise``
            replace the JAX package's key (``None``: a fresh generator
            seeded 0); ``noise`` is (n_iterations, M, n_var, B) for the lane
            CEM, (B, n_iterations, M, t_total, n_u) for the portable one."""
            if cem_lanes_supported(ssm, cfg.objective):
                return cem_lane_solver(ssm, x0s, warm, generator=generator,
                                       noise=noise)
            return cem_plan(
                generator, ssm, x0s, k_fb, a, b, spec.u_min, spec.u_max,
                spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
                cfg.c_safety, cost_fn, cem_cfg, warm, noise=noise,
                cost_kind=cfg.objective, cost_args=cost_args)

        n_u = spec.n_u
        batch_noise_shape = (cfg.cem_iterations, cfg.cem_samples, warm_len,
                             n_u)
        # the lane CEM covers the GP families; an MC-dropout network plans
        # through the portable CEM whatever the backend (the JAX package's
        # lane planner falls back to it)
        lane_cem = cfg.cem_backend == "lanes" and cfg.ssm not in MC_FAMILIES
        noise_shape = ((cfg.cem_iterations, cfg.cem_samples, warm_len * n_u, 1)
                       if lane_cem else batch_noise_shape)
        if lane_cem:
            def planner(generator, ssm, x0, warm_mean, noise=None):
                """Single instance through the lane CEM (B = 1)."""
                k_ff, feas, viol, info = batch_planner(
                    ssm, x0[None], warm_mean[None], generator=generator,
                    noise=noise)
                return k_ff[0], feas[0], viol[0], {
                    k: v[0] for k, v in info.items()}
        else:
            def planner(generator, ssm, x0, warm_mean, noise=None):
                """Single instance through the portable CEM."""
                return cem_plan(
                    generator, ssm, x0, k_fb, a, b, spec.u_min, spec.u_max,
                    spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
                    cfg.c_safety, cost_fn, cem_cfg, warm_mean, noise=noise)
    else:
        _warn_ignored_knobs(cfg, ignored=("cem_samples", "cem_elites",
                                          "cem_iterations", "cem_backend"))
        sqp_cfg = SqpConfig(
            n_safe=cfg.n_safe, c_safety=cfg.c_safety,
            n_outer=cfg.sqp_outer, n_inner=cfg.sqp_inner,
            n_polish=cfg.sqp_polish, n_rescue_outer=cfg.sqp_rescue,
            n_polish_extra=cfg.sqp_polish_extra,
            n_perf=cfg.n_perf, r_shared=cfg.r_shared,
            perf_method=cfg.perf_trajectory, feas_tol=cfg.feas_tol,
        )
        planner = make_sqp_planner(env, k_fb, a, b, cost_fn, sqp_cfg)
        warm_len = sqp_warm_len(sqp_cfg)
        n_duals = sqp_n_duals(env, sqp_cfg)
        dual_shift = partial(shift_duals, n_safe=cfg.n_safe,
                             n_obs=spec.h_obs.shape[0])
        lane_solver = make_sqp_lane_solver(
            env, k_fb, a, b, cfg.objective, cost_args, sqp_cfg)

        def batch_planner(ssm, x0s, warm, lam=None):
            if lanes_supported(ssm, sqp_cfg, cfg.objective):
                return lane_solver(ssm, x0s, warm, lam)
            if isinstance(ssm, LaneGPSSM):
                raise TypeError(
                    "per-lane (LaneGPSSM) models require the lane backend; "
                    "this solver configuration is unsupported there "
                    "(opt_k_fb/non-GN/ff-precision), and the portable NLP "
                    "over a stacked model is not ported yet (ROADMAP Queue "
                    "1, item 7)")
            raise NotImplementedError(
                "this model/solver combination needs the portable NLP batched "
                "over a stacked or shared model, which is not ported yet "
                "(ROADMAP Queue 1, item 7)"
            )

        def lane_batch_supported(ssm):
            """Whether the fleet runner rides the lane backend for this
            model: a shared GPSSM (stacked by ``lane_stack_ssm``) or a
            LaneGPSSM, on a configuration the lane SQP covers. A sparse
            model rides the lane batch planner, not the fleet's per-lane
            appends."""
            return (isinstance(ssm, (GPSSM, LaneGPSSM))
                    and lanes_supported(ssm, sqp_cfg, cfg.objective))

        noise_shape = batch_noise_shape = None

    init_state, get_action, _, _ = make_safempc(
        env, mpc_cfg, planner, warm_len=warm_len, n_duals=n_duals,
        dual_shift=dual_shift,
    )
    init_state_batch, get_action_batch = make_safempc_batch(
        env, mpc_cfg, batch_planner, warm_len=warm_len, n_duals=n_duals,
        dual_shift=dual_shift,
    )
    kern_types = _kern_tuple(cfg, spec.n_s)
    l_mu = torch.full((spec.n_s,), cfg.l_mu, **kw)
    l_sigma = torch.full((spec.n_s,), cfg.l_sigma, **kw)

    mc_hidden = tuple(int(h) for h in cfg.mc_hidden)
    ssm_draw_shapes = None
    if cfg.ssm in MC_FAMILIES:
        ssm_draw_shapes = {
            f"mc_{k}": v for k, v in mc_draw_shapes(
                spec.n_s + spec.n_u, spec.n_s, hidden=mc_hidden,
                n_samples=cfg.mc_samples).items()}

    def make_ssm(xs, us, resid, init=None):
        """The model factory of this configuration (``cfg.ssm``);
        ``init`` holds an MC-dropout network's draws (``ssm_draw_shapes``'
        keys; ``None``: a CPU generator seeded 0 draws them)."""
        if cfg.ssm in MC_FAMILIES:
            # the MC-dropout network takes raw inputs, as the JAX package's
            return make_mc_dropout_ssm(
                xs, us, resid, n_max=cfg.n_max, l_mu=l_mu, l_sigma=l_sigma,
                hidden=mc_hidden, n_samples=cfg.mc_samples,
                log_noise=cfg.log_noise,
                concrete=cfg.ssm == "mc_dropout_concrete",
                draws=None if init is None else {
                    k[len("mc_"):]: v for k, v in init.items()})
        z_scale = (torch.cat([spec.norm_x, spec.norm_u])
                   if cfg.normalize_inputs else None)
        if cfg.ssm == "sparse_gp":
            return make_sparse_gp_ssm(
                kern_types, xs, us, resid, n_max=cfg.n_max,
                n_inducing=cfg.n_inducing, l_mu=l_mu, l_sigma=l_sigma,
                log_noise=cfg.log_noise, z_scale=z_scale)
        return make_gp_ssm(
            kern_types, xs, us, resid, n_max=cfg.n_max, l_mu=l_mu,
            l_sigma=l_sigma, log_noise=cfg.log_noise, z_scale=z_scale,
            precision=cfg.precision, m_subset=cfg.m_subset or None,
        )

    return {
        "env": env,
        "a": a,
        "b": b,
        "k_fb": k_fb,
        "cost_fn": cost_fn,
        "planner": planner,
        "planner_noise_shape": noise_shape,
        "batch_noise_shape": batch_noise_shape,
        "init_state": init_state,
        "get_action": get_action,
        "batch_planner": batch_planner,
        "init_state_batch": init_state_batch,
        "get_action_batch": get_action_batch,
        "lane_batch_supported": lane_batch_supported,
        "kern_types": kern_types,
        "make_ssm": make_ssm,
        "ssm_draw_shapes": ssm_draw_shapes,
        "l_mu": l_mu,
        "l_sigma": l_sigma,
        "cfg": cfg,
    }


# --- named configurations: the JAX package's registry, entry for entry ----

CONFIGS: dict[str, ExperimentConfig] = {}


def register_config(cfg: ExperimentConfig) -> ExperimentConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


for _cfg in (
    ExperimentConfig(name="pendulum_episode"),
    ExperimentConfig(name="pendulum_episode_sqp", solver="sqp"),
    ExperimentConfig(name="pendulum_episode_mcdropout", ssm="mc_dropout"),
    ExperimentConfig(name="pendulum_episode_concrete",
                     ssm="mc_dropout_concrete"),
    ExperimentConfig(name="pendulum_episode_sparse", ssm="sparse_gp",
                     n_inducing=32),
    ExperimentConfig(name="pendulum_large_sparse", solver="sqp",
                     ssm="sparse_gp", n_max=10240, n_inducing=256,
                     c_safety=1.8, n_ep=6, n_steps=50, n_init_samples=1024,
                     hyp_iters=60),
    ExperimentConfig(name="pendulum_serve", task="serve", solver="sqp",
                     sqp_outer=4, sqp_inner=3, n_steps=40, n_max=256),
    ExperimentConfig(name="pendulum_exploration", task="exploration",
                     objective="exploration", n_safe=3, n_steps=1),
    ExperimentConfig(name="pendulum_exploration_static",
                     task="exploration_static", solver="sqp", n_safe=3,
                     n_steps=1, sqp_outer=8, sqp_inner=4),
    ExperimentConfig(name="pendulum_batch", task="batch", batch_lanes=256,
                     n_safe=3, n_max=128, n_steps=20, n_init_samples=24,
                     n_ep=1, cem_samples=64, cem_elites=12, cem_iterations=4),
    ExperimentConfig(name="pendulum_batch_sqp", task="batch",
                     batch_backend="lanes", solver="sqp", batch_lanes=256,
                     n_safe=3, n_max=128, n_steps=20, n_init_samples=24,
                     n_ep=4, sqp_outer=4, sqp_inner=3),
    ExperimentConfig(name="cartpole_episode", env="cartpole",
                     kern_types=("rbf",), n_safe=10, n_perf=10, c_safety=2.0,
                     cem_samples=192),
    ExperimentConfig(name="cartpole_episode_sqp", env="cartpole",
                     kern_types=("rbf",), solver="sqp", n_safe=10, n_perf=10,
                     r_shared=2, c_safety=2.0),
    ExperimentConfig(name="cartpole_risk_sqp", env="cartpole",
                     kern_types=("rbf",), solver="sqp",
                     objective="risk_tracking", w_sigma=5.0, n_safe=10,
                     n_perf=10, r_shared=2, c_safety=2.0,
                     perf_trajectory="taylor"),
    ExperimentConfig(name="cartpole_batch_sqp", task="batch",
                     batch_backend="lanes", env="cartpole",
                     kern_types=("rbf",), solver="sqp", batch_lanes=128,
                     n_safe=6, n_perf=10, r_shared=2, c_safety=2.0, n_max=128,
                     n_steps=16, n_init_samples=40, n_ep=4, sqp_outer=4,
                     sqp_inner=3),
    ExperimentConfig(name="quadrotor_episode", env="quadrotor",
                     kern_types=("rbf",), n_safe=5, n_perf=12, c_safety=1.5,
                     cem_samples=256),
    ExperimentConfig(name="quadrotor_batch_sqp", task="batch",
                     batch_backend="lanes", env="quadrotor",
                     kern_types=("rbf",), solver="sqp", batch_lanes=64,
                     n_safe=3, n_perf=5, r_shared=1, n_max=96, c_safety=1.5,
                     n_steps=8, n_init_samples=40, n_ep=2, log_noise=-4.5,
                     sqp_outer=4, sqp_inner=3),
    ExperimentConfig(name="pendulum_uncertainty", task="uncertainty",
                     n_steps=20),
):
    register_config(_cfg)

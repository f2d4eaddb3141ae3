"""Helpers the port's CPU tests share (no tests here): a JAX GPSSM's (and
SparseGPSSM's) state as numpy arrays, the JAX side of the bridge whose PyTorch side is
``safe_exploration_tpu_torch.models.convert``; the JAX runners' initial-data,
Lipschitz-region, episode and fleet draws rebuilt from their keys; the
safe-MPC NLP's closures held against JAX's on one instance; one torch
thread; and JAX's persistent compilation cache, shared by a session's
workers."""

import dataclasses
import os
import pickle
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _share_compilations():
    """JAX's persistent compilation cache in one directory per test
    session, shared by its xdist workers (``PYTEST_XDIST_TESTRUNUID``)
    and kept across the modules whose in-memory caches the conftest
    clears: a program the JAX references compile again (the same runner
    in another module or worker, the same small op elsewhere) is read
    back instead of compiled. It changes no result: an entry is keyed by
    the program, its compile options and the JAX version, and an entry
    read while another worker still writes it is compiled afresh (with a
    warning)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", f"pid{os.getpid()}")
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        tempfile.gettempdir(), f"safe_exploration_jax_cache_{run}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


_share_compilations()


def jax_gpssm_to_numpy(ssm) -> dict:
    gp = ssm.gp
    return {
        "x": np.asarray(gp.x), "y": np.asarray(gp.y),
        "mask": np.asarray(gp.mask),
        "params": [{k: np.asarray(v) for k, v in p.items()}
                   for p in gp.params],
        "log_noise": np.asarray(gp.log_noise), "chol": np.asarray(gp.chol),
        "beta": np.asarray(gp.beta), "kinv": np.asarray(gp.kinv),
        "head": np.asarray(gp.head), "l_mu": np.asarray(ssm.l_mu),
        "l_sigma": np.asarray(ssm.l_sigma),
        "z_scale": None if ssm.z_scale is None else np.asarray(ssm.z_scale),
    }


def jax_sparse_gpssm_to_numpy(ssm) -> dict:
    """A JAX SparseGPSSM's state as the arrays of
    ``convert.sparse_gpssm_from_numpy``."""
    sgp = ssm.sgp
    out = {k: np.asarray(getattr(sgp, k)) for k in (
        "z", "x", "y", "mask", "log_noise", "luu", "lsig", "alpha", "vmat",
        "head")}
    out.update(
        params=[{k: np.asarray(v) for k, v in p.items()} for p in sgp.params],
        l_mu=np.asarray(ssm.l_mu), l_sigma=np.asarray(ssm.l_sigma),
        z_scale=None if ssm.z_scale is None else np.asarray(ssm.z_scale))
    return out


def jax_init_draws(key, n, dtype=jnp.float64, n_s=2, n_u=1) -> dict:
    """``collect_initial_data``'s draws from its key (JAX
    runtime/episode.py): states and controls uniform on [-1, 1), plant
    noise N(0, 1) per point."""
    kx, ku, kn = jax.random.split(key, 3)
    return {
        "init_x": np.asarray(jax.random.uniform(kx, (n, n_s), dtype, -1.0,
                                                1.0)),
        "init_u": np.asarray(jax.random.uniform(ku, (n, n_u), dtype, -1.0,
                                                1.0)),
        "init_noise": np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (n_s,), dtype))(
                jax.random.split(kn, n))),
    }


def jax_region(n, dtype=jnp.float64, n_s=2, n_u=1):
    """``calibrate_lipschitz``'s region draws from its PRNGKey(0)."""
    kx, ku = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.uniform(kx, (n, n_s), dtype)),
            np.array(jax.random.uniform(ku, (n, n_u), dtype)))


def _mc_p_dtype(keep_prob, dtype, concrete):
    """The dtype of the JAX MC model's keep probability, which its dropout
    uniforms take: the plain variant's ``jnp.asarray(keep_prob)`` (f64
    under x64), the concrete variant's weights' dtype."""
    return dtype if concrete else jnp.asarray(keep_prob).dtype


def jax_mc_uniforms(mask_key, widths, n_samples, p_dtype) -> list:
    """The S passes' dropout uniforms per hidden layer, (S, width), as
    ``nn_ssm._dropout_masks`` draws them from ``mask_key``:
    fold_in(fold_in(mask_key, s), layer)."""
    return [np.asarray(jax.vmap(lambda s, i=i, w=w: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(mask_key, s), i), (w,),
        p_dtype))(jnp.arange(n_samples))) for i, w in enumerate(widths)]


def jax_mc_init_draws(key, dims, n_samples, dtype=jnp.float64,
                      concrete=False, keep_prob=0.9) -> dict:
    """``make_mc_dropout_ssm``'s draws from its key as the port's
    ``mc_draw_shapes`` keys: the weights' standard normals ``w{i}`` and the
    prediction uniforms ``u{i}``."""
    k_init, k_mask = jax.random.split(key)
    out = {}
    for i in range(len(dims) - 1):
        k_init, kw = jax.random.split(k_init)
        out[f"w{i}"] = np.asarray(jax.random.normal(
            kw, (dims[i], dims[i + 1]), dtype))
    us = jax_mc_uniforms(k_mask, dims[1:-1], n_samples,
                         _mc_p_dtype(keep_prob, dtype, concrete))
    out.update({f"u{i}": u for i, u in enumerate(us)})
    return out


def jax_mc_fit_draws(key, iters, widths, n_max, dtype=jnp.float64,
                     concrete=False, keep_prob=0.9) -> list:
    """``mc_fit``'s draws from its key, per hidden layer: the plain
    variant's one mask a step (iters, width), from fold_in(fold_in(k, 0),
    layer); the concrete variant's per point (iters, n_max, width) on (1e-6,
    1 - 1e-6), from fold_in(fold_in(k, point), layer); k the step's key."""
    p_dtype = _mc_p_dtype(keep_prob, dtype, concrete)

    def step(k):
        if not concrete:
            return [jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(k, 0), i), (w,), p_dtype)
                for i, w in enumerate(widths)]
        return [jax.vmap(lambda j, i=i, w=w: jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k, j), i), (w,), dtype,
            1e-6, 1.0 - 1e-6))(jnp.arange(n_max))
            for i, w in enumerate(widths)]

    return [np.asarray(u) for u in jax.jit(jax.vmap(step))(
        jax.random.split(key, iters))]


def jax_mc_to_numpy(ssm) -> dict:
    """A JAX McDropoutSSM's state as the arrays of
    ``convert.mc_dropout_ssm_from_numpy``, its prediction uniforms drawn
    from its ``mask_key``."""
    from safe_exploration_tpu.models.nn_ssm import _layer_keep_probs

    widths = [w.shape[1] for w, _ in ssm.weights[:-1]]
    p_dtype = _layer_keep_probs(ssm)[0].dtype
    return {
        "n_s": ssm.n_s, "n_samples": ssm.n_samples,
        "keep_prob": ssm.keep_prob,
        "weights": [(np.asarray(w), np.asarray(b)) for w, b in ssm.weights],
        "mask_u": jax_mc_uniforms(ssm.mask_key, widths, ssm.n_samples,
                                  p_dtype),
        "keep_logit": None if ssm.keep_logit is None
        else np.asarray(ssm.keep_logit),
        **{k: np.asarray(getattr(ssm, k)) for k in (
            "log_noise", "l_mu", "l_sigma", "x", "y", "mask", "head")},
    }


def jax_mc_draws(cfg, key, dtype=jnp.float64, n_s=2, n_u=1) -> dict:
    """An MC-dropout configuration's model draws as the port's draws keys:
    the first model's (``mc_w{i}``, ``mc_u{i}``) from ``key`` (the
    runner's model key) and the fit's (``mc_fit{i}``) from ``ssm_fit``'s
    PRNGKey(0), at max(hyp_iters, 200) steps."""
    dims = (n_s + n_u,) + tuple(int(h) for h in cfg.mc_hidden) + (n_s,)
    concrete = cfg.ssm == "mc_dropout_concrete"
    out = {f"mc_{k}": v for k, v in jax_mc_init_draws(
        key, dims, cfg.mc_samples, dtype, concrete).items()}
    fit = jax_mc_fit_draws(jax.random.PRNGKey(0), max(cfg.hyp_iters, 200),
                           dims[1:-1], cfg.n_max, dtype, concrete)
    out.update({f"mc_fit{i}": u for i, u in enumerate(fit)})
    return out


def jax_episode_draws(cfg, n_region, plan=None, dtype=jnp.float64, n_s=2,
                      n_u=1) -> dict:
    """The JAX episodic runner's draws as numpy arrays, rebuilt from its key
    splits (runtime/episode.py: run_episodic, collect_initial_data,
    rollout_episode; calibrate_lipschitz's PRNGKey(0)) for a plant of n_s
    states and n_u controls (the pendulum's by default). ``plan(k_plan)``
    gives one solve's planner draws (the CEM's); without it the run has
    none (the SQP draws nothing). An MC-dropout configuration adds its
    model's draws (:func:`jax_mc_draws`, from the runner's model key)."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, k_ssm, key = jax.random.split(key, 3)
    draws = jax_init_draws(k_init, cfg.n_init_samples, dtype, n_s, n_u)
    if cfg.ssm.startswith("mc_dropout"):
        draws.update(jax_mc_draws(cfg, k_ssm, dtype, n_s, n_u))
    draws["region_x"], draws["region_u"] = jax_region(n_region, dtype, n_s,
                                                      n_u)
    reset, plans, step = [], [], []
    for _ in range(cfg.n_ep):
        k_reset, k_roll, key = jax.random.split(key, 3)
        reset.append(np.asarray(jax.random.normal(k_reset, (n_s,), dtype)))
        pl, st = [], []
        for k in jax.random.split(k_roll, cfg.n_steps):
            k_plan, k_step = jax.random.split(k)
            if plan is not None:
                pl.append(plan(k_plan))
            st.append(np.asarray(jax.random.normal(k_step, (n_s,), dtype)))
        plans.append(pl)
        step.append(np.stack(st))
    draws.update(reset=np.stack(reset), step=np.stack(step))
    if plan is not None:
        draws["plan"] = np.stack([np.stack(pl) for pl in plans])
    return draws


def jax_batch_draws(cfg, lanes, dtype=jnp.float64, n_s=2, n_u=1,
                    plan=None) -> dict:
    """The JAX CLI's batch-task draws as numpy arrays, rebuilt from its key
    splits (runtime/main.py's batch task: for n_ep = 1 one episode from its
    third key's states and its fourth key's lane keys, else
    runtime/batch.py's run_batched_learning). ``plan(k_plan)`` gives one
    lane's planner draws of a step (the stacked runner's CEM); without it
    the run has none."""
    k1, _, k3, key = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    draws = jax_init_draws(k1, cfg.n_init_samples, dtype, n_s, n_u)
    draws["region_x"], draws["region_u"] = jax_region(128 * (n_s + n_u),
                                                      dtype, n_s, n_u)

    def lane_steps(k_roll):         # (n_steps, B, n_s) [, (n_steps, B, ...)]
        steps, plans = [], []
        for k_lane in jax.random.split(k_roll, lanes):
            pairs = [jax.random.split(k)
                     for k in jax.random.split(k_lane, cfg.n_steps)]
            steps.append(np.stack([np.asarray(jax.random.normal(
                k_step, (n_s,), dtype)) for _, k_step in pairs]))
            if plan is not None:
                plans.append(np.stack([plan(k_plan) for k_plan, _ in pairs]))
        return (np.stack(steps, axis=1),
                None if plan is None else np.stack(plans, axis=1))

    if cfg.n_ep == 1:
        step, plans = lane_steps(key)
        draws.update(
            reset=np.asarray(jax.random.normal(k3, (lanes, n_s), dtype))[None],
            step=step[None])
        if plan is not None:
            draws["plan"] = plans[None]
        return draws
    reset, step, plans = [], [], []
    for _ in range(cfg.n_ep):
        key, k_reset, k_roll = jax.random.split(key, 3)
        reset.append(np.stack([
            np.asarray(jax.random.normal(k, (n_s,), dtype))
            for k in jax.random.split(k_reset, lanes)]))
        st, pl = lane_steps(k_roll)
        step.append(st)
        plans.append(pl)
    draws.update(reset=np.stack(reset), step=np.stack(step))
    if plan is not None:
        draws["plan"] = np.stack(plans)
    return draws


@pytest.fixture(scope="session")
def golden_problem(tmp_path_factory):
    """``tools/regen_goldens.build_problem`` (the JAX-fitted golden state,
    f64) built once per test session for an exact-GP instance, however
    many port test files and xdist workers ask for it: the first caller
    builds it (its fit and Lipschitz estimate are most of a golden test
    file's set-up) and leaves its arrays in the session's shared temp
    directory under a file lock; the others rebuild the JAX experiment
    and model from them, value for value. Returns a function with
    build_problem's arguments and results."""
    from safe_exploration_tpu.models import gp as jgp
    from safe_exploration_tpu.models.ssm import GPSSM
    from safe_exploration_tpu.runtime.config import (
        ExperimentConfig,
        build_experiment,
    )

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent              # shared by the session's workers

    def build(env_name, n_safe, n_perf=0, **kw):
        tag = "_".join([env_name, str(n_safe), str(n_perf)] + [
            f"{k}-{v}" for k, v in sorted(kw.items())])
        path = root / f"golden_{tag}.pkl"
        with FileLock(str(path) + ".lock"):
            if not path.exists():
                sys.path.insert(0, os.path.join(_REPO, "tools"))
                try:
                    from regen_goldens import build_problem
                finally:
                    sys.path.pop(0)
                exp, ssm, probes, x0, k_ff = build_problem(
                    env_name, n_safe, n_perf, **kw)
                with open(path, "wb") as f:
                    pickle.dump({"cfg": dataclasses.asdict(exp["cfg"]),
                                 "ssm": jax_gpssm_to_numpy(ssm),
                                 "rest": [np.asarray(v)
                                          for v in (probes, x0, k_ff)]}, f)
            with open(path, "rb") as f:
                data = pickle.load(f)
        exp = build_experiment(ExperimentConfig(**data["cfg"]),
                               dtype=jnp.float64)
        a = data["ssm"]
        gp = jgp.GP(
            kern_types=exp["kern_types"],
            params=tuple({k: jnp.asarray(v) for k, v in p.items()}
                         for p in a["params"]),
            head=jnp.asarray(a["head"], jnp.int32),
            **{k: jnp.asarray(a[k]) for k in ("x", "y", "mask", "log_noise",
                                              "chol", "beta", "kinv")})
        ssm = GPSSM(gp=gp, l_mu=jnp.asarray(a["l_mu"]),
                    l_sigma=jnp.asarray(a["l_sigma"]),
                    z_scale=None if a["z_scale"] is None
                    else jnp.asarray(a["z_scale"]))
        return (exp, ssm, *(jnp.asarray(v) for v in data["rest"]))

    return build


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run tiny lane batches: one intra-op thread is as
    fast and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# XLA options for the tests' one-off JAX programs: the LLVM backend's
# optimization off (each program runs a few times on tiny inputs, and its
# compile is most of its cost)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_once(fn, *args):
    """``fn`` jit-compiled for ``args``' shapes with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)



def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def check_nlp_closures(jexp, jssm, texp, tssm, x0, *, n_safe, n_perf,
                       r_shared, hessians=False, tol=1e-10):
    """The safe-MPC NLP's closures (``solvers/sqp._build_constraint_fn``:
    objective, constraints, outputs, cost_small, dist_small) of both
    packages on one instance (experiments built by each, the port's model
    from the JAX one's arrays) at the zero and at a random decision vector,
    each JAX program compiled once: the values, the rollout's Jacobian
    ``jy`` as the GN step takes it (``_rollout_jacobian``, against JAX's
    ``jacfwd``), the y-space derivatives the GN step takes (dist_small's
    Jacobian, cost_small's gradient and Hessian in (y, u)) and, with
    ``hessians``, the augmented Lagrangian's gradient and Hessian through
    the whole tube, all at ``tol`` relative."""
    from safe_exploration_tpu.solvers import sqp as jsqp
    from safe_exploration_tpu_torch.solvers import sqp as tsqp

    def t64(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    cfg = jsqp.SqpConfig(n_safe=n_safe, n_perf=n_perf, r_shared=r_shared,
                         c_safety=jexp["cfg"].c_safety)
    js, ts = jexp["env"].spec, texp["env"].spec
    jfns = jsqp._build_constraint_fn(
        jssm, jnp.asarray(x0), jnp.tile(jexp["k_fb"][None], (n_safe, 1, 1)),
        jexp["a"], jexp["b"], cfg, js.h_mat_obs, js.h_obs, js.h_mat_safe,
        js.h_safe, jexp["cost_fn"])
    tfns = tsqp._build_constraint_fn(
        tssm, t64(x0), texp["k_fb"].expand(n_safe, *texp["k_fb"].shape),
        texp["a"], texp["b"], tsqp.SqpConfig(**cfg._asdict()), ts.h_mat_obs,
        ts.h_obs, ts.h_mat_safe, ts.h_safe, texp["cost_fn"])
    jobj, jcon, jout, jcost, jdist = jfns
    tobj, tcon, tout, tcost, tdist = tfns
    n_var = jsqp.sqp_warm_len(cfg) * js.n_u
    n_con = jcon(jnp.zeros(n_var)).shape[0]

    def jcost_yu(yu, ny):
        return jcost(yu[:ny], yu[ny:])

    def tcost_yu(yu, ny):
        return tcost(yu[:ny], yu[ny:])

    def jal(u, lam, mu):
        s = jnp.maximum(lam + mu * jcon(u), 0.0)
        return jobj(u) + jnp.sum(s * s - lam * lam) / (2.0 * mu)

    def tal(u, lam, mu):
        s = torch.maximum(lam + mu * tcon(u), torch.zeros(()))
        return tobj(u) + torch.sum(s * s - lam * lam) / (2.0 * mu)

    def jax_side(u, lam):
        y = jout(u)
        ny = y.shape[0]
        out = {"objective": jobj(u), "constraints": jcon(u), "outputs": y,
               "cost_small": jcost(y, u), "dist_small": jdist(y),
               "jy": jax.jacfwd(jout)(u), "gy": jax.jacfwd(jdist)(y),
               "f_yu": jax.grad(jcost_yu)(jnp.concatenate([y, u]), ny),
               "h_yu": jax.hessian(jcost_yu)(jnp.concatenate([y, u]), ny)}
        if hessians:
            out["al_grad"] = jax.grad(jal)(u, lam, 50.0)
            out["al_hess"] = jax.hessian(jal)(u, lam, 50.0)
        return out

    rng = np.random.default_rng(7)
    jax_side = jit_once(jax_side, jnp.zeros(n_var), jnp.zeros(n_con))
    for u in (np.zeros(n_var), 0.1 * rng.standard_normal(n_var)):
        lam = np.maximum(rng.standard_normal(n_con), 0.0)
        ref = jax_side(jnp.asarray(u), jnp.asarray(lam))
        tu, y = t64(u), t64(ref["outputs"])
        ny = y.shape[0]
        yu = torch.cat([y, tu])
        got = {"objective": tobj(tu), "constraints": tcon(tu),
               "outputs": tout(tu), "cost_small": tcost(y, tu),
               "dist_small": tdist(y),
               "jy": tsqp._rollout_jacobian(tout, tu, ny)[0],
               "gy": torch.func.jacfwd(tdist)(y),
               "f_yu": torch.func.grad(tcost_yu)(yu, ny),
               "h_yu": torch.func.hessian(tcost_yu)(yu, ny)}
        if hessians:
            got["al_grad"] = torch.func.grad(tal)(tu, t64(lam), 50.0)
            got["al_hess"] = torch.func.hessian(tal)(tu, t64(lam), 50.0)
        assert set(got) == set(ref)
        for k, v in got.items():
            assert v.shape == ref[k].shape, k
            assert _rel(v.numpy(), ref[k]) < tol, (k, _rel(v.numpy(), ref[k]))

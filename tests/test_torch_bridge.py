"""Helpers the port's CPU tests share (no tests here): a JAX GPSSM's (and
SparseGPSSM's) state as numpy arrays, the JAX side of the bridge whose PyTorch side is
``safe_exploration_tpu_torch.models.convert``; the JAX runners' initial-data,
Lipschitz-region, episode and fleet draws rebuilt from their keys; the
safe-MPC NLP's closures held against JAX's on one instance; and one torch
thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


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


def jax_episode_draws(cfg, n_region, plan=None, dtype=jnp.float64, n_s=2,
                      n_u=1) -> dict:
    """The JAX episodic runner's draws as numpy arrays, rebuilt from its key
    splits (runtime/episode.py: run_episodic, collect_initial_data,
    rollout_episode; calibrate_lipschitz's PRNGKey(0)) for a plant of n_s
    states and n_u controls (the pendulum's by default). ``plan(k_plan)``
    gives one solve's planner draws (the CEM's); without it the run has
    none (the SQP draws nothing)."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, _, key = jax.random.split(key, 3)
    draws = jax_init_draws(k_init, cfg.n_init_samples, dtype, n_s, n_u)
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


def jax_batch_draws(cfg, lanes, dtype=jnp.float64, n_s=2, n_u=1) -> dict:
    """The JAX CLI's batch-task draws as numpy arrays, rebuilt from its key
    splits (runtime/main.py's batch task: for n_ep = 1 one
    run_batched_episodes_lanes episode from its third key's states and its
    fourth key's lane keys, else runtime/batch.py's run_batched_learning)."""
    k1, _, k3, key = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    draws = jax_init_draws(k1, cfg.n_init_samples, dtype, n_s, n_u)
    draws["region_x"], draws["region_u"] = jax_region(128 * (n_s + n_u),
                                                      dtype, n_s, n_u)

    def lane_steps(k_roll):                             # (n_steps, B, n_s)
        return np.stack([
            np.stack([np.asarray(jax.random.normal(
                jax.random.split(k)[1], (n_s,), dtype))
                for k in jax.random.split(k_lane, cfg.n_steps)])
            for k_lane in jax.random.split(k_roll, lanes)], axis=1)

    if cfg.n_ep == 1:
        draws.update(
            reset=np.asarray(jax.random.normal(k3, (lanes, n_s), dtype))[None],
            step=lane_steps(key)[None])
        return draws
    reset, step = [], []
    for _ in range(cfg.n_ep):
        key, k_reset, k_roll = jax.random.split(key, 3)
        reset.append(np.stack([
            np.asarray(jax.random.normal(k, (n_s,), dtype))
            for k in jax.random.split(k_reset, lanes)]))
        step.append(lane_steps(k_roll))
    draws.update(reset=np.stack(reset), step=np.stack(step))
    return draws


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

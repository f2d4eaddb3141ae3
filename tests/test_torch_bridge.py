"""Helpers the port's CPU tests share (no tests here): a JAX GPSSM's state
as numpy arrays, the JAX side of the bridge whose PyTorch side is
``safe_exploration_tpu_torch.models.convert``; the JAX runners' initial-data,
Lipschitz-region and fleet draws rebuilt from their keys; and one torch
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


def jax_batch_draws(cfg, lanes, dtype=jnp.float64, n_s=2, n_u=1) -> dict:
    """The JAX CLI's batch-task draws as numpy arrays, rebuilt from its key
    splits (runtime/main.py's batch task, runtime/batch.py's
    run_batched_learning and run_batched_episodes_lanes)."""
    k1, _, _, key = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    draws = jax_init_draws(k1, cfg.n_init_samples, dtype, n_s, n_u)
    draws["region_x"], draws["region_u"] = jax_region(128 * (n_s + n_u),
                                                      dtype, n_s, n_u)
    reset, step = [], []
    for _ in range(cfg.n_ep):
        key, k_reset, k_roll = jax.random.split(key, 3)
        reset.append(np.stack([
            np.asarray(jax.random.normal(k, (n_s,), dtype))
            for k in jax.random.split(k_reset, lanes)]))
        per_lane = [
            np.stack([np.asarray(jax.random.normal(
                jax.random.split(k)[1], (n_s,), dtype))
                for k in jax.random.split(k_lane, cfg.n_steps)])
            for k_lane in jax.random.split(k_roll, lanes)]
        step.append(np.stack(per_lane, axis=1))         # (n_steps, B, n_s)
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

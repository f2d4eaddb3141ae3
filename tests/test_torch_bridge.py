"""Helpers the port's CPU tests share (no tests here): a JAX GPSSM's state
as numpy arrays, the JAX side of the bridge whose PyTorch side is
``safe_exploration_tpu_torch.models.convert``; the JAX runners' initial-data
and Lipschitz-region draws rebuilt from their keys; and one torch thread."""

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


def jax_init_draws(key, n, dtype=jnp.float64) -> dict:
    """``collect_initial_data``'s draws from its key (JAX
    runtime/episode.py): states and controls uniform on [-1, 1), plant
    noise N(0, 1) per point."""
    kx, ku, kn = jax.random.split(key, 3)
    return {
        "init_x": np.asarray(jax.random.uniform(kx, (n, 2), dtype, -1.0, 1.0)),
        "init_u": np.asarray(jax.random.uniform(ku, (n, 1), dtype, -1.0, 1.0)),
        "init_noise": np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (2,), dtype))(
                jax.random.split(kn, n))),
    }


def jax_region(n, dtype=jnp.float64):
    """``calibrate_lipschitz``'s region draws from its PRNGKey(0)."""
    kx, ku = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.uniform(kx, (n, 2), dtype)),
            np.array(jax.random.uniform(ku, (n, 1), dtype)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run tiny lane batches: one intra-op thread is as
    fast and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""PyTorch port: the MC-dropout network family (``models/nn_ssm.py``)
against the JAX package, on the CPU.

  * the dropout masks the port derives from JAX's uniforms equal JAX's
    ``_dropout_masks``, both variants, f32 and f64;
  * ``predict_latent`` and the closed-form mean Jacobian at 1e-10 against
    JAX's ``predict_latent`` and ``jacfwd`` (and ``torch.func.jacfwd``);
  * ``mc_fit`` on JAX's step draws, 200 steps at n_max 64, hidden (16, 16):
    the weights (and the concrete variant's keep logits) at 1e-8;
  * the ring buffer's appends exactly, and the SSM entries' dispatch;
  * ``calibrate_lipschitz`` on the fitted model at 1e-8.

The two configurations' episodes and the other tasks with an MC model are
in tests/test_torch_mcdropout_episode.py (a file of its own, so that
pytest-xdist, which hands files out by their test counts, starts the long
JAX files first). In f64 unless stated. The JAX programs are compiled once
with FAST_COMPILE (the bridge's ``jit_once``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import nn_ssm as jnn  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu_torch.models import nn_ssm as tnn  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    mc_dropout_ssm_from_numpy,
    mc_dropout_ssm_to_numpy,
)
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_mc_fit_draws,
    jax_mc_to_numpy,
    jax_region,
    jit_once,
    one_torch_thread,
)

N_MAX, HIDDEN, S = 64, (16, 16), 8
VARIANTS = ["plain", "concrete"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _data(dtype, n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    u = rng.uniform(-1, 1, (n, 1))
    y = np.stack([0.3 * np.sin(x[:, 0]) + 0.1 * u[:, 0], 0.2 * x[:, 1] ** 2],
                 axis=1)
    return tuple(jnp.asarray(v, dtype) for v in (x, u, y))


def _jax_model(variant, dtype=jnp.float64):
    x, u, y = _data(dtype)
    return jnn.make_mc_dropout_ssm(
        jax.random.PRNGKey(3), x, u, y, n_max=N_MAX,
        l_mu=jnp.full((2,), 0.5, dtype), l_sigma=jnp.full((2,), 0.3, dtype),
        hidden=HIDDEN, n_samples=S, concrete=variant == "concrete")


def _port(jm, dtype=torch.float64):
    return mc_dropout_ssm_from_numpy(jax_mc_to_numpy(jm), device="cpu",
                                     dtype=dtype)


@pytest.fixture(scope="module")
def fitted():
    """Each variant's JAX model, fitted by JAX for 200 steps from
    PRNGKey(0), the port's fit of the same start on JAX's draws, and the
    JAX fit's draws."""
    out = {}
    for variant in VARIANTS:
        jm = _jax_model(variant)
        jfit = jit_once(lambda s: jnn.mc_fit(s, jax.random.PRNGKey(0),
                                             iters=200), jm)(jm)
        draws = jax_mc_fit_draws(jax.random.PRNGKey(0), 200, HIDDEN, N_MAX,
                                 concrete=variant == "concrete")
        tfit = tnn.mc_fit(_port(jm), iters=200,
                          draws=[torch.tensor(d) for d in draws])
        out[variant] = (jm, jfit, tfit)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_masks_equal_jax(variant, dtype):
    jm = _jax_model(variant, getattr(jnp, dtype))
    tm = _port(jm, getattr(torch, dtype))
    ref = jax.vmap(lambda s: jnp.stack(jnn._dropout_masks(jm, s)))(
        jnp.arange(S))                                     # (S, layers, w)
    got = torch.stack(tnn.dropout_masks(tm), dim=1)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_and_mean_jacobian_match_jax(fitted, variant):
    _, jfit, tfit = fitted[variant]
    z = np.random.default_rng(1).uniform(-1.0, 1.0, (6, 3))
    ref = jit_once(lambda zz: (jax.vmap(jfit.predict_latent)(zz),
                               jax.vmap(jax.jacfwd(
                                   lambda q: jfit.predict_latent(q)[0]))(zz)),
                   jnp.asarray(z))(jnp.asarray(z))
    (jmu, jvar), jjac = ref
    tz = torch.tensor(z)
    mu, var = tfit.predict_latent(tz)
    mu2, var2, jac = tnn.mc_predict_mean_jac(tfit, tz)
    for got, want in ((mu, jmu), (var, jvar), (mu2, jmu), (var2, jvar),
                      (jac, jjac)):
        assert _rel(got.numpy(), want) < 1e-10
    auto = torch.func.vmap(torch.func.jacfwd(
        lambda q: tfit.predict_latent(q)[0]))(tz)
    assert _rel(jac.numpy(), auto.numpy()) < 1e-10
    # the SSM entry: raw inputs split over state and control, batched
    mu3, _, jx, ju = tssm.ssm_predict_jac(tfit, tz[:, :2].reshape(2, 3, 2),
                                          tz[:, 2:].reshape(2, 3, 1))
    assert jx.shape == (2, 3, 2, 2) and ju.shape == (2, 3, 2, 1)
    assert _rel(torch.cat([jx, ju], -1).reshape(6, 2, 3).numpy(), jjac) \
        < 1e-10
    assert _rel(mu3.reshape(6, 2).numpy(), jmu) < 1e-10


@pytest.mark.parametrize("variant", VARIANTS)
def test_fit_matches_jax_on_its_draws(fitted, variant):
    """200 Adam steps (adamw for the plain variant, adam plus the concrete
    regularizer for the concrete one) on JAX's draws."""
    jm, jfit, tfit = fitted[variant]
    for (tw, tb), (jw, jb), (w0, _) in zip(tfit.weights, jfit.weights,
                                           jm.weights):
        assert _rel(tw.numpy(), jw) < 1e-8
        assert _rel(tb.numpy(), jb) < 1e-8
        assert _rel(jw, w0) > 1e-3                   # the fit moved them
    if variant == "concrete":
        assert _rel(tfit.keep_logit.numpy(), jfit.keep_logit) < 1e-8
        assert _rel(jfit.keep_logit, jm.keep_logit) > 1e-6
    else:
        assert tfit.keep_logit is None


def test_ring_buffer_and_dispatch_match_jax():
    """mc_update_data / ssm_update: appends below capacity, a wrap, and a
    batch larger than the buffer, exactly as JAX's; the SSM entries'
    dispatch (n_points, probe points, bucketed view, no append); new
    prediction uniforms from mc_resample."""
    jm = _jax_model("plain")
    tm = _port(jm)
    rng = np.random.default_rng(2)
    for k in (10, 30, 70):
        x, u, y = (rng.standard_normal((k, d)) for d in (2, 1, 2))
        jm = jssm.ssm_update(jm, jnp.asarray(x), jnp.asarray(u),
                             jnp.asarray(y))
        tm = tssm.ssm_update(tm, torch.tensor(x), torch.tensor(u),
                             torch.tensor(y))
        for f in ("x", "y", "mask"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)))
        assert tm.head == int(jm.head)
        assert int(tssm.ssm_n_points(tm)) == int(jssm.ssm_n_points(jm))
    assert tssm.ssm_probe_points(tm) is tm.x
    assert tssm.ssm_bucketed(tm) is tm
    with pytest.raises(TypeError, match="exact-GP"):
        tssm.ssm_append_point(tm, torch.zeros(2), torch.zeros(1),
                              torch.zeros(2))
    fresh = tnn.mc_resample(tm, torch.Generator().manual_seed(1))
    for u, v in zip(fresh.mask_u, tm.mask_u):
        assert u.shape == v.shape and u.dtype == v.dtype
        assert not torch.equal(u, v)
    back = mc_dropout_ssm_to_numpy(tm)
    again = mc_dropout_ssm_from_numpy(back, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        (again.x, again.y, again.mask, *again.mask_u),
        (tm.x, tm.y, tm.mask, *tm.mask_u)))


@pytest.mark.parametrize("variant", VARIANTS)
def test_calibration_matches_jax(fitted, variant):
    """calibrate_lipschitz over the padded buffer and the region's probes
    (the torch.func Hessians and std gradients of the MC mean and std)."""
    _, jfit, tfit = fitted[variant]
    jspec = jax_build(JaxConfig(), dtype=jnp.float64)["env"].spec
    tspec = build_experiment(ExperimentConfig(), dtype=torch.float64,
                             device="cpu")["env"].spec
    ref = jit_once(lambda s: jssm.calibrate_lipschitz(s, jspec), jfit)(jfit)
    rx, ru = jax_region(128 * 3)
    got = tssm.calibrate_lipschitz(
        tfit, tspec, n_region=rx.shape[0],
        draws=(torch.tensor(rx), torch.tensor(ru)))
    assert _rel(got.l_mu.numpy(), ref.l_mu) < 1e-8
    assert _rel(got.l_sigma.numpy(), ref.l_sigma) < 1e-8

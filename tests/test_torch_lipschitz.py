"""PyTorch port: the Lipschitz remainder's dominant eigenvalue and box
half-widths against the JAX package, f64 on the CPU (1e-10 relative).

Split from tests/test_torch_reachability.py, whose fixtures it takes, so
that each file's test count (pytest-xdist hands files out by it) places
it well in the tier-1 run's schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.ops import lipschitz as jlip  # noqa: E402
from safe_exploration_tpu_torch.ops import lipschitz as tlip  # noqa: E402
from test_torch_bridge import one_torch_thread  # noqa: E402,F401
from test_torch_reachability import (  # noqa: E402,F401
    _psd,
    _rel,
    _t,
    prior,
)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_max_eig_psd_product_matches_jax(n):
    rng = np.random.default_rng(n)
    m = _psd(rng, n, (6,)) @ _psd(rng, n, (6,))
    ref = jax.vmap(jlip.max_eig_psd_product)(jnp.asarray(m))
    assert _rel(tlip.max_eig_psd_product(_t(m)).numpy(), ref) < 1e-10


def test_remainder_overapproximations_match_jax(prior):
    _, _, k_fb = prior
    rng = np.random.default_rng(3)
    q = _psd(rng, 2, (5,))
    l_mu, l_sigma = np.array([0.05, 0.07]), np.array([0.02, 0.03])
    ref = jax.vmap(lambda qq: jlip.compute_remainder_overapproximations(
        qq, jnp.asarray(k_fb), jnp.asarray(l_mu), jnp.asarray(l_sigma)))(
            jnp.asarray(q))
    out = tlip.compute_remainder_overapproximations(
        _t(q), _t(k_fb), _t(l_mu), _t(l_sigma))
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10

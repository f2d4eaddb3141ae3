"""PyTorch port: the pendulum's prior (a, b) and LQR gain against the JAX
package, f64 on the CPU.

Split from tests/test_torch_slice.py, whose fixture it takes, so that each
file's test count (pytest-xdist hands files out by it) places it well in
the tier-1 run's schedule.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import one_torch_thread  # noqa: E402,F401
from test_torch_slice import (  # noqa: E402,F401
    _rel,
    exps,
)


def test_prior_and_lqr_gain_match_jax(exps):
    jexp, texp = exps
    for k in ("a", "b", "k_fb"):
        assert _rel(texp[k].numpy(), jexp[k]) < 1e-12, k

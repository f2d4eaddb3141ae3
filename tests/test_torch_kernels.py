"""PyTorch port: the refit kernels' plain versions against the JAX package,
the kernels against their plain versions on the GPU, and the port's import
guards.

On the CPU the wrappers take the plain PyTorch versions, which are held
against the JAX refit functions (``_masked_gram``, ``jnp.linalg.cholesky``,
``solve_triangular``) and against the Pallas kernels in interpret mode, as
tests/test_pallas.py runs them: f64 at 1e-9 relative, f32 within 2e-4 of the
f64 result (the gate test_pallas uses for the f32 Pallas Cholesky). The
large-matrix tier ``cholesky_hbm_plain`` is held against the HBM-tier Pallas
kernel in interpret mode at test_pallas's sizes (n=640 in f32 within 3e-4 of
the f64 factor, n=384 in f64 at 1e-9) and against ``jnp.linalg.cholesky`` at
a ragged n=300. The CUDA kernels themselves are tested on a GPU by
tests/test_torch_cuda.py.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models.gp import _masked_gram  # noqa: E402
from safe_exploration_tpu.ops.pallas import (  # noqa: E402
    cholesky_blocked as pallas_cholesky,
    rbf_gram_masked as pallas_gram,
    solve_psd_blocked as pallas_solve_psd,
    trsm_lower_blocked as pallas_trsm,
)
from safe_exploration_tpu.ops.pallas.cholesky_hbm import (  # noqa: E402
    cholesky_hbm as pallas_cholesky_hbm,
)
from test_torch_bridge import one_torch_thread  # noqa: E402,F401
from safe_exploration_tpu_torch.ops.kernels import (  # noqa: E402
    cholesky_blocked,
    cholesky_hbm,
    cholesky_hbm_plain,
    cholesky_plain,
    gram_plain,
    rbf_gram_masked,
    solve_psd,
    solve_psd_plain,
    tri_inv_lower,
    tri_inv_plain,
    trsm_lower,
    trsm_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "safe_exploration_tpu_torch")
E = 2   # output dims, as on the refit path


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _gram_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3))
    mask = (np.arange(n) < n - 5).astype(np.float64)   # ragged valid prefix
    log_ls = rng.normal(0.0, 0.3, (E, 3))
    log_sf = np.array([-0.2, 0.1])
    log_noise = 0.5 * np.log([3e-2, 5e-2])
    return x, mask, log_ls, log_sf, log_noise


def _spd(n, seed=1):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((E, n, n))
    return m @ np.swapaxes(m, 1, 2) + n * np.eye(n)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("n", [64, 130])
def test_gram_plain_matches_jax_and_pallas(n):
    x, mask, log_ls, log_sf, log_noise = _gram_inputs(n)
    k = gram_plain(*(_t(a) for a in (x, mask, log_ls, log_sf,
                                     log_noise))).numpy()
    noise = np.exp(2.0 * log_noise)
    for d in range(E):
        params = {"log_lengthscales": jnp.asarray(log_ls[d]),
                  "log_sf": jnp.asarray(log_sf[d])}
        ref = _masked_gram("rbf", params, jnp.asarray(x), jnp.asarray(mask),
                           jnp.asarray(noise[d]))
        assert _rel(k[d], ref) < 1e-9
        pal = pallas_gram(params, jnp.asarray(x), jnp.asarray(mask),
                          jnp.asarray(noise[d]), interpret=True)
        assert _rel(k[d], pal) < 1e-9


@pytest.mark.parametrize("n", [64, 130])
def test_gram_plain_f32_close_to_f64(n):
    args = _gram_inputs(n)
    k64 = gram_plain(*(_t(a) for a in args)).numpy()
    k32 = gram_plain(*(_t(a, torch.float32) for a in args)).numpy()
    assert _rel(k32, k64) < 2e-4


@pytest.mark.parametrize("n", [64, 130])
def test_cholesky_plain_matches_jax_and_pallas(n):
    a = _spd(n)
    l = cholesky_plain(_t(a)).numpy()
    assert _rel(l, jnp.linalg.cholesky(jnp.asarray(a))) < 1e-9
    assert _rel(l, pallas_cholesky(jnp.asarray(a), interpret=True)) < 1e-9
    np.testing.assert_array_equal(np.triu(l[0], 1), 0.0)


@pytest.mark.parametrize("n", [64, 130])
def test_cholesky_plain_f32_close_to_f64(n):
    a = _spd(n)
    l64 = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    l32 = cholesky_plain(_t(a, torch.float32)).numpy()
    np.testing.assert_allclose(l32, l64, rtol=2e-4, atol=2e-4)


def test_cholesky_plain_nan_on_indefinite():
    """A non-positive pivot gives NaN and does not raise — as
    jnp.linalg.cholesky and the Pallas kernel (torch.linalg.cholesky would
    raise, which is why the plain version is a column loop)."""
    a = _spd(64)
    a[:, 40, 40] = -1.0
    l = cholesky_plain(_t(a)).numpy()
    assert np.isnan(l).any()
    assert np.isfinite(l[:, :40, :40]).all()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))).any()
    assert np.isnan(np.asarray(
        pallas_cholesky(jnp.asarray(a), interpret=True))).any()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,m", [(64, 1), (64, 64), (130, 130)])
def test_trsm_plain_matches_jax_and_pallas(n, m, transpose):
    l = np.asarray(jnp.linalg.cholesky(jnp.asarray(_spd(n))))
    b = np.random.default_rng(2).standard_normal((E, n, m))
    x = trsm_plain(_t(l), _t(b), transpose).numpy()
    for d in range(E):
        ref = jax.scipy.linalg.solve_triangular(
            l[d].T if transpose else l[d], b[d], lower=not transpose)
        assert _rel(x[d], ref) < 1e-9
        pal = pallas_trsm(jnp.asarray(l[d]), jnp.asarray(b[d]),
                          transpose=transpose, interpret=True)
        assert _rel(x[d], pal) < 1e-9


@pytest.mark.parametrize("transpose", [False, True])
def test_trsm_plain_f32_close_to_f64(transpose):
    l = np.asarray(jnp.linalg.cholesky(jnp.asarray(_spd(130))))
    b = np.random.default_rng(3).standard_normal((E, 130, 7))
    x64 = trsm_plain(_t(l), _t(b), transpose).numpy()
    x32 = trsm_plain(_t(l, torch.float32), _t(b, torch.float32),
                     transpose).numpy()
    assert _rel(x32, x64) < 2e-4


def test_solve_psd_matches_jax():
    a = _spd(64)
    b = np.random.default_rng(4).standard_normal((E, 64, 3))
    l = cholesky_blocked(_t(a))
    x = solve_psd(l, _t(b)).numpy()
    for d in range(E):
        assert _rel(x[d], np.linalg.solve(a[d], b[d])) < 1e-9


@pytest.mark.parametrize("n", [64, 130])
def test_tri_inv_plain_matches_jax_and_pallas(n):
    """L^-1 (the refit's K^-1 factor) against solve_triangular(L, I) and the
    Pallas trsm in interpret mode at 1e-12 in f64, f32 within 2e-4 of f64;
    exactly zero above the diagonal."""
    l = np.asarray(jnp.linalg.cholesky(jnp.asarray(_spd(n))))
    x = tri_inv_plain(_t(l)).numpy()
    eye = np.eye(n)
    for d in range(E):
        ref = jax.scipy.linalg.solve_triangular(l[d], eye, lower=True)
        assert _rel(x[d], ref) < 1e-12
        pal = pallas_trsm(jnp.asarray(l[d]), jnp.asarray(eye), interpret=True)
        assert _rel(x[d], pal) < 1e-12
    np.testing.assert_array_equal(np.triu(x, 1), 0.0)
    x32 = tri_inv_plain(_t(l, torch.float32)).numpy()
    assert _rel(x32, x) < 2e-4


@pytest.mark.parametrize("n", [64, 130])
def test_solve_psd_plain_matches_jax_and_pallas(n):
    """(L L^T) x = b for the refit's m = 1 against two solve_triangular calls
    and the Pallas solve_psd in interpret mode at 1e-12 in f64, f32 within
    2e-4 of f64."""
    l = np.asarray(jnp.linalg.cholesky(jnp.asarray(_spd(n))))
    b = np.random.default_rng(5).standard_normal((E, n, 1))
    x = solve_psd_plain(_t(l), _t(b)).numpy()
    for d in range(E):
        z = jax.scipy.linalg.solve_triangular(l[d], b[d], lower=True)
        ref = jax.scipy.linalg.solve_triangular(l[d].T, z, lower=False)
        assert _rel(x[d], ref) < 1e-12
        pal = pallas_solve_psd(jnp.asarray(l[d]), jnp.asarray(b[d]),
                               interpret=True)
        assert _rel(x[d], pal) < 1e-12
    x32 = solve_psd_plain(_t(l, torch.float32), _t(b, torch.float32)).numpy()
    assert _rel(x32, x) < 2e-4


@pytest.mark.parametrize("n,dtype", [(640, "float32"), (384, "float64")])
def test_cholesky_hbm_plain_matches_pallas_interpret(n, dtype):
    """test_pallas's HBM-tier cases: f32 within 3e-4 of the f64 factor, f64
    at 1e-9, against the Pallas kernel run in interpret mode."""
    a = _spd(n)[0]
    l64 = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    l = cholesky_hbm_plain(_t(a, getattr(torch, dtype))).numpy()
    pal = np.asarray(pallas_cholesky_hbm(
        jnp.asarray(a, getattr(jnp, dtype)), interpret=True))
    if dtype == "float64":
        assert _rel(l, pal) < 1e-9 and _rel(l, l64) < 1e-9
    else:
        np.testing.assert_allclose(l, l64, rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(pal, l64, rtol=3e-4, atol=3e-4)
    np.testing.assert_array_equal(np.triu(l, 1), 0.0)


def test_cholesky_hbm_plain_ragged_lower_only_and_nan():
    """A ragged n=300 (block columns 64 wide) against jnp.linalg.cholesky;
    the upper triangle is never read; a non-positive pivot gives NaN from
    its column on, finite before it."""
    a = _spd(300)
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    junk = a.copy()
    junk[:, np.triu_indices(300, 1)[0], np.triu_indices(300, 1)[1]] = np.nan
    l = cholesky_hbm_plain(_t(junk)).numpy()
    assert _rel(l, ref) < 1e-9
    a[:, 200, 200] = -1.0
    bad = cholesky_hbm_plain(_t(a)).numpy()
    assert np.isfinite(bad[:, :200, :200]).all()
    assert np.isnan(bad[:, 200:, 200]).all() and np.isnan(bad[:, -1, -1]).all()


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers are the plain versions and count no
    kernel launch."""
    wrappers = (rbf_gram_masked, cholesky_blocked, trsm_lower, solve_psd,
                tri_inv_lower, cholesky_hbm)
    before = [w.launches for w in wrappers]
    args = [_t(a) for a in _gram_inputs(40)]
    k = rbf_gram_masked(*args)
    torch.testing.assert_close(k, gram_plain(*args), rtol=0, atol=0)
    l = cholesky_blocked(k)
    torch.testing.assert_close(l, cholesky_plain(k), rtol=0, atol=0)
    torch.testing.assert_close(cholesky_hbm(k), cholesky_hbm_plain(k), rtol=0,
                               atol=0)
    b = torch.ones((E, 40, 2), dtype=torch.float64)
    torch.testing.assert_close(trsm_lower(l, b, True), trsm_plain(l, b, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(solve_psd(l, b), solve_psd_plain(l, b), rtol=0,
                               atol=0)
    torch.testing.assert_close(tri_inv_lower(l), tri_inv_plain(l), rtol=0,
                               atol=0)
    assert [w.launches for w in wrappers] == before


# ------------------------------------------------------------ guards


_BANNED = ("jax", "jaxlib", "flax", "optax", "safe_exploration_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_neither_jax_nor_the_jax_package():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _BANNED, (path, name)


def test_import_builds_nothing_and_loads_no_triton_or_jax(tmp_path):
    from safe_exploration_tpu_torch.ops.kernels import _build

    def listing():
        d = _build.BUILD_DIR
        return set(os.listdir(d)) if os.path.isdir(d) else None

    code = (
        "import sys\n"
        "import safe_exploration_tpu_torch\n"
        "import safe_exploration_tpu_torch.runtime.config\n"
        "import safe_exploration_tpu_torch.models.convert\n"
        "bad = [m for m in ('triton', 'jax') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    before = listing()
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert listing() == before


def test_build_experiment_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    from safe_exploration_tpu_torch import resolve_device
    from safe_exploration_tpu_torch.runtime.config import (
        ExperimentConfig,
        build_experiment,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        build_experiment(ExperimentConfig(solver="sqp"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"

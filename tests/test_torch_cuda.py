"""PyTorch port: the CUDA kernels against their plain versions on the GPU.

Every test here is marked ``cuda`` and skips, inside the test, when no GPU
is present (the kernels have no CPU mode). The file imports neither JAX nor
the JAX package, so on a machine with a GPU and no JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: f64 at 1e-10 relative; f32 gram at 1e-5; f32 cholesky and trsm
within 2e-4 of the f64 plain result (the gate tests/test_pallas.py uses for
the f32 Pallas Cholesky).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu_torch.ops.kernels import (  # noqa: E402
    cholesky_blocked,
    cholesky_plain,
    gram_plain,
    rbf_gram_masked,
    solve_psd,
    trsm_lower,
    trsm_plain,
)

E = 2   # output dims, as on the refit path


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _gram_args(n, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-1.0, 1.0, (n, 3)),
              (np.arange(n) < n - 5).astype(np.float64),
              rng.normal(0.0, 0.3, (E, 3)), np.array([-0.2, 0.1]),
              np.array([3e-2, 5e-2]))
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [128, 200, 512, 1024])
def test_cuda_kernels_match_plain(n, dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    f64 = dt == torch.float64
    kc = rbf_gram_masked(*_gram_args(n, dt, "cuda"))
    assert _rel(kc, gram_plain(*_gram_args(n, dt))) < (1e-10 if f64 else 1e-5)
    k64 = gram_plain(*_gram_args(n, torch.float64))
    l64 = cholesky_plain(k64)
    lc = cholesky_blocked(k64.to(dt).cuda())
    assert _rel(lc, l64) < (1e-10 if f64 else 2e-4)
    b64 = torch.tensor(np.random.default_rng(5).standard_normal((E, n, n)))
    for transpose in (False, True):
        xc = trsm_lower(l64.to(dt).cuda(), b64.to(dt).cuda(), transpose)
        assert _rel(xc, trsm_plain(l64, b64, transpose)) < \
            (1e-10 if f64 else 2e-4)
    rhs = b64[..., :1].contiguous()
    xc = solve_psd(l64.cuda(), rhs.cuda())
    assert _rel(xc, trsm_plain(l64, trsm_plain(l64, rhs), True)) < 1e-10


@pytest.mark.cuda
def test_cuda_cholesky_nan_on_indefinite():
    _need_cuda()
    a = gram_plain(*_gram_args(200, torch.float64))
    a[:, 150, 150] = -1.0
    l = cholesky_blocked(a.cuda()).cpu()
    assert torch.isnan(l).any()
    assert torch.isfinite(l[:, :150, :150]).all()


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_reject_bad_input():
    _need_cuda()
    args = _gram_args(64, torch.float32, "cuda")
    before = rbf_gram_masked.launches
    rbf_gram_masked(*args)
    assert rbf_gram_masked.launches == before + 1
    with pytest.raises(TypeError):
        cholesky_blocked(torch.eye(8, dtype=torch.float16, device="cuda"))
    with pytest.raises(ValueError):
        trsm_lower(torch.eye(8, device="cuda"), torch.ones(9, 2, device="cuda"))
    with pytest.raises(ValueError):
        cholesky_blocked(torch.eye(8, device="cuda")[:, ::2])

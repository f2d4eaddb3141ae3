"""PyTorch port: the CUDA kernels against their plain versions on the GPU.

Every test here is marked ``cuda`` and skips, inside the test, when no GPU
is present (the kernels have no CPU mode). The file imports neither JAX nor
the JAX package, so on a machine with a GPU and no JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: f64 at 1e-10 relative; f32 gram at 1e-5; f32 cholesky and trsm
within 2e-4 of the f64 plain result (the gate tests/test_pallas.py uses for
the f32 Pallas Cholesky); f32 gp_predict at 3e-5 of the f32 plain result
(the gate of tests/test_pallas_gp_predict.py); f32 cem_score within 2e-4
of the f64 plain result (the gate of tests/test_pallas_cem_score.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    gpssm_from_numpy,
    gpssm_to_numpy,
)
from safe_exploration_tpu_torch.models.ssm import make_gp_ssm  # noqa: E402
from safe_exploration_tpu_torch.ops.kernels import (  # noqa: E402
    cholesky_blocked,
    cholesky_plain,
    gp_predict_lanes,
    gp_predict_plain,
    gram_plain,
    rbf_gram_masked,
    solve_psd,
    trsm_lower,
    trsm_plain,
    tube_score_lanes,
    tube_score_plain,
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


def _ssm_arrays(n, seed=0):
    """A pendulum-like GP-SSM with n_max n and n - 7 points, as numpy, with
    bench.py's signal std (log_sf -3 against log_noise -4): a Gram that f32
    factors without losing the posterior variance to cancellation."""
    from safe_exploration_tpu_torch.models.gp import gp_refit

    rng = np.random.default_rng(seed)
    k = n - 7
    x = rng.uniform(-1.0, 1.0, (k, 2)) * [0.3, 1.0]
    u = rng.uniform(-1.0, 1.0, (k, 1))
    y = 0.02 * np.sin(3.0 * np.concatenate([x, u], 1) @ rng.normal(size=(3, 2)))
    ssm = make_gp_ssm(("rbf", "rbf"), torch.tensor(x), torch.tensor(u),
                      torch.tensor(y), n_max=n,
                      l_mu=torch.full((2,), 0.05, dtype=torch.float64),
                      l_sigma=torch.full((2,), 0.02, dtype=torch.float64),
                      log_noise=-4.0,
                      z_scale=torch.tensor([0.5, 2.0, 1.0], dtype=torch.float64))
    params = tuple({**p, "log_sf": torch.tensor(-3.0, dtype=torch.float64)}
                   for p in ssm.gp.params)
    return gpssm_to_numpy(ssm.replace(gp=gp_refit(ssm.gp.replace(
        params=params))))


def _gp_args(arr, n_lanes, dtype, device):
    m = arr["mask"]
    rng = np.random.default_rng(3)
    vals = (arr["x"], arr["beta"] * m, arr["kinv"] * m[:, None] * m[None, :],
            np.stack([p["log_lengthscales"] for p in arr["params"]]),
            np.stack([p["log_sf"] for p in arr["params"]]),
            rng.uniform(-1.0, 1.0, (3, n_lanes)))
    return [torch.tensor(np.ascontiguousarray(v), dtype=dtype, device=device)
            for v in vals]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,n_lanes", [(64, 16384), (64, 1000), (200, 1000)])
def test_cuda_gp_predict_matches_plain(n, n_lanes, dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    arr = _ssm_arrays(n)
    before = gp_predict_lanes.launches
    for want_jac in (False, True):
        out = gp_predict_lanes(*_gp_args(arr, n_lanes, dt, "cuda"),
                               want_jac=want_jac)
        ref = gp_predict_plain(*_gp_args(arr, n_lanes, dt, "cpu"),
                               want_jac=want_jac)
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            assert _rel(o, r) < (1e-10 if dt == torch.float64 else 3e-5)
    assert gp_predict_lanes.launches == before + 2


def _plant():
    from safe_exploration_tpu_torch.envs import linearize_discretize, make_pendulum
    from safe_exploration_tpu_torch.ops.linalg import dlqr

    env = make_pendulum(dtype=torch.float64, device="cpu")
    a, b = linearize_discretize(env)
    k_fb = -dlqr(a, b, torch.eye(2, dtype=torch.float64),
                 torch.eye(1, dtype=torch.float64))[0]
    s_lift = torch.cat([torch.eye(2, dtype=torch.float64), k_fb], 0)
    spec = env.spec
    return ([k_fb, a, b, s_lift.T @ s_lift],
            [spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe],
            spec.target)


@pytest.mark.cuda
@pytest.mark.parametrize("cost_kind", ["tracking", "exploration"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,n_lanes", [(64, 1000), (200, 333)])
def test_cuda_cem_score_matches_plain(n, n_lanes, dtype, cost_kind):
    _need_cuda()
    dt = getattr(torch, dtype)
    arr = _ssm_arrays(n, seed=1)
    consts, polys, target = _plant()
    rng = np.random.default_rng(4)
    u = 0.4 * rng.standard_normal((5, n_lanes))
    x0 = rng.uniform(-1.0, 1.0, (2, n_lanes)) * np.array([[0.15], [0.4]])

    def run(fn, device, dtype):
        ssm = gpssm_from_numpy(arr, ("rbf", "rbf"), device=device, dtype=dtype)
        args = {"target": target} if cost_kind == "tracking" else {}
        return fn(ssm, torch.tensor(u, dtype=dtype, device=device),
                  torch.tensor(x0, dtype=dtype, device=device), *consts,
                  *polys, 2.0, 5, cost_kind, args)

    before = tube_score_lanes.launches
    out = run(tube_score_lanes, "cuda", dt)
    assert tube_score_lanes.launches == before + 1
    ref = run(tube_score_plain, "cpu", torch.float64)
    assert (ref[1] > 0).any() and (ref[1] == 0).any()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _rel(o, r) < (1e-10 if dt == torch.float64 else 2e-4)

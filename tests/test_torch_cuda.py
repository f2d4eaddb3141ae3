"""PyTorch port: the CUDA kernels against their plain versions on the GPU.

Every test here is marked ``cuda`` and skips, inside the test, when no GPU
is present (the kernels have no CPU mode). The file imports neither JAX nor
the JAX package, so on a machine with a GPU and no JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: f64 at 1e-10 relative; f32 gram at 1e-5 (and exactly
symmetric in both types); f32 cholesky and
trsm's three entries (trsm_lower, solve_psd, tri_inv_lower) within 2e-4 of
the f64 plain result (the gate tests/test_pallas.py uses for
the f32 Pallas Cholesky); f32 gp_predict at 3e-5 of the f32 plain result
on the same prepared posterior (the gate of
tests/test_pallas_gp_predict.py); f32 cem_score within 2e-4
of the f64 plain result (the gate of tests/test_pallas_cem_score.py), at
the ragged lane counts within twice the plain version's own f32 error (on
the card or the CPU) on the same inputs where that is larger, and so the
model-batched cem_score (one model per group of lanes);
f32 cholesky_hbm within 3e-4 of the f64 plain result (the gate
tests/test_pallas.py uses for the f32 HBM-tier Pallas Cholesky), f64 at
1e-9 (at 1e-9 of ``torch.linalg.cholesky`` for the 64-matrix batch, whose
plain factor would take minutes); the GP refit at n_max 2048 and the
stacked refit of 8 lanes on the GPU against the CPU at 1e-9.
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
    cholesky_hbm,
    cholesky_hbm_plain,
    cholesky_plain,
    gp_predict_lanes,
    gp_predict_plain,
    gp_predict_prepared,
    gram_plain,
    posterior_plain,
    prepare_posterior,
    prepare_tube_score,
    rbf_gram_masked,
    solve_psd,
    solve_psd_plain,
    tri_inv_lower,
    tri_inv_plain,
    trsm_lower,
    trsm_plain,
    tube_score_lanes,
    tube_score_plain,
    tube_score_prepared,
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
              0.5 * np.log([3e-2, 5e-2]))
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
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 200, 2048])
def test_cuda_gram_matches_plain_symmetric_identity_on_padding(n, dtype):
    """The Gram over the lower tile triangle with its mirror: against the
    plain version, exactly symmetric, the identity on the padded rows (the
    last 5, or the only one at n = 1), at every tile edge."""
    _need_cuda()
    dt = getattr(torch, dtype)
    args = _gram_args(n, dt, "cuda", seed=n)
    before = rbf_gram_masked.launches
    k = rbf_gram_masked(*args)
    assert rbf_gram_masked.launches == before + 1
    ref = gram_plain(*args)
    assert _rel(k, ref) < (1e-10 if dt == torch.float64 else 1e-5)
    assert torch.equal(k, k.mT)
    pad = max(0, n - 5) if n > 1 else 0
    eye = torch.eye(n - pad, dtype=dt, device="cuda").expand(E, -1, -1)
    assert torch.equal(k[:, pad:, pad:], eye)
    assert (k[:, pad:, :pad] == 0).all() and (k[:, :pad, pad:] == 0).all()


def _lane_gram_args(lanes, n, dtype, mask_lane, seed=0):
    """The model-batched Gram's arguments on the card: x (L, n, 3); the mask
    (L, n) with per-lane padding or (n,) shared; the hyperparameters
    (L, E, .), one set per model."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(n)[None] < n - 5 - np.arange(lanes)[:, None] % 7
            ).astype(np.float64)
    arrays = (rng.uniform(-1.0, 1.0, (lanes, n, 3)),
              mask if mask_lane else mask[0],
              rng.normal(0.0, 0.3, (lanes, E, 3)),
              rng.normal(-0.2, 0.2, (lanes, E)),
              rng.normal(-1.5, 0.2, (lanes, E)))
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lanes,n", [(256, 128), (2, 2048), (3, 200),
                                     (5, 65), (1, 128)])
@pytest.mark.parametrize("mask_lane", [True, False])
def test_cuda_gram_model_batched_matches_plain(lanes, n, dtype, mask_lane):
    """A leading axis of L models in one launch (the fleet refit's L * E =
    512 Grams at n = 128; L = 2 at n = 2048; ragged n), with per-lane or
    shared masks: against the plain version, exactly symmetric, and each
    model equal to its own single-model launch (L = 1 is today's call)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    args = _lane_gram_args(lanes, n, dt, mask_lane, seed=n + lanes)
    before = rbf_gram_masked.launches
    k = rbf_gram_masked(*args)
    assert rbf_gram_masked.launches == before + 1
    assert k.shape == (lanes, E, n, n)
    assert _rel(k, gram_plain(*args)) < (1e-10 if dt == torch.float64 else 1e-5)
    assert torch.equal(k, k.mT)
    x, mask, log_ls, log_sf, log_noise = args
    for l in sorted({0, lanes - 1}):
        one = rbf_gram_masked(x[l], mask[l] if mask_lane else mask,
                              log_ls[l], log_sf[l], log_noise[l])
        assert torch.equal(k[l], one)
    with pytest.raises(ValueError, match="rbf_gram_masked"):
        rbf_gram_masked(x, mask, log_ls[0], log_sf[0], log_noise[0])


@pytest.mark.cuda
def test_cuda_stacked_refit_matches_cpu():
    """The stacked refit of 8 lanes (per-lane data, masks and
    hyperparameters, n_max 128; then one shared lockstep mask, as the
    fleet's unstack gives): one launch of each refit kernel for all 16
    matrices, every factor within 1e-9 of the CPU's plain versions in
    f64."""
    _need_cuda()
    from safe_exploration_tpu_torch.models.gp import GP, gp_refit

    rng = np.random.default_rng(11)
    lanes, n = 8, 128
    x = rng.uniform(-1.0, 1.0, (lanes, n, 3))
    y = 0.1 * np.sin(3.0 * x[..., :2])
    mask = (np.arange(n)[None] < 100 + np.arange(lanes)[:, None]).astype(float)

    def refit(device, mask=mask):
        t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
        params = tuple({"log_lengthscales": t(rng_p.normal(0.0, 0.2, (lanes, 3))),
                        "log_sf": t(rng_p.normal(-1.0, 0.1, lanes))}
                       for rng_p in (np.random.default_rng(1),
                                     np.random.default_rng(2)))
        z = t(np.zeros((lanes, E, n, n)))
        gp = GP(kern_types=("rbf", "rbf"), x=t(x), y=t(y), mask=t(mask),
                params=params, log_noise=t(np.full((lanes, E), -3.0)),
                chol=z, beta=t(np.zeros((lanes, E, n))), kinv=z, head=n)
        return gp_refit(gp)

    wrappers = (rbf_gram_masked, cholesky_blocked, solve_psd, tri_inv_lower)
    before = [w.launches for w in wrappers]
    g, c = refit("cuda"), refit("cpu")
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(g, f), getattr(c, f)) < 1e-9, f
    g, c = refit("cuda", mask[0]), refit("cpu", mask[0])
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(g, f), getattr(c, f)) < 1e-9, f


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
    eye = torch.eye(8, device="cuda").expand(2, 8, 8).contiguous()
    before = (solve_psd.launches, tri_inv_lower.launches)
    solve_psd(eye, eye[..., :1].contiguous())
    tri_inv_lower(eye)
    assert (solve_psd.launches, tri_inv_lower.launches) == (before[0] + 1,
                                                            before[1] + 1)
    with pytest.raises(ValueError):
        solve_psd(eye, torch.ones(2, 9, 1, device="cuda"))
    with pytest.raises(ValueError):
        tri_inv_lower(torch.ones(2, 8, 9, device="cuda"))
    with pytest.raises(TypeError):
        tri_inv_lower(eye.half())


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
@pytest.mark.parametrize("n_lanes", [1, 256, 1000, 16384])
@pytest.mark.parametrize("n", [64, 128, 200])
def test_cuda_gp_predict_matches_plain(n, n_lanes, dtype):
    """The prepared call against the plain version on the same prepared
    posterior (f64: the plain version in f64 at 1e-10; f32: the plain
    version in f64 on the f32 posterior's values, within 3e-5 or, where
    the plain version in f32 misses that itself on these inputs, twice its
    worse error on the card and on the CPU: sf2 - kv^T W kv cancels, and
    at L = 1 the relative error is the one lane's: 9.9e-5 for the CPU's f32
    plain version at n = 64 with z_scale), W resident (n = 64, 128) and
    streamed (n = 200; n = 128 in f64), with and without z_scale and the
    Jacobian, one launch a call; the raw-array entry (gp_predict_lanes)
    against its plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    arr = _ssm_arrays(n)
    z = torch.tensor(np.random.default_rng(n_lanes).uniform(
        -1.0, 1.0, (3, n_lanes)), dtype=dt, device="cuda")
    before = gp_predict_prepared.launches
    for z_scale in (True, False):
        ssm = gpssm_from_numpy(arr, ("rbf", "rbf"), device="cuda", dtype=dt)
        if not z_scale:
            ssm = ssm.replace(z_scale=None)
        post = prepare_posterior(ssm)
        post64 = post._replace(**{
            f: getattr(post, f).double() for f in post._fields
            if f != "hyper"}, hyper=tuple(h.double() for h in post.hyper))
        post_cpu = post._replace(**{
            f: getattr(post, f).cpu() for f in post._fields
            if f != "hyper"}, hyper=tuple(h.cpu() for h in post.hyper))
        for want_jac in (False, True):
            out = gp_predict_prepared(post, z, want_jac=want_jac)
            ref = posterior_plain(post64, z.double(), want_jac=want_jac)
            plains = (posterior_plain(post, z, want_jac=want_jac),
                      posterior_plain(post_cpu, z.cpu(), want_jac=want_jac))
            assert len(out) == len(ref) == 2 + want_jac
            for k, (o, r) in enumerate(zip(out, ref)):
                assert o.shape == r.shape
                tol = 1e-10 if dt == torch.float64 else max(
                    [3e-5] + [2 * _rel(p[k], r) for p in plains])
                assert _rel(o, r) < tol
    assert gp_predict_prepared.launches == before + 4
    out = gp_predict_lanes(*_gp_args(arr, n_lanes, dt, "cuda"), want_jac=True)
    args = _gp_args(arr, n_lanes, dt, "cpu")
    ref = gp_predict_plain(*(a.double() for a in args), want_jac=True)
    plain = gp_predict_plain(*args, want_jac=True)
    for o, r, p in zip(out, ref, plain):
        tol = 1e-10 if dt == torch.float64 else max(3e-5, 2 * _rel(p, r))
        assert _rel(o, r) < tol
    assert gp_predict_prepared.launches == before + 5


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

    before = tube_score_prepared.launches
    out = run(tube_score_lanes, "cuda", dt)
    assert tube_score_prepared.launches == before + 1
    ref = run(tube_score_plain, "cpu", torch.float64)
    assert (ref[1] > 0).any() and (ref[1] == 0).any()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _rel(o, r) < (1e-10 if dt == torch.float64 else 2e-4)


def _round32(arr):
    """The model's float arrays rounded to f32, as f64 values."""
    def rnd(v):
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            return v.astype(np.float32).astype(np.float64)
        return v

    return {**{k: rnd(v) for k, v in arr.items()},
            "params": [{k: rnd(v) for k, v in p.items()}
                       for p in arr["params"]]}


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_lanes,dtype", [
    (64, 16385, "float32"), (64, 33, "float64"), (66, 33, "float32"),
    (200, 16385, "float64"), (200, 33, "float32"), (512, 16385, "float32"),
    (512, 33, "float64"), (1024, 33, "float32")])
def test_cuda_cem_score_ragged_lanes_resident_and_streamed(n, n_lanes, dtype):
    """Ragged lane counts (one past a block of 64 lanes, and 33) with W
    resident in shared memory (n = 64; n = 66 with its rows padded to 68)
    and streamed (n = 200, 512, 1024;
    blocks of 32 lanes at 512 in f64 and 1024 in f32), both costs, against
    the plain version in f64 on the card, from the same inputs (an f32
    kernel's rounded to f32, as chip_smoke holds it); every fourth lane
    starts at rest and every second is slow, so some lanes keep the
    constraints."""
    _need_cuda()
    dt = getattr(torch, dtype)
    arr = _ssm_arrays(n, seed=1)
    consts, polys, target = _plant()
    rng = np.random.default_rng(n + n_lanes)
    u = 0.4 * rng.standard_normal((5, n_lanes))
    x0 = rng.uniform(-1.0, 1.0, (2, n_lanes)) * np.array([[0.15], [0.4]])
    u[:, ::2] *= 0.1
    x0[:, ::2] *= 0.1
    u[:, ::4] = 0.0
    x0[:, ::4] = 0.0
    ref_arr = arr
    if dt == torch.float32:
        ref_arr, u, x0 = _round32(arr), *(v.astype(np.float32) for v in (u, x0))
    for cost_kind in ("tracking", "exploration"):
        args = {"target": target} if cost_kind == "tracking" else {}

        def run(fn, arrays, dtype, device="cuda"):
            ssm = gpssm_from_numpy(arrays, ("rbf", "rbf"), device=device,
                                   dtype=dtype)
            t = {"dtype": dtype, "device": device}
            return fn(ssm, torch.tensor(u, **t), torch.tensor(x0, **t),
                      *consts, *polys, 2.0, 5, cost_kind, args)

        out = run(tube_score_lanes, arr, dt)
        ref = run(tube_score_plain, ref_arr, torch.float64)
        assert (ref[1] > 0).any() and (ref[1] == 0).any()
        # f32: 2e-4, or where the plain version in f32 misses that itself on
        # these inputs (sqrt(sf2 - quad) loses digits to the cancellation in
        # any order of the sums: 2.3e-4 on the CPU at n = 200, L = 33), twice
        # its worse error on the card and on the CPU
        plain32 = ([run(tube_score_plain, arr, dt, dev) for dev in
                    ("cuda", "cpu")] if dt == torch.float32 else [])
        for k, (o, r) in enumerate(zip(out, ref)):
            assert o.shape == r.shape == (n_lanes,)
            err = _rel(o, r)
            tol = 1e-10 if dt == torch.float64 else max(
                [2e-4] + [2 * _rel(p[k], r) for p in plain32])
            assert err < tol, (cost_kind, err, tol)


def _moved(ssm, **kw):
    """A (stacked) GP-SSM with every tensor moved by ``Tensor.to(**kw)``."""
    def t(v):
        return None if v is None else v.to(**kw)

    gp = ssm.gp
    return ssm.replace(
        gp=gp.replace(
            x=t(gp.x), y=t(gp.y), mask=t(gp.mask),
            params=tuple({k: t(v) for k, v in p.items()} for p in gp.params),
            log_noise=t(gp.log_noise), chol=t(gp.chol), beta=t(gp.beta),
            kinv=t(gp.kinv)),
        l_mu=t(ssm.l_mu), l_sigma=t(ssm.l_sigma), z_scale=t(ssm.z_scale))


def _stacked_model(arr, lanes):
    """``lanes`` distinct models from one model's arrays (f64, CPU): per
    lane its own signal std, noise and Lipschitz constants, refitted."""
    from safe_exploration_tpu_torch.models.gp import gp_refit
    from safe_exploration_tpu_torch.runtime.batch import stack_ssm

    ssm = stack_ssm(gpssm_from_numpy(arr, ("rbf", "rbf"), device="cpu"),
                    lanes)
    frac = (torch.arange(lanes, dtype=torch.float64) % 7) / 7.0
    gp = ssm.gp.replace(
        params=tuple({**p, "log_sf": -3.0 + 0.4 * frac}
                     for p in ssm.gp.params),
        log_noise=(-4.0 - 0.5 * frac)[:, None].expand(lanes, 2).contiguous())
    l_mu = (0.05 * (1.0 + frac))[:, None].expand(lanes, 2).contiguous()
    return ssm.replace(gp=gp_refit(gp), l_mu=l_mu, l_sigma=0.4 * l_mu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lanes,m", [(16, 64), (16, 40), (16, 1), (1, 100)])
def test_cuda_cem_score_model_batched_matches_plain(lanes, m, dtype):
    """The model-batched scorer (model b on lanes b m ... b m + m - 1, one
    launch) against its plain version (the lane chain once per model) in
    f64 on the same (for f32: f32-rounded) inputs, at n = 128 (W streamed),
    H 3, both costs, f64 at 1e-10 and f32 at 2e-4 (or twice the f32 plain
    version's own error); a stack of one model equals the shared model's
    call."""
    _need_cuda()
    from safe_exploration_tpu_torch.models.ssm import ssm_lane

    dt = getattr(torch, dtype)
    model = _moved(_stacked_model(_ssm_arrays(128, seed=2), lanes),
                   dtype=dt, device="cuda")
    ref_model = _moved(model, dtype=torch.float64)
    consts, polys, target = _plant()
    consts, polys = [c.cuda() for c in consts], [p.cuda() for p in polys]
    rng = np.random.default_rng(lanes * m)
    L = lanes * m
    u = torch.tensor(0.4 * rng.standard_normal((3, L)), dtype=dt,
                     device="cuda")
    x0 = torch.tensor(rng.uniform(-1.0, 1.0, (2, L)) * [[0.15], [0.4]],
                      dtype=dt, device="cuda")
    for kind in ("tracking", "exploration"):
        args = (*consts, *polys, 2.0, 3, kind,
                {"target": target.cuda()} if kind == "tracking" else {})
        before = tube_score_prepared.launches
        out = tube_score_prepared(prepare_tube_score(model, *args), u, x0)
        assert tube_score_prepared.launches == before + 1
        ref = tube_score_plain(ref_model, u.double(), x0.double(), *args)
        if L > 50:
            assert (ref[1] > 0).any() and (ref[1] == 0).any()
        # f32: 2e-4, or twice the plain version's own f32 error on these
        # inputs where that is larger (as the ragged-lane test)
        plain32 = ([tube_score_plain(model, u, x0, *args)]
                   if dt == torch.float32 else [])
        for k, (o, r) in enumerate(zip(out, ref)):
            assert o.shape == r.shape == (L,)
            tol = 1e-10 if dt == torch.float64 else max(
                [2e-4] + [2 * _rel(p[k], r) for p in plain32])
            assert _rel(o, r) < tol
        if lanes == 1:
            shared = tube_score_lanes(ssm_lane(model, 0), u, x0, *args)
            for a, b in zip(shared, out):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_cem_plan_lanes_prepares_once_per_solve(monkeypatch):
    """The lane CEM on the card prepares the model once per solve under
    "auto" (the scorer's posterior serves the final passes' gp_predict) and
    "pallas", launches the scorer once per iteration and gp_predict H times
    per pass; the "auto" plan equals that of a solve that prepares anew for
    every scoring call."""
    _need_cuda()
    from safe_exploration_tpu_torch.runtime.config import (
        ExperimentConfig,
        build_experiment,
    )
    from safe_exploration_tpu_torch.solvers import cem_lanes

    exp = build_experiment(ExperimentConfig(
        solver="cem", n_safe=5, n_max=64, cem_samples=64, cem_elites=12,
        cem_iterations=4), dtype=torch.float32, device="cuda")
    ssm = gpssm_from_numpy(_ssm_arrays(64, seed=3), ("rbf", "rbf"),
                           device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(5)
    x0s = torch.tensor(rng.uniform(-1.0, 1.0, (32, 2)) * [0.15, 0.4],
                       dtype=torch.float32, device="cuda")
    warm = torch.zeros((32, 5, 1), dtype=torch.float32, device="cuda")
    noise = torch.tensor(rng.standard_normal((4, 64, 5, 32)),
                         dtype=torch.float32, device="cuda")
    before = (prepare_tube_score.calls, tube_score_prepared.launches,
              prepare_posterior.calls, gp_predict_prepared.launches)
    once = exp["batch_planner"](ssm, x0s, warm, noise=noise)
    # one preparation, a scorer launch per iteration, and gp_predict on the
    # scorer's posterior H times in each of the two final passes
    assert (prepare_tube_score.calls, tube_score_prepared.launches,
            prepare_posterior.calls, gp_predict_prepared.launches) == (
        before[0] + 1, before[1] + 4, before[2] + 1, before[3] + 2 * 5)

    def per_call(prep, u_flat, x0_cols):
        ssm_, *rest = prep.args
        return tube_score_lanes(ssm_, u_flat, x0_cols, *rest)

    monkeypatch.setattr(cem_lanes, "tube_score_prepared", per_call)
    again = exp["batch_planner"](ssm, x0s, warm, noise=noise)
    for a, b in zip(once[:3], again[:3]):
        assert torch.equal(a, b)
    for key in ("cost", "warm_next", "p_traj"):
        assert torch.equal(once[3][key], again[3][key])

    # "pallas": no scorer; the posterior prepared once, gp_predict H times
    # in each of the 4 wide passes and the two final ones
    pallas = build_experiment(ExperimentConfig(
        solver="cem", n_safe=5, n_max=64, cem_samples=64, cem_elites=12,
        cem_iterations=4, cem_gp_impl="pallas"), dtype=torch.float32,
        device="cuda")
    before = (prepare_tube_score.calls, prepare_posterior.calls,
              gp_predict_prepared.launches)
    out = pallas["batch_planner"](ssm, x0s, warm, noise=noise)
    assert (prepare_tube_score.calls, prepare_posterior.calls,
            gp_predict_prepared.launches) == (
        before[0], before[1] + 1, before[2] + (4 + 2) * 5)
    assert all(bool(torch.isfinite(t).all()) for t in out[:3])


def _spd(n, seed=0):
    """(E, n, n) m m^T + n I, the test matrices of tests/test_pallas.py."""
    m = np.random.default_rng(seed).standard_normal((E, n, n))
    return torch.tensor(m @ np.swapaxes(m, 1, 2) + n * np.eye(n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1300, 2048])
def test_cuda_cholesky_hbm_matches_plain(n, dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    a = _spd(n)
    ref = cholesky_hbm_plain(a)
    before = cholesky_hbm.launches
    lc = cholesky_hbm(a.to(dt).cuda())
    assert cholesky_hbm.launches == before + 1
    assert torch.equal(torch.triu(lc, 1), torch.zeros_like(lc))
    if dt == torch.float64:
        assert _rel(lc, ref) < 1e-9
    else:
        torch.testing.assert_close(lc.double().cpu(), ref, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_cuda_cholesky_hbm_nan_on_indefinite_and_lower_only():
    _need_cuda()
    a = _spd(1100)
    a[:, 700, 700] = -1.0
    l = cholesky_hbm(a.cuda()).cpu()
    assert torch.isfinite(l[:, :700, :700]).all()
    assert torch.isnan(l[:, 700:, 700]).all() and torch.isnan(l[:, -1, -1]).all()
    b = _spd(1100, seed=1)
    upper = torch.triu(torch.ones(1100, 1100, dtype=torch.bool), 1)
    ref = cholesky_hbm(b.cuda()).cpu()
    b[:, upper] = float("nan")
    assert torch.equal(cholesky_hbm(b.cuda()).cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(1, "float64"), (64, "float32"),
                                     (65, "float64"), (200, "float32"),
                                     (1025, "float64"), (4096, "float32")])
def test_cuda_cholesky_hbm_edges_match_plain(n, dtype):
    """The panel edges (one column; one whole panel; one column past it; a
    ragged fourth panel), one column past the blocked tier's limit (a last
    panel of one column) and the largest n of chip_smoke's [hbm] phase,
    against the plain version's f64 factor on the card."""
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(n)
    m = torch.randn((E, n, n), dtype=torch.float64, device="cuda", generator=g)
    a = m @ m.mT + n * torch.eye(n, dtype=torch.float64, device="cuda")
    ref = cholesky_hbm_plain(a)
    lc = cholesky_hbm(a.to(dt))
    assert torch.equal(torch.triu(lc, 1), torch.zeros_like(lc))
    if dt == torch.float64:
        assert _rel(lc, ref) < 1e-9
    else:
        torch.testing.assert_close(lc.double(), ref, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_cuda_cholesky_hbm_over_several_waves():
    """64 matrices of n = 1088 in f64 (~600 MB) at once: every launch of
    the panel chain takes several waves of CTAs, so a CTA that read what
    another CTA of its launch wrote would show here; held against
    torch.linalg.cholesky of the same matrices (a reference of this test
    only), every matrix."""
    _need_cuda()
    n, batch = 1088, 64
    g = torch.Generator(device="cuda").manual_seed(n)
    a = torch.empty((batch, n, n), dtype=torch.float64, device="cuda")
    for i in range(0, batch, 16):
        m = torch.randn((16, n, n), dtype=torch.float64, device="cuda",
                        generator=g)
        a[i:i + 16] = m @ m.mT + n * torch.eye(n, dtype=torch.float64,
                                              device="cuda")
        del m
    l = cholesky_hbm(a)
    ref = torch.linalg.cholesky(a)
    assert _rel(l, ref) < 1e-9
    assert torch.equal(torch.triu(l, 1), torch.zeros_like(l))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("at", [703, 704])
def test_cuda_cholesky_hbm_nan_across_a_panel_boundary(at, dtype):
    """A bad pivot in the last column of a panel (703) and in the first of
    the next (704): NaN from its column on, through every later launch;
    finite before it."""
    _need_cuda()
    a = _spd(1100, seed=2)
    a[:, at, at] = -1.0
    l = cholesky_hbm(a.to(getattr(torch, dtype)).cuda()).cpu()
    assert torch.isfinite(l[:, :at, :at]).all()
    assert torch.isnan(l[:, at:, at]).all() and torch.isnan(l[:, -1, -1]).all()
    assert torch.isnan(l[:, at + 64:, at + 64]).all()


@pytest.mark.cuda
def test_cuda_gp_refit_n2048_matches_cpu():
    """The refit at n_max 2048 (the HBM tier) with 1,400 points: every
    factor on the GPU within 1e-9 of the CPU's plain versions, in f64."""
    _need_cuda()
    from safe_exploration_tpu_torch.models.gp import gp_init

    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, (1400, 3))
    y = 0.1 * np.sin(3.0 * x[:, :2])

    def refit(device):
        return gp_init(("rbf", "rbf"), torch.tensor(x, device=device),
                       torch.tensor(y, device=device), n_max=2048,
                       log_noise=-3.0)

    before = (cholesky_hbm.launches, cholesky_blocked.launches)
    g, c = refit("cuda"), refit("cpu")
    assert (cholesky_hbm.launches, cholesky_blocked.launches) == (
        before[0] + 1, before[1])
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(g, f), getattr(c, f)) < 1e-9, f
    eye = torch.eye(2048 - 1400, dtype=torch.float64)
    assert torch.equal(g.chol[:, 1400:, 1400:].cpu(), eye.expand(2, -1, -1))


def _chol64(n, seed=0, pad=0):
    """(E, n, n) f64 lower factors of the test matrices on the card; the last
    ``pad`` rows and columns identity, as the refit's masked padding."""
    a = _spd(n, seed)
    if pad:
        a[:, n - pad:, :] = 0.0
        a[:, :, n - pad:] = 0.0
        a[:, n - pad:, n - pad:] = torch.eye(pad, dtype=torch.float64)
    return cholesky_plain(a.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 31, 33, 128, 200, 512, 2048])
def test_cuda_trsm_entries_match_plain(n, dtype):
    """trsm_lower at m = 1 (the vector kernel), 7 and n, both transposes;
    solve_psd at m = 1 (one launch) and 7; tri_inv_lower zero above the
    diagonal; each against its plain version in f64 on the card."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    l64 = _chol64(n)
    lt = l64.to(dt)
    g = torch.Generator(device="cuda").manual_seed(n)
    for m in sorted({1, 7, n}):
        b = torch.randn((E, n, m), dtype=torch.float64, device="cuda",
                        generator=g)
        for transpose in (False, True):
            x = trsm_lower(lt, b.to(dt), transpose)
            assert _rel(x, trsm_plain(l64, b, transpose)) < tol, (m, transpose)
        if m < n or m == 1:
            x = solve_psd(lt, b.to(dt))
            assert _rel(x, solve_psd_plain(l64, b)) < tol, m
    linv = tri_inv_lower(lt)
    assert _rel(linv, tri_inv_plain(l64)) < tol
    assert torch.equal(torch.triu(linv, 1), torch.zeros_like(linv))


@pytest.mark.cuda
@pytest.mark.parametrize("n,pad", [(200, 57), (2048, 648)])
def test_cuda_tri_inv_identity_on_padded_rows(n, pad):
    """Identity-padded rows and columns of L stay exactly identity in L^-1
    (f32 and f64), as the refit's masked padding needs."""
    _need_cuda()
    l64 = _chol64(n, pad=pad)
    eye = torch.eye(pad, dtype=torch.float64, device="cuda").expand(E, -1, -1)
    for dt in (torch.float32, torch.float64):
        linv = tri_inv_lower(l64.to(dt)).double()
        assert torch.equal(linv[:, n - pad:, n - pad:], eye)
        assert not linv[:, n - pad:, :n - pad].any()
        assert not linv[:, :n - pad, n - pad:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 17, 128, 160, 224, 225, 512, 1024])
def test_cuda_cholesky_tiers_match_plain(n, dtype):
    """Both tiers of cholesky_blocked (shared memory up to n = 224 in f32,
    160 in f64; blocked above) and the tier edges, against the plain
    column loop in f64; zeros above the diagonal; one launch counted."""
    _need_cuda()
    dt = getattr(torch, dtype)
    a = _spd(n, seed=3).cuda()
    before = cholesky_blocked.launches
    l = cholesky_blocked(a.to(dt))
    assert cholesky_blocked.launches == before + 1
    assert _rel(l, cholesky_plain(a)) < (1e-10 if dt == torch.float64 else 2e-4)
    assert torch.equal(torch.triu(l, 1), torch.zeros_like(l))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_cholesky_blocked_tier_over_several_waves(dtype):
    """64 matrices of n = 1024 at once: the blocked tier's strip launches
    take several waves of CTAs, so a CTA that read what another CTA of its
    launch wrote would show here; every 16th and the last matrix against
    the plain column loop in f64."""
    _need_cuda()
    n = 1024
    g = torch.Generator(device="cuda").manual_seed(n)
    m = torch.randn((64, n, n), dtype=torch.float64, device="cuda",
                    generator=g)
    a = m @ m.mT + n * torch.eye(n, dtype=torch.float64, device="cuda")
    l = cholesky_blocked(a.to(getattr(torch, dtype)))
    pick = [0, 16, 32, 48, 63]
    tol = 1e-10 if dtype == "float64" else 2e-4
    assert _rel(l[pick], cholesky_plain(a[pick])) < tol
    assert torch.equal(torch.triu(l, 1), torch.zeros_like(l))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,at", [("float32", 200, 150),
                                        ("float64", 150, 100),
                                        ("float32", 512, 300),
                                        ("float64", 512, 70)])
def test_cuda_cholesky_nan_from_bad_pivot_in_each_tier(dtype, n, at):
    _need_cuda()
    a = _spd(n, seed=4)
    a[:, at, at] = -1.0
    l = cholesky_blocked(a.to(getattr(torch, dtype)).cuda()).cpu()
    assert torch.isfinite(l[:, :at, :at]).all()
    assert torch.isnan(l[:, at:, at]).all() and torch.isnan(l[:, -1, -1]).all()


@pytest.mark.cuda
def test_cuda_episodic_resume_is_bit_exact(tmp_path):
    """A run on the card checkpointed after episode 0 and resumed to 2
    episodes equals the uninterrupted run: the checkpoint's tensors land on
    the card, and the resumed episode runs on the uninterrupted run's
    draws."""
    _need_cuda()
    from safe_exploration_tpu_torch.runtime.config import CONFIGS
    from safe_exploration_tpu_torch.runtime.main import (
        _apply_overrides,
        run_experiment,
    )

    sets = ["n_steps=2", "n_max=32", "n_init_samples=10", "hyp_iters=3",
            "cem_samples=8", "cem_elites=2", "cem_iterations=1"]
    full = _apply_overrides(CONFIGS["pendulum_episode"], sets + ["n_ep=2"])
    part = _apply_overrides(CONFIGS["pendulum_episode"], sets + ["n_ep=1"])
    want = run_experiment(full, out_dir=str(tmp_path / "full"),
                          dtype=torch.float64)["series"]
    run_experiment(part, out_dir=str(tmp_path / "part"), dtype=torch.float64)
    got = run_experiment(full, out_dir=str(tmp_path / "part"),
                         dtype=torch.float64, resume=True)["series"]
    for k in want:
        if k != "episode_time_s":
            assert got[k] == want[k], k

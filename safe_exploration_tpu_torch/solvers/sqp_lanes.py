"""Lane-major batched SafeMPC solver — port of
``safe_exploration_tpu/solvers/sqp_lanes.py``.

The whole solve is written batch-LAST: every per-lane scalar is a ``(B,)``
tensor, the tube's tiny-matrix algebra (ellipsoids, closed-loop maps) is
batch-last ``(n_s, n_s, B)`` einsums, the Newton systems are unrolled over
indices, and the GP contractions are ``(n, B)`` matmuls.

The Gauss-Newton machinery is plain reverse-mode autograd over lane-folded
copies (:func:`_lane_jacobian`): lanes are independent, so evaluating the
rollout on ny copies of the B lanes and pulling back e_k through copy k
gives the per-lane Jacobian ``(n_var, ny, B)`` in one backward pass; the AL
Hessian is the same fold over the gradient (reverse over reverse). No
derivative ever couples two lanes. ``lax.scan`` / ``lax.cond`` become Python
loops and one host ``bool`` for the violation-gated extra polish.

Covered here: a shared :class:`GPSSM`, a shared inducing-point
:class:`SparseGPSSM` (the same lane contractions over its m inducing rows)
or per-lane :class:`LaneGPSSM` (the fleet runner's models, each lane
querying its own posterior through ``models/gp_lanes.lane_predict``) with
the RBF kernel menu, any state dimension (the JAX package's array-form
tube; its scalar unroll at n_s <= 2 is not kept, see
:func:`_rollout_y_lanes`), the joint performance
trajectory (the first ``r_shared`` controls shared with the safety block,
the rest from the free perf tail of the decision vector) with its
covariance recursion where the objective reads it (``want_sigma``), the
tracking, exploration and risk-priced tracking objectives, GN Hessian,
exact line search and fixed feedback gains.

The tube rollout also serves the lane CEM (solvers/cem_lanes.py), which
scores without derivatives: there ``impl="pallas"`` routes the posterior
through the fused CUDA kernel (``ops/kernels/gp_predict.py``), on a
posterior the caller prepares once per model (``post``). The kernel is
forward-only, so the SQP, which differentiates through the posterior, keeps
the plain form, as in the JAX package.

Kinks follow the JAX package: ``max(x, 0)`` is written as
``(x + |x|) / 2`` (:func:`_relu0`), which has JAX's derivative 1/2 at the
tie, where ``torch.clamp`` would give 1.
"""

from __future__ import annotations

from typing import Callable

import torch

from safe_exploration_tpu_torch.models.gp_lanes import (
    _KERNEL_PARTS,
    LaneGPSSM,
    _relu0,
    lane_predict,
)
from safe_exploration_tpu_torch.models.sparse_gp import SparseGPSSM
from safe_exploration_tpu_torch.models.ssm import GPSSM
from safe_exploration_tpu_torch.ops.kernels import (
    gp_of,
    gp_pallas_supported,
    gp_predict_prepared,
    prepare_posterior,
)
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig, _solve_spd_unrolled

__all__ = ["lanes_supported", "gp_pallas_supported", "solve_safempc_lanes",
           "make_sqp_lane_solver"]

# the lane objectives: tracking and exploration read only stage means and
# variances; risk_tracking reads the perf trajectory's covariance, so a new
# Sigma-consuming cost must be added to _wants_sigma as well
_LANE_COSTS = ("tracking", "exploration", "risk_tracking")

# ----------------------------------------------------------------- GP (lanes)


#: the GP state of a lane-capable SSM: the exact :class:`GPSSM`'s or the
#: per-lane :class:`LaneGPSSM`'s ``gp``, the :class:`SparseGPSSM`'s ``sgp``
_gp_of = gp_of


def _gp_predict_lanes(ssm: GPSSM, z: torch.Tensor, *, want_jac: bool,
                      impl: str = "xla", post=None):
    """Posterior mean/var (+ closed-form mean Jacobian) at B query lanes.

    ``z``: (d_in, B) raw state-action inputs. Returns (mu (e, B), var (e, B)
    [, jac (e, d_in, B)]), with the conditioning-aware variance floor and the
    z_scale chain rule of the JAX package. A :class:`SparseGPSSM` runs the
    same body over its m inducing rows: mean weights ``alpha``, the
    quadratic form on ``vmat``, no mask. ``impl="pallas"`` takes the fused
    kernel (forward-only; the name is the JAX package's) on ``post``, the
    model's ``prepare_posterior`` (made here when the caller holds none).
    A :class:`LaneGPSSM` answers each lane from its own model
    (``lane_predict``; z may hold k folded copies of the B lanes).
    """
    if isinstance(ssm, LaneGPSSM):
        if impl == "pallas":
            raise NotImplementedError(
                "the fused posterior kernel covers shared models only")
        return lane_predict(ssm, z, want_jac=want_jac)
    if impl == "pallas":
        if post is None:
            post = prepare_posterior(ssm)
        return gp_predict_prepared(post, z.contiguous(), want_jac=want_jac)
    gp = _gp_of(ssm)
    if isinstance(ssm, SparseGPSSM):
        xr, w_mean, w_var, mask = gp.z, gp.alpha, gp.vmat, None
    else:
        xr, w_mean, w_var, mask = gp.x, gp.beta, gp.kinv, gp.mask
    zz = z if ssm.z_scale is None else z / ssm.z_scale[:, None]
    eps = torch.finfo(zz.dtype).eps
    mus, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        kv = sum(_kv_part_shared(p, params, xr, zz) for p in parts)  # (n, B)
        if mask is not None:
            kv = kv * mask[:, None]
        mus.append(w_mean[d] @ kv)
        kzz = sum(_kzz_part_shared(p, params, zz) for p in parts)
        floor = torch.clamp(8.0 * eps * kzz, min=1e-12)
        vars_.append(torch.maximum(
            kzz - torch.sum(kv * (w_var[d] @ kv), dim=0), floor))
        if want_jac:
            c = w_mean[d] if mask is None else mask * w_mean[d]
            jac = sum(_jac_part_shared(p, params, xr, zz, c) for p in parts)
            if ssm.z_scale is not None:
                jac = jac / ssm.z_scale[:, None]
            jacs.append(jac)
    mu = torch.stack(mus)
    var = torch.stack(vars_)
    if want_jac:
        return mu, var, torch.stack(jacs)
    return mu, var


def _d2_shared(params, x, zz):
    """ARD squared distances (n, B) in the matmul form."""
    ls = torch.exp(params["log_lengthscales"])
    xs = x / ls[None, :]
    zs = zz / ls[:, None]
    return _relu0(
        torch.sum(xs * xs, dim=-1)[:, None]
        + torch.sum(zs * zs, dim=0)[None, :]
        - 2.0 * (xs @ zs)
    )


def _kv_part_shared(part, params, x, zz):
    """One kernel part's cross-covariance k(z_b, X), (n, B)."""
    sf2 = torch.exp(2.0 * params["log_sf"])
    return sf2 * torch.exp(-0.5 * _d2_shared(params, x, zz))


def _kzz_part_shared(part, params, zz):
    """One kernel part's prior variance at the queries, (B,)."""
    return torch.exp(2.0 * params["log_sf"]) * torch.ones_like(zz[0])


def _jac_part_shared(part, params, x, zz, c):
    """One kernel part's weighted-mean input gradient, (d_in, B)."""
    ls = torch.exp(params["log_lengthscales"])
    w = _kv_part_shared("rbf", params, x, zz) * c[:, None]
    return (x.T @ w - zz * torch.sum(w, dim=0)[None, :]) / (ls * ls)[:, None]


# ------------------------------------------------------------- tube (lanes)
# Lane matrices are batch-last tensors (n, n, B), lane vectors (n, B); the
# plant's constants are tensors of the lanes' dtype and device.


def _trace_array(m):
    """Traces of lane matrices (n, n, B) -> (B,)."""
    return torch.diagonal(m, dim1=0, dim2=1).sum(-1)


def _max_eig_lanes_array(m, iters: int = 30):
    """Dominant eigenvalue of lane matrices M = Q B, (n, n, B) -> (B,):
    closed forms at n <= 2, trace-normalized squarings and a Rayleigh
    refinement above."""
    n = m.shape[0]
    if n == 1:
        return _relu0(m[0, 0])
    if n == 2:
        tr = m[0, 0] + m[1, 1]
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        disc = torch.sqrt(_relu0(tr * tr - 4.0 * det))
        return _relu0(0.5 * (tr + disc))
    mn = m / (_trace_array(m) / n + 1e-30)[None, None, :]
    n_sq = 3
    n_refine = max(2, (iters + (1 << n_sq) - 1) // (1 << n_sq))
    for _ in range(n_sq):
        mn = torch.einsum("ikb,kjb->ijb", mn, mn)
        mn = mn / (_trace_array(mn) / n + 1e-30)[None, None, :]
    v0 = 1.0 + 1e-3 * torch.arange(n, dtype=m.dtype, device=m.device)
    v = (v0 / torch.linalg.vector_norm(v0))[:, None].expand(n, m.shape[-1])
    for _ in range(n_refine):
        w = torch.einsum("ijb,jb->ib", mn, v)
        v = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + 1e-30)
    mv = torch.einsum("ijb,jb->ib", m, v)
    num = torch.sum(v * mv, dim=0)
    den = torch.sum(v * v, dim=0) + 1e-30
    return _relu0(num / den)


def _sum_two_ellipsoids_q_array(q1, q2):
    """Shape part of the Minkowski-sum outer approximation on (n, n, B)
    lanes."""
    eps = 1e-30
    c = torch.sqrt((_trace_array(q1) + eps) / (_trace_array(q2) + eps))
    c = c[None, None, :]
    return (1.0 + 1.0 / c) * q1 + (1.0 + c) * q2


def _per_lane(v: torch.Tensor, width: int) -> torch.Tensor:
    """Per-dim constants (e,) as they are, per-lane ones (e, B) tiled to
    ``width`` = k B folded lanes (lane c B + b is copy c of lane b)."""
    if v.ndim < 2 or v.shape[-1] == width:
        return v
    return v.repeat(1, width // v.shape[-1])


def _lane_col(v: torch.Tensor, width: int) -> torch.Tensor:
    """Per-dim constants (e,) as a column (e, 1), per-lane ones (e, B)
    tiled to ``width`` folded lanes."""
    return v[:, None] if v.ndim < 2 else _per_lane(v, width)


def _rollout_lanes_array(ssm, u_flat, x0, k_fb, a, b, cfg, bmat, impl="xla",
                         post=None):
    """Lane tube rollout from a point state, the tiny-matrix algebra as
    batch-last (n_s, n_s, B) einsums: u_flat (n_var, B), x0 (n_s, B) ->
    the packed y (ny, B) (:func:`_unpack_y`'s layout). Stage 0 is the point
    step, stages 1..T-1 the closed-loop ellipsoid steps; ``bmat`` is S^T S
    of the Lipschitz lift. ``impl`` and ``post`` select the posterior
    (:func:`_gp_predict_lanes`; under "pallas" the model is prepared once
    here if ``post`` is None)."""
    if impl == "pallas" and post is None:
        post = prepare_posterior(ssm)
    t_len = cfg.n_safe
    n_s, n_u = a.shape[0], k_fb.shape[0]
    width = x0.shape[-1]
    noise = _lane_col(torch.exp(2.0 * _gp_of(ssm).log_noise), width)
    c_safety = cfg.c_safety
    eye = torch.eye(n_s, dtype=x0.dtype, device=x0.device)

    def diag_q(hw):                                         # (n_s, B) -> q
        return eye[:, :, None] * (n_s * hw * hw)[:, None, :]

    kff = u_flat[:n_u]
    mu, var = _gp_predict_lanes(ssm, torch.cat([x0, kff], 0),
                                want_jac=False, impl=impl, post=post)
    p = a @ x0 + b @ kff + mu
    q = diag_q(c_safety * torch.sqrt(var + noise))
    p_traj, q_traj, var_traj = [p], [q], [var]

    l_mu = _lane_col(ssm.l_mu, width)
    l_sigma = _lane_col(ssm.l_sigma, width)
    for t in range(1, t_len):
        kff = u_flat[t * n_u:(t + 1) * n_u]
        mu, var, jac = _gp_predict_lanes(ssm, torch.cat([p, kff], 0),
                                         want_jac=True, impl=impl, post=post)
        p = a @ p + b @ kff + mu
        # H = a + J_x + (b + J_u) k_fb
        h = (a[:, :, None] + jac[:, :n_s]
             + torch.einsum("ikb,kj->ijb", b[:, :, None] + jac[:, n_s:],
                            k_fb))
        q_lin = torch.einsum("ikb,klb,jlb->ijb", h, q, h)
        # Lipschitz remainder: r^2 = lambda_max(Q S^T S)
        r_sqr = _max_eig_lanes_array(torch.einsum("ikb,kj->ijb", q, bmat))
        r = torch.sqrt(_relu0(r_sqr))
        q_taylor = diag_q(0.5 * l_mu * r_sqr[None, :])
        q_conf = diag_q(c_safety * (torch.sqrt(var + noise)
                                    + l_sigma * r[None, :]))
        q = _sum_two_ellipsoids_q_array(
            _sum_two_ellipsoids_q_array(q_lin, q_conf), q_taylor)
        p_traj.append(p)
        q_traj.append(q)
        var_traj.append(var)
    return torch.cat([torch.cat(p_traj)]
                     + [qq.reshape(n_s * n_s, -1) for qq in q_traj]
                     + [torch.cat(var_traj)])


def _rollout_perf_lanes(ssm, u_flat, x0, a, b, cfg, r, n_u, t_len,
                        impl="xla", post=None, want_sigma=False):
    """Performance-trajectory stages, lane-major: the JAX package's
    ``_rollout_perf_lanes`` (``reachability/propagation.
    multi_step_propagation``, open loop). The tracking and exploration
    objectives read only the means and GP variances, so ``taylor`` and
    ``mean_equivalent`` coincide for them and the covariance is skipped. A
    Sigma-consuming cost sets ``want_sigma``, which runs the covariance
    recursion on (n_s, n_s, B) lanes:

      * ``taylor``:          Sigma+ = H Sigma H^T + diag(var + noise),
        H = a + J_mu,x (the posterior's mean Jacobian at each stage);
      * ``mean_equivalent``: Sigma+ = Sigma + diag(var + noise).

    Stage t's control is k_ff[t] (``u_flat`` rows t n_u ...) for t < r,
    shared with the safety block, and the free perf tail of ``u_flat``
    (rows t_len n_u + (t - r) n_u ...) after. x0 (n_s, B). Returns
    (p_perf, var_perf), each (n_perf, n_s, B), and with ``want_sigma``
    also sig_perf (n_perf, n_s, n_s, B)."""
    n_s, width = x0.shape
    taylor = getattr(cfg, "perf_method", "taylor") == "taylor"
    want_jac = want_sigma and taylor
    if want_sigma:
        eye = torch.eye(n_s, dtype=x0.dtype, device=x0.device)[:, :, None]
        noise = _lane_col(torch.exp(2.0 * _gp_of(ssm).log_noise), width)
        sig = torch.zeros((n_s, n_s, width), dtype=x0.dtype, device=x0.device)
    p = x0
    p_perf, var_perf, sig_perf = [], [], []
    for t in range(cfg.n_perf):
        base = t * n_u if t < r else t_len * n_u + (t - r) * n_u
        ut = u_flat[base:base + n_u]
        mu, var, *jac = _gp_predict_lanes(ssm, torch.cat([p, ut], 0),
                                          want_jac=want_jac, impl=impl,
                                          post=post)
        p = a @ p + b @ ut + mu
        p_perf.append(p)
        var_perf.append(var)
        if want_sigma:
            if taylor:
                h = a[:, :, None] + jac[0][:, :n_s]
                sig = torch.einsum("ikb,klb,jlb->ijb", h, sig, h)
            sig = sig + eye * (var + noise)[:, None, :]
            sig_perf.append(sig)
    if want_sigma:
        return torch.stack(p_perf), torch.stack(var_perf), torch.stack(sig_perf)
    return torch.stack(p_perf), torch.stack(var_perf)


def _rollout_y_lanes(ssm, u_flat, x0, k_fb, a, b, cfg, bmat, impl="xla",
                     want_sigma=False, post=None, r=0):
    """Packed tube (+ perf) rollout (ny, B) from x0 (n_s, B): the tube of
    :func:`_rollout_lanes_array` at any state dimension (the JAX package
    unrolls n_s <= 2 into scalars for XLA's trace size, which eager
    PyTorch does not have; on the H100 the array form is the faster one at
    n_s = 2 as well). With ``cfg.n_perf > 0`` the perf stages
    (:func:`_rollout_perf_lanes`, ``r`` shared controls) follow the tube's
    rows, and with ``want_sigma`` the perf covariance's after them."""
    y = _rollout_lanes_array(ssm, u_flat, x0, k_fb, a, b, cfg, bmat,
                             impl=impl, post=post)
    if cfg.n_perf == 0:
        return y
    perf = _rollout_perf_lanes(ssm, u_flat, x0, a, b, cfg, r, len(k_fb),
                               cfg.n_safe, impl=impl, post=post,
                               want_sigma=want_sigma)
    return torch.cat([y] + [blk.reshape(-1, blk.shape[-1]) for blk in perf])


def _unpack_y(y, t_len, n_s, n_perf=0, with_sigma=False):
    """The packed y's stages: centers p (t_len, n_s, B), shapes q (t_len,
    n_s, n_s, B), variances var (t_len, n_s, B); with ``n_perf > 0`` also
    (p_perf, var_perf), each (n_perf, n_s, B), and ``with_sigma`` adds the
    perf covariance sig_perf (n_perf, n_s, n_s, B) to that tuple."""
    blk_p, blk_q = t_len * n_s, t_len * n_s * n_s
    p = y[:blk_p].reshape(t_len, n_s, -1)
    q = y[blk_p:blk_p + blk_q].reshape(t_len, n_s, n_s, -1)
    idx = blk_p + blk_q
    var = y[idx:idx + blk_p].reshape(t_len, n_s, -1)
    if n_perf == 0:
        return p, q, var
    idx, blk = idx + blk_p, n_perf * n_s
    p_perf = y[idx:idx + blk].reshape(n_perf, n_s, -1)
    var_perf = y[idx + blk:idx + 2 * blk].reshape(n_perf, n_s, -1)
    if not with_sigma:
        return p, q, var, (p_perf, var_perf)
    idx += 2 * blk
    sig_perf = y[idx:idx + blk * n_s].reshape(n_perf, n_s, n_s, -1)
    return p, q, var, (p_perf, var_perf, sig_perf)


def _dist_lanes(y, t_len, n_s, h_mat_obs, h_obs, h_mat_safe, h_safe):
    """Safety margins (lin_ellipsoid_safety_distance) for every stage and
    the terminal set, stacked (n_con, B), as batch-last einsums."""
    p, q, _ = _unpack_y(y, t_len, n_s)

    def margins(p_t, q_t, h, hv):
        sup = torch.sqrt(_relu0(torch.einsum("ij,tjkb,ik->tib", h, q_t, h)))
        lin = torch.einsum("ij,tjb->tib", h, p_t)
        return (lin + sup - hv[None, :, None]).reshape(-1, p_t.shape[-1])

    return torch.cat([margins(p, q, h_mat_obs, h_obs),
                      margins(p[-1:], q[-1:], h_mat_safe, h_safe)])


def _wants_sigma(cost_kind: str, n_perf: int) -> bool:
    """Whether the lane rollout must carry the perf-trajectory covariance
    recursion for this objective (with n_perf == 0 the risk cost reads the
    safety tube's q, which the tube rollout always carries)."""
    return cost_kind == "risk_tracking" and n_perf > 0


def _cost_lanes(cost_kind: str, cost_args: dict, y, u_flat, t_len, n_s, n_u,
                n_perf=0, r=0):
    """Lane forms of the stock objectives (``solvers/costs.py``) -> (B,),
    on the tube's stages, or with ``n_perf > 0`` on the performance
    trajectory's (the perf blocks of ``y``) with the control penalty over
    u_perf_all = the shared k_ff[:r] plus the free perf controls, the JAX
    package's ``ctrl_idx``. The risk cost's variance price reads the perf
    covariance, or with ``n_perf == 0`` the tube's shapes."""
    if cost_kind not in _LANE_COSTS:
        raise ValueError(f"lane backend has no cost {cost_kind!r}")
    if n_perf > 0:
        *_, perf = _unpack_y(y, t_len, n_s, n_perf,
                             with_sigma=_wants_sigma(cost_kind, n_perf))
        p_cost, var_cost = perf[:2]
        sig_cost = perf[2] if len(perf) > 2 else None
        u_cost = torch.cat([u_flat[:r * n_u],
                            u_flat[t_len * n_u:(t_len + n_perf - r) * n_u]])
    else:
        p_cost, sig_cost, var_cost = _unpack_y(y, t_len, n_s)
        u_cost = u_flat[:t_len * n_u]
    if cost_kind == "exploration":
        return -cost_args.get("scale", 1.0) * torch.sqrt(var_cost).sum((0, 1))
    target = torch.as_tensor(cost_args["target"], dtype=y.dtype,
                             device=y.device)
    dx = p_cost - target[None, :, None]                     # (T, n_s, B)
    cost = (cost_args.get("w_x", 1.0) * torch.sum(dx[:-1] * dx[:-1],
                                                  dim=(0, 1))
            + cost_args.get("w_u", 0.1) * torch.sum(u_cost * u_cost, dim=0)
            + cost_args.get("w_terminal", 5.0) * torch.sum(dx[-1] * dx[-1],
                                                           dim=0))
    if cost_kind == "risk_tracking":
        trace = torch.diagonal(sig_cost, dim1=1, dim2=2).sum((0, -1))
        cost = cost + cost_args.get("w_sigma", 1.0) * trace
    return cost


# ------------------------------------------------------------------- GN-AL


def _lane_jacobian(fn, u, n_out: int):
    """J (n_var, n_out, B) with J[i, k, b] = d fn(u)[k, b] / d u[i, b].

    Lanes are independent, so one reverse pass over n_out lane-folded copies
    gives the whole per-lane Jacobian: ``fn(uw, k)`` evaluates on ``k``
    copies of the B lanes (lane c * B + b is copy c of lane b) and copy c
    carries the cotangent e_c. Reverse mode, not ``torch.func.jvp``: forward
    mode materializes an efficient zero tangent for every tensor and Python
    scalar without one, and arithmetic on those zero tensors leaves C++ for
    Python reference kernels, which dominated the solve.
    """
    n_var, bsz = u.shape
    with torch.enable_grad():
        uw = u.detach().repeat(1, n_out).requires_grad_(True)
        out = fn(uw, n_out)
        sel = torch.eye(n_out, dtype=u.dtype, device=u.device)
        (jt,) = torch.autograd.grad(out, uw, sel.repeat_interleave(bsz, dim=1))
    return jt.reshape(n_var, n_out, bsz)


def _lane_grad(fn, u, create_graph: bool = False):
    """d fn(u)[b] / d u[:, b] (n_var, B) for a per-lane scalar map fn."""
    with torch.enable_grad():
        if not u.requires_grad:
            u = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(fn(u)), u,
                                   create_graph=create_graph)
    return g


def _select_candidates(vals, cands, f0, u):
    """Per-lane argmin over the candidate axis, accepting only improvements.
    vals (n_c, B), cands (n_c, n_var, B) -> (n_var, B)."""
    best = torch.argmin(vals, dim=0)
    onehot = (
        torch.arange(vals.shape[0], device=vals.device)[:, None] == best[None, :]
    ).to(u.dtype)
    u_best = torch.sum(onehot[:, None, :] * cands, dim=0)
    v_best = torch.sum(onehot * vals, dim=0)
    return torch.where(v_best < f0, u_best, u)


def solve_safempc_lanes(
    ssm: GPSSM,
    x0s: torch.Tensor,
    u_init: torch.Tensor,
    k_fb: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    h_mat_obs: torch.Tensor,
    h_obs: torch.Tensor,
    h_mat_safe: torch.Tensor,
    h_safe: torch.Tensor,
    cost_kind: str,
    cost_args: dict,
    cfg: SqpConfig,
    lam_init: torch.Tensor | None = None,
):
    """Batched safety-NLP solve, lane-major.

    x0s (B, n_s), u_init (B, t_total, n_u) (t_total = n_safe, plus the
    free perf controls n_perf - r with a performance trajectory), lam_init
    (B, n_con) optional. Returns (k_ff (B, n_safe, n_u), feasible (B,),
    violation (B,), info) with info = {cost, max_constraint, warm_next (the
    whole decision matrix, (B, t_total, n_u)), lam, p_traj} — the contract
    of the JAX lane solver.
    """
    if cfg.opt_k_fb or cfg.hessian != "gn" or cfg.linesearch != "exact":
        raise NotImplementedError(
            "the lane backend covers fixed k_fb, GN Hessian and exact line "
            "search; the others take the portable NLP (solvers/sqp.py), whose "
            "batched form is not ported yet (ROADMAP Queue 1, item 7)"
        )
    t_len = cfg.n_safe
    n_u = k_fb.shape[0]
    bsz, n_s = x0s.shape
    dtype, device = x0s.dtype, x0s.device
    # the joint safety + performance decision vector [k_ff | free perf]
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    t_total = t_len + (cfg.n_perf - r if cfg.n_perf > 0 else 0)
    n_var = t_total * n_u
    n_con = t_len * h_obs.shape[0] + h_safe.shape[0]
    want_sigma = _wants_sigma(cost_kind, cfg.n_perf)

    s_lift = torch.cat([torch.eye(n_s, dtype=dtype, device=device), k_fb], 0)
    bmat = s_lift.T @ s_lift
    polys = (h_mat_obs, h_obs, h_mat_safe, h_safe)

    x0 = x0s.T
    u0 = torch.movedim(u_init.reshape(bsz, n_var), 0, -1)   # (n_var, B)
    lo = u_min.repeat(t_total)[:, None]
    hi = u_max.repeat(t_total)[:, None]
    lam0 = (torch.zeros((n_con, bsz), dtype=dtype, device=device)
            if lam_init is None else lam_init.T)

    def rollout_at(u_flat, x0_wide):
        return _rollout_y_lanes(ssm, u_flat, x0_wide, k_fb, a, b, cfg, bmat,
                                r=r, want_sigma=want_sigma)

    def rollout_y(u_flat):
        return rollout_at(u_flat, x0)

    def dist(y):
        return _dist_lanes(y, t_len, n_s, *polys)

    def cost(y, u_flat):
        return _cost_lanes(cost_kind, cost_args, y, u_flat, t_len, n_s, n_u,
                           n_perf=cfg.n_perf, r=r)

    def al_of(y, u, lam, mu):
        s = _relu0(lam + mu * dist(y))
        return cost(y, u) + torch.sum(s * s - lam * lam, dim=0) / (2.0 * mu)

    alphas = [0.5 ** i for i in range(cfg.n_linesearch)]
    polish_alphas = [1.0, 0.5, 0.25, 0.125]
    eye = torch.eye(n_var, dtype=dtype, device=device)[:, :, None]

    def fold_eval(cands, eval_wide):
        """cands (n_c, n_var, B) -> values (n_c, B) from one rollout over
        n_c * B lanes (lane c * B + b sees x0[b] and, for a per-lane model,
        lane b's model: ``lane_predict`` reads the folded copies by
        broadcasting, so the JAX package's reason not to fold them, an
        n_c-fold copy of every GP buffer, does not arise here)."""
        n_c = cands.shape[0]
        u_wide = torch.movedim(cands, 0, 1).reshape(n_var, n_c * bsz)
        y_wide = rollout_at(u_wide, x0.repeat(1, n_c))
        return eval_wide(u_wide, y_wide, n_c).reshape(n_c, bsz)

    def linearize(u):
        """The primal rollout y (ny, B) and its lane Jacobian (n_var, ny, B)."""
        y = rollout_y(u)
        jy = _lane_jacobian(
            lambda uw, k: rollout_at(uw, x0.repeat(1, k)),
            u, y.shape[0])
        return y, jy

    def lin_at(y, jy, u, vw, k):
        """y + J (v - u) on k lane-folded copies."""
        return y.repeat(1, k) + torch.einsum(
            "ib,iyb->yb", vw - u.repeat(1, k), jy.repeat(1, 1, k))

    def gn_step(u, lam, mu):
        # one primal rollout + its lane Jacobian; all further derivatives on
        # the tiny y-space maps at y + J (v - u): the exact AL gradient at
        # v = u and the classical GN curvature
        y, jy = linearize(u)

        def al_lin(vw, k=1):
            return al_of(lin_at(y, jy, u, vw, k), vw, lam.repeat(1, k), mu)

        f0 = al_lin(u)
        g = _lane_grad(al_lin, u)
        h = _lane_jacobian(
            lambda vw, k: _lane_grad(lambda v: al_lin(v, k), vw,
                                     create_graph=True),
            u, n_var)                                       # (n_var, n_var, B)

        diag = torch.stack([torch.abs(h[i, i]) for i in range(n_var)])
        diag_scale = torch.clamp(torch.max(diag, dim=0).values, min=1.0)
        hs = 0.5 * (h + h.transpose(0, 1))
        d0 = _solve_spd_unrolled(hs + cfg.newton_damping * diag_scale * eye, -g)
        d1 = _solve_spd_unrolled(hs + diag_scale * eye, -g)
        ok = torch.all(torch.isfinite(d0), dim=0)
        d = torch.where(ok[None, :], d0, d1)

        cands = torch.stack([torch.clamp(u + al_ * d, lo, hi) for al_ in alphas])
        vals = fold_eval(
            cands, lambda uw, yw, n_c: al_of(yw, uw, lam.repeat(1, n_c), mu)
        )
        vals = torch.where(torch.isfinite(vals), vals,
                           torch.full_like(vals, float("inf")))
        return _select_candidates(vals, cands, f0, u)

    def run_outer(u, lam, mu, n_outer):
        for _ in range(n_outer):
            for _ in range(cfg.n_inner):
                u = gn_step(u, lam, mu)
            lam = torch.clamp(lam + mu * dist(rollout_y(u)), min=0.0)
            mu = mu * cfg.mu_growth
        return u, lam

    def polish_step(u):
        y, jy = linearize(u)
        g = dist(y)
        v = _relu0(g)
        active = (g > 0.0).to(dtype)

        def g_lin(vw, k=1):
            return dist(lin_at(y, jy, u, vw, k))

        # J^T v with the active mask folded in
        jtv = _lane_grad(lambda vv: torch.sum(_relu0(g_lin(vv)) * v, dim=0), u)
        gj = _lane_jacobian(
            lambda vw, k: _relu0(g_lin(vw, k)) * active.repeat(1, k),
            u, n_con)                                       # (n_var, n_con, B)
        jtj = torch.einsum("icb,jcb->ijb", gj, gj)
        d = _solve_spd_unrolled(jtj + 1e-6 * eye, -jtv)
        cands = torch.stack(
            [torch.clamp(u + al_ * d, lo, hi) for al_ in polish_alphas]
        )
        viols = fold_eval(
            cands, lambda uw, yw, n_c: torch.sum(_relu0(dist(yw)), dim=0)
        )
        return _select_candidates(viols, cands, torch.sum(v, dim=0), u)

    def do_polish(u, n_steps):
        for _ in range(n_steps):
            u = polish_step(u)
        return u

    mu0 = torch.tensor(cfg.mu0, dtype=dtype, device=device)
    u_fin, lam_fin = run_outer(torch.clamp(u0, lo, hi), lam0, mu0, cfg.n_outer)
    if cfg.n_polish > 0:
        u_fin = do_polish(u_fin, cfg.n_polish)
    if cfg.n_rescue_outer > 0:
        mu_r = torch.tensor(cfg.mu0 * cfg.mu_growth ** cfg.n_outer,
                            dtype=dtype, device=device)
        u_fin, _ = run_outer(u_fin, torch.zeros_like(lam0), mu_r,
                             cfg.n_rescue_outer)
        if cfg.n_polish > 0:
            u_fin = do_polish(u_fin, cfg.n_polish)

    y_fin = rollout_y(u_fin)
    if cfg.n_polish_extra > 0:
        # batch-global violation gate (one host sync): extra polish only when
        # some lane is still infeasible
        still_bad = torch.any(
            torch.sum(_relu0(dist(y_fin)), dim=0) > cfg.feas_tol)
        if bool(still_bad):
            u_fin = do_polish(u_fin, cfg.n_polish_extra)
            y_fin = rollout_y(u_fin)
    g_fin = dist(y_fin)
    violation = torch.sum(_relu0(g_fin), dim=0)
    feasible = violation <= cfg.feas_tol
    p_traj = torch.movedim(y_fin[: t_len * n_s], -1, 0).reshape(bsz, t_len, n_s)
    u_mat = torch.movedim(u_fin, -1, 0).reshape(bsz, t_total, n_u)
    info = {
        "cost": cost(y_fin, u_fin),
        "max_constraint": torch.max(g_fin, dim=0).values,
        "warm_next": u_mat,
        "lam": lam_fin.T,
        "p_traj": p_traj,
    }
    return u_mat[:, :t_len], feasible, violation, info


def lanes_supported(ssm, cfg: SqpConfig, cost_kind: str) -> bool:
    """Whether the port's lane backend covers this configuration: a shared
    :class:`GPSSM` or :class:`SparseGPSSM` (one model, B initial states) or
    a :class:`LaneGPSSM` (B per-lane models, the fleet runner's), any state
    dimension, with or
    without a performance trajectory (either ``perf_method``: the Sigma-free
    objectives read the same stages under both, the risk cost the
    covariance recursion of each), any lane objective."""
    return (
        isinstance(ssm, (GPSSM, LaneGPSSM, SparseGPSSM))
        and all(kt in _KERNEL_PARTS for kt in _gp_of(ssm).kern_types)
        and getattr(_gp_of(ssm), "precision", "f32") == "f32"
        and not cfg.opt_k_fb
        and cfg.hessian == "gn"
        and cfg.linesearch == "exact"
        and cfg.perf_method in ("taylor", "mean_equivalent")
        and cost_kind in _LANE_COSTS
    )


def make_sqp_lane_solver(env, k_fb, a, b, cost_kind: str, cost_args: dict,
                         cfg: SqpConfig) -> Callable:
    """Batched planner solving all lanes in one lane-major program:

        batch_planner(ssm, x0s (B, n_s), warm (B, t_total, n_u)[, lam])
            -> (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info)
    """
    spec = env.spec

    def batch_planner(ssm, x0s, warm, lam=None):
        return solve_safempc_lanes(
            ssm, x0s, warm, k_fb, a, b, spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            cost_kind, cost_args, cfg, lam_init=lam,
        )

    return batch_planner

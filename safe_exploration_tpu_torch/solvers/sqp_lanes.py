"""Lane-major batched SafeMPC solver — port of
``safe_exploration_tpu/solvers/sqp_lanes.py``.

The whole solve is written batch-LAST: every per-lane scalar is a ``(B,)``
tensor, tiny-matrix algebra (ellipsoids, closed-loop maps, Newton systems) is
unrolled over indices, and the GP contractions are ``(n, B)`` matmuls.

The Gauss-Newton machinery is plain reverse-mode autograd over lane-folded
copies (:func:`_lane_jacobian`): lanes are independent, so evaluating the
rollout on ny copies of the B lanes and pulling back e_k through copy k
gives the per-lane Jacobian ``(n_var, ny, B)`` in one backward pass; the AL
Hessian is the same fold over the gradient (reverse over reverse). No
derivative ever couples two lanes. ``lax.scan`` / ``lax.cond`` become Python
loops and one host ``bool`` for the violation-gated extra polish.

Covered here: a shared :class:`GPSSM` with the RBF kernel menu, n_s <= 2
(the scalar-unrolled tube), no performance trajectory, the tracking and
exploration objectives, GN Hessian, exact line search and fixed feedback
gains. The array-form tube (n_s > 2), performance trajectories, the risk
objective and per-lane / sparse models are still to port (ROADMAP Queue 1,
items 7, 10 and 11).

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

from safe_exploration_tpu_torch.models.ssm import GPSSM
from safe_exploration_tpu_torch.ops.kernels import (
    gp_pallas_supported,
    gp_predict_prepared,
    prepare_posterior,
)
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig, _solve_spd_unrolled

__all__ = ["lanes_supported", "gp_pallas_supported", "solve_safempc_lanes",
           "make_sqp_lane_solver"]

# kernel type -> additive parts (the JAX package's models/gp_lanes table,
# restricted to the ported menu)
_KERNEL_PARTS = {"rbf": ("rbf",)}
# the Sigma-free stock objectives; a Sigma-consuming one (risk_tracking, not
# ported) must be added to _wants_sigma as well
_LANE_COSTS = ("tracking", "exploration")


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s value and derivative (1/2 at 0)."""
    return 0.5 * (x + torch.abs(x))


# ---------------------------------------------------------------- lane algebra
# A lane matrix is a nested list m[i][j] of (B,) tensors (or Python floats
# for constants); a lane vector is a list v[i].


def _mat_mul(a, b):
    n, m, k = len(a), len(b[0]), len(b)
    return [[sum(a[i][l] * b[l][j] for l in range(k)) for j in range(m)]
            for i in range(n)]


def _mat_vec(a, v):
    return [sum(a[i][j] * v[j] for j in range(len(v))) for i in range(len(a))]


def _trace(a):
    return sum(a[i][i] for i in range(len(a)))


def _const_rows(mat):
    """A constant (k, m) matrix as nested lists of Python floats (a tensor is
    read to the host once; nested lists pass through)."""
    return mat.tolist() if isinstance(mat, torch.Tensor) else mat


# ----------------------------------------------------------------- GP (lanes)


def _gp_of(ssm):
    """The GP state of a lane-capable SSM (the port carries the exact
    :class:`GPSSM` only)."""
    return ssm.gp


def _gp_predict_lanes(ssm: GPSSM, z: torch.Tensor, *, want_jac: bool,
                      impl: str = "xla", post=None):
    """Posterior mean/var (+ closed-form mean Jacobian) at B query lanes.

    ``z``: (d_in, B) raw state-action inputs. Returns (mu (e, B), var (e, B)
    [, jac (e, d_in, B)]), with the conditioning-aware variance floor and the
    z_scale chain rule of the JAX package. ``impl="pallas"`` takes the fused
    kernel (forward-only; the name is the JAX package's) on ``post``, the
    model's ``prepare_posterior`` (made here when the caller holds none).
    """
    if impl == "pallas":
        if post is None:
            post = prepare_posterior(ssm)
        return gp_predict_prepared(post, z.contiguous(), want_jac=want_jac)
    gp = ssm.gp
    xr, w_mean, w_var, mask = gp.x, gp.beta, gp.kinv, gp.mask
    zz = z if ssm.z_scale is None else z / ssm.z_scale[:, None]
    eps = torch.finfo(zz.dtype).eps
    mus, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        kv = sum(_kv_part_shared(p, params, xr, zz) for p in parts)  # (n, B)
        kv = kv * mask[:, None]
        mus.append(w_mean[d] @ kv)
        kzz = sum(_kzz_part_shared(p, params, zz) for p in parts)
        floor = torch.clamp(8.0 * eps * kzz, min=1e-12)
        vars_.append(torch.maximum(
            kzz - torch.sum(kv * (w_var[d] @ kv), dim=0), floor))
        if want_jac:
            c = mask * w_mean[d]
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


def _max_eig_lanes(m, iters: int = 30):
    """Dominant eigenvalue of lane matrices M = Q B (closed form at n <= 2,
    trace-normalized squaring + Rayleigh refinement above)."""
    n = len(m)
    if n == 1:
        return _relu0(m[0][0])
    if n == 2:
        tr = m[0][0] + m[1][1]
        det = m[0][0] * m[1][1] - m[0][1] * m[1][0]
        disc = torch.sqrt(_relu0(tr * tr - 4.0 * det))
        return _relu0(0.5 * (tr + disc))
    scale = _trace(m) / n + 1e-30
    mn = [[m[i][j] / scale for j in range(n)] for i in range(n)]
    n_sq = 3
    n_refine = max(2, (iters + (1 << n_sq) - 1) // (1 << n_sq))
    for _ in range(n_sq):
        mn = _mat_mul(mn, mn)
        s = _trace(mn) / n + 1e-30
        mn = [[mn[i][j] / s for j in range(n)] for i in range(n)]
    v = [1.0 + 1e-3 * i for i in range(n)]
    nrm = sum(x * x for x in v) ** 0.5
    v = [(x / nrm) * torch.ones_like(m[0][0]) for x in v]
    for _ in range(n_refine):
        w = _mat_vec(mn, v)
        nw = torch.sqrt(sum(x * x for x in w)) + 1e-30
        v = [x / nw for x in w]
    mv = _mat_vec(m, v)
    num = sum(a * b for a, b in zip(v, mv))
    den = sum(a * a for a in v) + 1e-30
    return _relu0(num / den)


def _sum_two_ellipsoids_q(q1, q2):
    """Shape part of the Minkowski-sum outer approximation on lane matrices."""
    n = len(q1)
    eps = 1e-30
    t1 = _trace(q1) + eps
    t2 = _trace(q2) + eps
    c = torch.sqrt(t1 / t2)
    return [[(1.0 + 1.0 / c) * q1[i][j] + (1.0 + c) * q2[i][j]
             for j in range(n)] for i in range(n)]


def _rollout_lanes(ssm, u_flat, x0, k_fb, a, b, cfg, bmat, impl="xla",
                   post=None):
    """Lane tube rollout from a point state: u_flat (n_var, B), x0 list of
    n_s (B,) rows -> (p_traj, q_traj, var_traj), lists over stages of lane
    structures. Stage 0 is the point step, stages 1..T-1 the closed-loop
    ellipsoid steps; ``bmat`` is S^T S of the Lipschitz lift. ``k_fb``,
    ``a``, ``b``, ``bmat`` may be tensors or nested lists of floats;
    ``impl`` and ``post`` select the posterior (:func:`_gp_predict_lanes`;
    under "pallas" the model is prepared once here if ``post`` is None)."""
    if impl == "pallas" and post is None:
        post = prepare_posterior(ssm)
    t_len = cfg.n_safe
    n_s = len(x0)
    a_rows, b_rows = _const_rows(a), _const_rows(b)
    kfb_rows, b_lift = _const_rows(k_fb), _const_rows(bmat)
    n_u = len(kfb_rows)
    noise = torch.exp(2.0 * ssm.gp.log_noise)
    c_safety = cfg.c_safety

    def kff_at(t):
        return [u_flat[t * n_u + i] for i in range(n_u)]

    kff = kff_at(0)
    z = torch.stack(list(x0) + kff)
    mu, var = _gp_predict_lanes(ssm, z, want_jac=False, impl=impl,
                                post=post)
    p = [
        sum(a_rows[i][j] * x0[j] for j in range(n_s))
        + sum(b_rows[i][k] * kff[k] for k in range(n_u))
        + mu[i]
        for i in range(n_s)
    ]
    zero = torch.zeros_like(p[0])
    hw0 = [c_safety * torch.sqrt(var[i] + noise[i]) for i in range(n_s)]
    q = [[n_s * hw0[i] * hw0[i] if i == j else zero for j in range(n_s)]
         for i in range(n_s)]
    p_traj, q_traj, var_traj = [p], [q], [[var[i] for i in range(n_s)]]

    l_mu, l_sigma = ssm.l_mu, ssm.l_sigma
    for t in range(1, t_len):
        kff = kff_at(t)
        z = torch.stack(list(p) + kff)
        mu, var, jac = _gp_predict_lanes(ssm, z, want_jac=True, impl=impl,
                                         post=post)
        p_next = [
            sum(a_rows[i][j] * p[j] for j in range(n_s))
            + sum(b_rows[i][k] * kff[k] for k in range(n_u))
            + mu[i]
            for i in range(n_s)
        ]
        # H = a + J_x + (b + J_u) k_fb
        h = [[
            a_rows[i][j] + jac[i, j]
            + sum((b_rows[i][k] + jac[i, n_s + k]) * kfb_rows[k][j]
                  for k in range(n_u))
            for j in range(n_s)] for i in range(n_s)]
        q_lin = _mat_mul(_mat_mul(h, q), [[h[j][i] for j in range(n_s)]
                                          for i in range(n_s)])
        # Lipschitz remainder: r^2 = lambda_max(Q S^T S)
        r_sqr = _max_eig_lanes(_mat_mul(q, b_lift))
        r = torch.sqrt(_relu0(r_sqr))
        u_mu = [0.5 * l_mu[i] * r_sqr for i in range(n_s)]
        u_sig = [l_sigma[i] * r for i in range(n_s)]
        q_taylor = [[n_s * u_mu[i] * u_mu[i] if i == j else zero
                     for j in range(n_s)] for i in range(n_s)]
        hw_c = [c_safety * (torch.sqrt(var[i] + noise[i]) + u_sig[i])
                for i in range(n_s)]
        q_conf = [[n_s * hw_c[i] * hw_c[i] if i == j else zero
                   for j in range(n_s)] for i in range(n_s)]
        q = _sum_two_ellipsoids_q(_sum_two_ellipsoids_q(q_lin, q_conf),
                                  q_taylor)
        p = p_next
        p_traj.append(p)
        q_traj.append(q)
        var_traj.append([var[i] for i in range(n_s)])
    return p_traj, q_traj, var_traj


def _rollout_y_lanes(ssm, u_flat, x0_rows, k_fb, a, b, cfg, bmat,
                     impl="xla", want_sigma=False, post=None):
    """Packed tube rollout (ny, B); the port covers n_s <= 2 and n_perf = 0
    (so no perf-trajectory covariance, ``want_sigma``)."""
    if len(x0_rows) > 2 or cfg.n_perf > 0 or want_sigma:
        raise NotImplementedError(
            "the array-form tube (n_s > 2) and performance trajectories are "
            "not ported yet (ROADMAP Queue 1, item 10)"
        )
    return _pack_y(*_rollout_lanes(ssm, u_flat, x0_rows, k_fb, a, b, cfg,
                                   bmat, impl=impl, post=post))


def _pack_y(p_traj, q_traj, var_traj):
    parts = []
    for p in p_traj:
        parts += p
    for q in q_traj:
        for row in q:
            parts += row
    for v in var_traj:
        parts += v
    return torch.stack(parts)                              # (ny, B)


def _unpack_y(y, t_len, n_s):
    idx = 0
    p_traj, q_traj, var_traj = [], [], []
    for _ in range(t_len):
        p_traj.append([y[idx + i] for i in range(n_s)])
        idx += n_s
    for _ in range(t_len):
        q_traj.append([[y[idx + i * n_s + j] for j in range(n_s)]
                       for i in range(n_s)])
        idx += n_s * n_s
    for _ in range(t_len):
        var_traj.append([y[idx + i] for i in range(n_s)])
        idx += n_s
    return p_traj, q_traj, var_traj


def _dist_lanes(y, t_len, n_s, h_mat_obs, h_obs, h_mat_safe, h_safe):
    """Safety margins (lin_ellipsoid_safety_distance) for every stage and
    the terminal set, stacked (n_con, B); polytopes as tensors or lists."""
    p_traj, q_traj, _ = _unpack_y(y, t_len, n_s)

    def margins(p, q, h_mat, h_vec):
        h_mat, h_vec = _const_rows(h_mat), _const_rows(h_vec)
        out = []
        for i in range(len(h_mat)):
            sup = sum(
                h_mat[i][j] * q[j][k] * h_mat[i][k]
                for j in range(n_s) for k in range(n_s)
            )
            sup = torch.sqrt(_relu0(sup))
            out.append(
                sum(h_mat[i][j] * p[j] for j in range(n_s)) + sup - h_vec[i]
            )
        return out

    rows = []
    for t in range(t_len):
        rows += margins(p_traj[t], q_traj[t], h_mat_obs, h_obs)
    rows += margins(p_traj[-1], q_traj[-1], h_mat_safe, h_safe)
    return torch.stack(rows)


def _wants_sigma(cost_kind: str, n_perf: int) -> bool:
    """Whether the lane rollout must carry the perf-trajectory covariance
    recursion for this objective (the JAX package's risk cost with a
    performance trajectory; neither is ported)."""
    return cost_kind == "risk_tracking" and n_perf > 0


def _cost_lanes(cost_kind: str, cost_args: dict, y, u_flat, t_len, n_s, n_u):
    """Lane forms of the tracking and exploration objectives -> (B,)."""
    if cost_kind not in _LANE_COSTS:
        raise NotImplementedError(
            f"lane cost {cost_kind!r} is not ported yet (ROADMAP Queue 1, "
            "item 10); the port carries 'tracking' and 'exploration'"
        )
    p_cost, _, var_cost = _unpack_y(y, t_len, n_s)
    if cost_kind == "exploration":
        scale = cost_args.get("scale", 1.0)
        return -scale * sum(torch.sqrt(var_cost[t][i])
                            for t in range(t_len) for i in range(n_s))
    target = _const_rows(cost_args["target"])
    w_x = cost_args.get("w_x", 1.0)
    w_u = cost_args.get("w_u", 0.1)
    w_t = cost_args.get("w_terminal", 5.0)
    stage = sum(
        (p_cost[t][i] - target[i]) ** 2
        for t in range(t_len - 1) for i in range(n_s)
    )
    ctrl = sum(u_flat[m] ** 2 for m in range(t_len * n_u))
    term = sum((p_cost[-1][i] - target[i]) ** 2 for i in range(n_s))
    return w_x * stage + w_u * ctrl + w_t * term


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

    x0s (B, n_s), u_init (B, n_safe, n_u), lam_init (B, n_con) optional.
    Returns (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info) with
    info = {cost, max_constraint, warm_next, lam, p_traj} — the contract of
    the JAX lane solver.
    """
    if cfg.opt_k_fb or cfg.hessian != "gn" or cfg.linesearch != "exact":
        raise NotImplementedError(
            "the lane backend covers fixed k_fb, GN Hessian and exact line "
            "search; the portable NLP is not ported (ROADMAP Queue 1, item 8)"
        )
    t_len = cfg.n_safe
    n_u = k_fb.shape[0]
    bsz, n_s = x0s.shape
    dtype, device = x0s.dtype, x0s.device
    n_var = t_len * n_u
    n_con = t_len * h_obs.shape[0] + h_safe.shape[0]

    # constants to the host once: the lane algebra multiplies Python floats
    s_lift = torch.cat([torch.eye(n_s, dtype=dtype, device=device), k_fb], 0)
    consts = dict(k_fb=k_fb.tolist(), a=a.tolist(), b=b.tolist(),
                  bmat=(s_lift.T @ s_lift).tolist())
    polys = (h_mat_obs.tolist(), h_obs.tolist(), h_mat_safe.tolist(),
             h_safe.tolist())
    if "target" in cost_args:
        cost_args = {**cost_args, "target": _const_rows(cost_args["target"])}

    x0 = x0s.T
    u0 = torch.movedim(u_init.reshape(bsz, n_var), 0, -1)   # (n_var, B)
    lo = u_min.repeat(t_len)[:, None]
    hi = u_max.repeat(t_len)[:, None]
    lam0 = (torch.zeros((n_con, bsz), dtype=dtype, device=device)
            if lam_init is None else lam_init.T)
    x0_rows = [x0[i] for i in range(n_s)]

    def rollout_at(u_flat, rows):
        return _rollout_y_lanes(ssm, u_flat, rows, consts["k_fb"],
                                consts["a"], consts["b"], cfg, consts["bmat"])

    def rollout_y(u_flat):
        return rollout_at(u_flat, x0_rows)

    def dist(y):
        return _dist_lanes(y, t_len, n_s, *polys)

    def cost(y, u_flat):
        return _cost_lanes(cost_kind, cost_args, y, u_flat, t_len, n_s, n_u)

    def al_of(y, u, lam, mu):
        s = _relu0(lam + mu * dist(y))
        return cost(y, u) + torch.sum(s * s - lam * lam, dim=0) / (2.0 * mu)

    alphas = [0.5 ** i for i in range(cfg.n_linesearch)]
    polish_alphas = [1.0, 0.5, 0.25, 0.125]
    eye = torch.eye(n_var, dtype=dtype, device=device)[:, :, None]

    def fold_eval(cands, eval_wide):
        """cands (n_c, n_var, B) -> values (n_c, B) from one rollout over
        n_c * B lanes (lane c * B + b sees x0[b])."""
        n_c = cands.shape[0]
        u_wide = torch.movedim(cands, 0, 1).reshape(n_var, n_c * bsz)
        y_wide = rollout_at(u_wide, [xr.repeat(n_c) for xr in x0_rows])
        return eval_wide(u_wide, y_wide, n_c).reshape(n_c, bsz)

    def linearize(u):
        """The primal rollout y (ny, B) and its lane Jacobian (n_var, ny, B)."""
        y = rollout_y(u)
        jy = _lane_jacobian(
            lambda uw, k: rollout_at(uw, [xr.repeat(k) for xr in x0_rows]),
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
    u_mat = torch.movedim(u_fin, -1, 0).reshape(bsz, t_len, n_u)
    info = {
        "cost": cost(y_fin, u_fin),
        "max_constraint": torch.max(g_fin, dim=0).values,
        "warm_next": u_mat,
        "lam": lam_fin.T,
        "p_traj": p_traj,
    }
    return u_mat, feasible, violation, info


def lanes_supported(ssm, cfg: SqpConfig, cost_kind: str) -> bool:
    """Whether the port's lane backend covers this configuration."""
    return (
        isinstance(ssm, GPSSM)
        and all(kt in _KERNEL_PARTS for kt in ssm.gp.kern_types)
        and ssm.gp.precision == "f32"
        and not cfg.opt_k_fb
        and cfg.hessian == "gn"
        and cfg.linesearch == "exact"
        and cfg.n_perf == 0
        and cost_kind in _LANE_COSTS
    )


def make_sqp_lane_solver(env, k_fb, a, b, cost_kind: str, cost_args: dict,
                         cfg: SqpConfig) -> Callable:
    """Batched planner solving all lanes in one lane-major program:

        batch_planner(ssm, x0s (B, n_s), warm (B, n_safe, n_u)[, lam])
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

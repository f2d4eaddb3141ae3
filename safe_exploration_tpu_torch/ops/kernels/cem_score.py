"""Whole-tube CEM scorer — wrapper of ``csrc/cem_score.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/cem_score.py::
tube_score_lanes_pallas``: the constrained-CEM score of every sample lane —
the n_s = 2 ellipsoid tube (GP posterior and mean Jacobian per stage, the
closed-loop map, the closed-form Lipschitz remainder, the Minkowski sums),
the stage and terminal polytope margins summed into ``viol``, and the
tracking or exploration cost — in one launch. It equals
``sqp_lanes._rollout_y_lanes`` + ``_dist_lanes`` + ``_cost_lanes``.

The GP runs in raw input coordinates: ``z_scale`` is folded into the
support rows and the lengthscales, so the Jacobian needs no chain rule.
:func:`tube_score_plain` is that chain itself, in its plain lane form; the
wrapper takes it for tensors on the CPU and launches the kernel for tensors
on a CUDA device.
"""

from __future__ import annotations

import ctypes

import torch

from safe_exploration_tpu_torch.ops.kernels import _build
from safe_exploration_tpu_torch.ops.kernels._common import (
    INT,
    VP,
    check,
    is_f64,
    on_cuda,
    raise_on_error,
    stream_ptr,
)
from safe_exploration_tpu_torch.ops.kernels.gp_predict import (
    gp_pallas_supported,
    posterior_hyper,
)

__all__ = ["cem_score_supported", "tube_score_lanes", "tube_score_plain"]

_DBL = ctypes.c_double
_ARGTYPES = (VP,) * 8 + (INT,) * 6 + (_DBL, INT, _DBL, _DBL, _DBL, _DBL, INT,
                                      VP)
_COSTS = ("tracking", "exploration")


def cem_score_supported(ssm, n_s: int, cost_kind: str, n_perf: int) -> bool:
    """Whether the scorer covers this configuration: the fused posterior's
    models (:func:`gp_pallas_supported`), n_s == 2, no performance
    trajectory, the tracking or exploration cost."""
    return (gp_pallas_supported(ssm) and n_s == 2 and n_perf == 0
            and cost_kind in _COSTS)


def _prepare(ssm, k_fb, a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe,
             cost_kind, cost_args, like):
    """Masked weights, raw-coordinate support rows and hyperparameters, and
    the constants of the tube, as tensors of ``like``'s dtype and device."""
    gp = ssm.gp
    kw = {"dtype": like.dtype, "device": like.device}

    def t(v):
        return torch.as_tensor(v, **kw)

    mask = gp.mask
    inv_ls = torch.exp(-torch.stack([p["log_lengthscales"] for p in gp.params]))
    x = gp.x
    if ssm.z_scale is not None:
        inv_ls = inv_ls / ssm.z_scale[None, :]
        x = x * ssm.z_scale[None, :]
    hyper = posterior_hyper(inv_ls,
                            torch.stack([p["log_sf"] for p in gp.params]))
    target = (cost_args["target"] if cost_kind == "tracking"
              else torch.zeros(2))
    return {
        "x": x.to(**kw).contiguous(),
        "w_mean": (gp.beta * mask[None]).to(**kw).contiguous(),
        "w_var": (gp.kinv * (mask[None, :, None] * mask[None, None, :])
                  ).to(**kw).contiguous(),
        "hyper": [h.to(**kw) for h in hyper],
        "noise": torch.exp(2.0 * gp.log_noise).to(**kw),
        "a": t(a), "b": t(b), "k_fb": t(k_fb), "bmat": t(bmat),
        "l_mu": ssm.l_mu.to(**kw), "l_sigma": ssm.l_sigma.to(**kw),
        "target": t(target),
        "h_obs": (t(h_mat_obs), t(h_obs)), "h_safe": (t(h_mat_safe), t(h_safe)),
    }


def _weights(cost_args):
    return (float(cost_args.get("w_x", 1.0)), float(cost_args.get("w_u", 0.1)),
            float(cost_args.get("w_terminal", 5.0)),
            float(cost_args.get("scale", 1.0)))


def _check_args(u_flat, x0_cols, k_fb, t_len, cost_kind):
    n_u = len(k_fb)
    if x0_cols.shape[0] != 2 or u_flat.shape != (t_len * n_u, x0_cols.shape[1]):
        raise ValueError(
            f"tube_score_lanes: needs x0_cols (2, L) and u_flat (t_len n_u, L);"
            f" got {tuple(x0_cols.shape)}, {tuple(u_flat.shape)}")
    if cost_kind not in _COSTS:
        raise ValueError(f"tube_score_lanes: no cost {cost_kind!r} ({_COSTS})")


def tube_score_plain(ssm, u_flat, x0_cols, k_fb, a, b, bmat, h_mat_obs, h_obs,
                     h_mat_safe, h_safe, c_safety, t_len, cost_kind,
                     cost_args):
    """Plain version of :func:`tube_score_lanes` (same arguments): the
    solvers' own lane chain in its plain form."""
    # the solvers import this package (through the GP refit), so their
    # lane chain is imported when the plain version runs
    from safe_exploration_tpu_torch.solvers import sqp_lanes
    from safe_exploration_tpu_torch.solvers.cem_lanes import _TubeCfg

    _check_args(u_flat, x0_cols, k_fb, t_len, cost_kind)
    y = sqp_lanes._rollout_y_lanes(
        ssm, u_flat, [x0_cols[0], x0_cols[1]], k_fb, a, b,
        _TubeCfg(n_safe=t_len, c_safety=c_safety, n_perf=0), bmat)
    g = sqp_lanes._dist_lanes(y, t_len, 2, h_mat_obs, h_obs, h_mat_safe,
                              h_safe)
    viol = torch.sum(torch.clamp(g, min=0.0), dim=0)
    return sqp_lanes._cost_lanes(cost_kind, cost_args, y, u_flat, t_len, 2,
                                 len(k_fb)), viol


def tube_score_lanes(ssm, u_flat: torch.Tensor, x0_cols: torch.Tensor, k_fb,
                     a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe,
                     c_safety: float, t_len: int, cost_kind: str,
                     cost_args: dict):
    """CEM score over L lanes: u_flat (t_len n_u, L) controls, x0_cols
    (2, L) initial states -> (cost (L,), viol (L,)); one launch on CUDA.
    The constants (k_fb, a, b, bmat = S^T S of the Lipschitz lift, the
    polytopes) may be tensors or nested lists."""
    if not on_cuda(u_flat, x0_cols, ssm.gp.x):
        return tube_score_plain(ssm, u_flat, x0_cols, k_fb, a, b, bmat,
                                h_mat_obs, h_obs, h_mat_safe, h_safe,
                                c_safety, t_len, cost_kind, cost_args)
    _check_args(u_flat, x0_cols, k_fb, t_len, cost_kind)
    pr = _prepare(ssm, k_fb, a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe,
                  cost_kind, cost_args, u_flat)
    cst = torch.cat([v.reshape(-1) for v in (
        pr["a"], pr["b"], pr["k_fb"], pr["bmat"], pr["l_mu"], pr["l_sigma"],
        pr["noise"], pr["hyper"][2], pr["hyper"][3], pr["hyper"][0],
        pr["hyper"][1], pr["target"], *pr["h_obs"], *pr["h_safe"])])
    u_flat, x0_cols = u_flat.contiguous(), x0_cols.contiguous()
    check("tube_score_lanes", pr["x"], pr["w_mean"], pr["w_var"], cst, u_flat,
          x0_cols)
    n, n_u, L = pr["x"].shape[0], pr["b"].shape[1], u_flat.shape[1]
    cost = torch.empty((L,), dtype=u_flat.dtype, device=u_flat.device)
    viol = torch.empty_like(cost)
    w_x, w_u, w_t, scale = _weights(cost_args)
    fn = _build.load("cem_score", "cem_score_lanes", _ARGTYPES)
    with torch.cuda.device(u_flat.device):
        code = fn(pr["x"].data_ptr(), pr["w_mean"].data_ptr(),
                  pr["w_var"].data_ptr(), cst.data_ptr(), u_flat.data_ptr(),
                  x0_cols.data_ptr(), cost.data_ptr(), viol.data_ptr(), n, n_u,
                  L, t_len, pr["h_obs"][1].shape[0], pr["h_safe"][1].shape[0],
                  float(c_safety), int(cost_kind == "exploration"), w_x, w_u,
                  w_t, scale, is_f64(u_flat), stream_ptr(u_flat))
    raise_on_error("tube_score_lanes", code)
    tube_score_lanes.launches += 1
    return cost, viol


tube_score_lanes.launches = 0

"""Whole-tube CEM scorer — wrapper of ``csrc/cem_score.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/cem_score.py::
tube_score_lanes_pallas``: the constrained-CEM score of every sample lane —
the n_s = 2 ellipsoid tube (GP posterior and mean Jacobian per stage, the
closed-loop map, the closed-form Lipschitz remainder, the Minkowski sums),
the stage and terminal polytope margins summed into ``viol``, and the
tracking or exploration cost — in one launch. It equals
``sqp_lanes._rollout_y_lanes`` + ``_dist_lanes`` + ``_cost_lanes``.

Two steps: :func:`prepare_tube_score` makes the model and the constants
ready once (the posterior of gp_predict's ``prepare_posterior``, which
the final passes of a CEM solve share, and the constant block on the
device), :func:`tube_score_prepared` scores lanes with them;
a CEM solve prepares once and scores every iteration, and
:func:`tube_score_lanes` does both in one call. The GP runs in raw input
coordinates: ``z_scale`` is folded into the support rows and the
lengthscales, so the Jacobian needs no chain rule. :func:`tube_score_plain`
is that chain itself, in its plain lane form; the wrapper takes it for
tensors on the CPU and launches the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
    LanePosterior,
    gp_of,
    gp_pallas_supported,
    prepare_posterior,
)

__all__ = ["TubeScorePrep", "cem_score_supported", "prepare_tube_score",
           "tube_score_lanes", "tube_score_plain", "tube_score_prepared"]

_DBL = ctypes.c_double
_ARGTYPES = (VP,) * 9 + (INT,) * 6 + (_DBL, INT, _DBL, _DBL, _DBL, _DBL, INT,
                                      VP)
_COSTS = ("tracking", "exploration")


def cem_score_supported(ssm, n_s: int, cost_kind: str, n_perf: int) -> bool:
    """Whether the scorer covers this configuration: the fused posterior's
    models (:func:`gp_pallas_supported`: a shared exact or sparse GP-SSM),
    n_s == 2, no performance trajectory, the tracking or exploration
    cost."""
    return (gp_pallas_supported(ssm) and n_s == 2 and n_perf == 0
            and cost_kind in _COSTS)


class TubeScorePrep(NamedTuple):
    """What :func:`tube_score_prepared` needs besides the lanes: the
    arguments of :func:`tube_score_lanes` (the plain version's input), and
    for a model on a CUDA device the kernel's inputs — the posterior and the
    constant block ``cst`` on the device."""

    args: tuple
    post: LanePosterior | None
    cst: torch.Tensor | None


def _flat_values(v) -> list:
    """A nested list (or scalar) of constants as a flat list of floats."""
    if isinstance(v, (list, tuple)):
        return [x for item in v for x in _flat_values(item)]
    return [float(v)]


def _constant_block(parts, kw) -> list:
    """1-D tensors of ``kw`` for the constants ``parts`` in order: a tensor
    is moved as it is, and every list goes in one host-to-device copy."""
    host = [_flat_values(v) for v in parts if not isinstance(v, torch.Tensor)]
    flat = torch.tensor([x for vals in host for x in vals], **kw)
    out, at, k = [], 0, 0
    for v in parts:
        if isinstance(v, torch.Tensor):
            out.append(v.to(**kw).reshape(-1))
        else:
            out.append(flat[at:at + len(host[k])])
            at, k = at + len(host[k]), k + 1
    return out


def prepare_tube_score(ssm, k_fb, a, b, bmat, h_mat_obs, h_obs, h_mat_safe,
                       h_safe, c_safety: float, t_len: int, cost_kind: str,
                       cost_args: dict) -> TubeScorePrep:
    """Everything of a :func:`tube_score_lanes` call but the lanes, once per
    model and constants (a CEM solve prepares once and scores every
    iteration). For a model on a CUDA device: the posterior of
    :func:`prepare_posterior` and the constant block (see ``Cst`` in
    cem_score.cu), the plant's constants given as lists in one
    host-to-device copy, those given as tensors and the model's own on the
    device. For a model on the CPU only the arguments
    are kept (the plain version takes them)."""
    args = (ssm, k_fb, a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe,
            c_safety, t_len, cost_kind, cost_args)
    prepare_tube_score.calls += 1
    if not on_cuda(gp_of(ssm).x):
        return TubeScorePrep(args, None, None)
    post = prepare_posterior(ssm)
    kw = {"dtype": post.x.dtype, "device": post.x.device}
    target = cost_args["target"] if cost_kind == "tracking" else [0.0, 0.0]
    inv_ls, inv_ls2, sf2, floor = post.hyper
    cst = torch.cat([*_constant_block((a, b, k_fb, bmat, target, h_mat_obs,
                                       h_obs, h_mat_safe, h_safe), kw),
                     ssm.l_mu.to(**kw),
                     ssm.l_sigma.to(**kw),
                     torch.exp(2.0 * gp_of(ssm).log_noise).to(**kw), sf2,
                     floor, inv_ls.reshape(-1), inv_ls2.reshape(-1)])
    return TubeScorePrep(args, post, cst)


prepare_tube_score.calls = 0


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
    # the constants as the kernel takes them (lists or tensors), as tensors
    # of the lanes' dtype and device
    k_fb, a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe = (
        torch.as_tensor(v, dtype=u_flat.dtype, device=u_flat.device)
        for v in (k_fb, a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe))
    y = sqp_lanes._rollout_y_lanes(
        ssm, u_flat, x0_cols, k_fb, a, b,
        _TubeCfg(n_safe=t_len, c_safety=c_safety, n_perf=0), bmat)
    g = sqp_lanes._dist_lanes(y, t_len, 2, h_mat_obs, h_obs, h_mat_safe,
                              h_safe)
    viol = torch.sum(torch.clamp(g, min=0.0), dim=0)
    return sqp_lanes._cost_lanes(cost_kind, cost_args, y, u_flat, t_len, 2,
                                 len(k_fb)), viol


def tube_score_prepared(prep: TubeScorePrep, u_flat: torch.Tensor,
                        x0_cols: torch.Tensor):
    """CEM score over L lanes from a :func:`prepare_tube_score` result:
    u_flat (t_len n_u, L) controls, x0_cols (2, L) initial states -> (cost
    (L,), viol (L,)); one launch on CUDA, the plain version on the CPU."""
    ssm, k_fb, *_, h_obs, _, h_safe, c_safety, t_len, cost_kind, cost_args = (
        prep.args)
    if not on_cuda(u_flat, x0_cols, gp_of(ssm).x):
        return tube_score_plain(ssm, u_flat, x0_cols, *prep.args[1:])
    _check_args(u_flat, x0_cols, k_fb, t_len, cost_kind)
    post = prep.post
    u_flat, x0_cols = u_flat.contiguous(), x0_cols.contiguous()
    check("tube_score_prepared", post.x, post.x_il, post.w_mean,
          post.w_var_t, prep.cst, u_flat, x0_cols)
    (n, d), L = post.x.shape, u_flat.shape[1]
    cost = torch.empty((L,), dtype=u_flat.dtype, device=u_flat.device)
    viol = torch.empty_like(cost)
    w_x, w_u, w_t, scale = _weights(cost_args)
    fn = _build.load("cem_score", "cem_score_lanes", _ARGTYPES)
    with torch.cuda.device(u_flat.device):
        code = fn(post.x.data_ptr(), post.x_il.data_ptr(),
                  post.w_mean.data_ptr(), post.w_var_t.data_ptr(),
                  prep.cst.data_ptr(), u_flat.data_ptr(), x0_cols.data_ptr(),
                  cost.data_ptr(), viol.data_ptr(), n, d - 2, L, t_len,
                  len(h_obs), len(h_safe), float(c_safety),
                  int(cost_kind == "exploration"), w_x, w_u, w_t, scale,
                  is_f64(u_flat), stream_ptr(u_flat))
    raise_on_error("tube_score_prepared", code)
    tube_score_prepared.launches += 1
    return cost, viol


tube_score_prepared.launches = 0


def tube_score_lanes(ssm, u_flat: torch.Tensor, x0_cols: torch.Tensor, k_fb,
                     a, b, bmat, h_mat_obs, h_obs, h_mat_safe, h_safe,
                     c_safety: float, t_len: int, cost_kind: str,
                     cost_args: dict):
    """CEM score over L lanes: u_flat (t_len n_u, L) controls, x0_cols
    (2, L) initial states -> (cost (L,), viol (L,)); :func:`
    prepare_tube_score`, then :func:`tube_score_prepared` (one launch on
    CUDA). The constants (k_fb, a, b, bmat = S^T S of the Lipschitz lift,
    the polytopes) may be tensors or nested lists."""
    return tube_score_prepared(
        prepare_tube_score(ssm, k_fb, a, b, bmat, h_mat_obs, h_obs,
                           h_mat_safe, h_safe, c_safety, t_len, cost_kind,
                           cost_args), u_flat, x0_cols)

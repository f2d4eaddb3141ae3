"""SafeMPC state machines — port of ``safe_exploration_tpu/solvers/safempc.py``
(``make_safempc`` and ``make_safempc_batch``).

The planner's solution is applied where it is feasible; elsewhere the
fallback chain takes over: the stored safe plan shifted by one
(``k_ff_{t+1} + k_fb (x - p_{t+1})``), then, once that is exhausted, the
terminal LQR policy. The single-instance machine branches on the host on
the solve's feasibility (one read-back per step); the batched one computes
both branches as data and selects lane by lane with ``torch.where``, with no
read-back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from safe_exploration_tpu_torch.envs.base import Env, linearize_discretize
from safe_exploration_tpu_torch.ops.linalg import dlqr
from safe_exploration_tpu_torch.reachability.onestep import (
    multistep_reachability,
)

__all__ = ["SafeMPCConfig", "SafeMPCState", "make_safempc",
           "make_safempc_batch"]


class SafeMPCConfig(NamedTuple):
    """Static SafeMPC knobs."""

    n_safe: int = 5                 # safety horizon
    c_safety: float = 2.5           # beta_safety confidence scaling
    lqr_w_x: float = 1.0            # LQR state weight (prior-model feedback)
    lqr_w_u: float = 1.0            # LQR control weight


@dataclasses.dataclass(frozen=True)
class SafeMPCState:
    """Carried controller state; the batched machine adds a leading (B,)
    to every field."""

    k_ff_plan: torch.Tensor   # (T, n_u) last feasible feed-forward plan
    p_plan: torch.Tensor      # (T, n_s) centers each stored control applies at
    plan_idx: torch.Tensor    # () int32 next stored stage (T = exhausted)
    n_fail: torch.Tensor      # () int32 consecutive infeasible solves
    warm_mean: torch.Tensor   # (n_warm, n_u) planner warm start
    lam: torch.Tensor         # (n_duals,) dual warm start


def _lqr_feedback(env: Env, cfg: SafeMPCConfig):
    a, b = linearize_discretize(env)
    kw = {"dtype": a.dtype, "device": a.device}
    k_lqr, _ = dlqr(a, b, cfg.lqr_w_x * torch.eye(env.spec.n_s, **kw),
                    cfg.lqr_w_u * torch.eye(env.spec.n_u, **kw))
    return a, b, -k_lqr


def _shift_rows(warm: torch.Tensor, t_len: int) -> torch.Tensor:
    """Receding-horizon shift of the stacked decision rows (..., n_warm,
    n_u): the safety block and the free performance block shift each on its
    own, duplicating its last row."""
    k_ff = warm[..., :t_len, :]
    k_ff = torch.cat([k_ff[..., 1:, :], k_ff[..., -1:, :]], dim=-2)
    if warm.shape[-2] > t_len:
        perf = warm[..., t_len:, :]
        perf = torch.cat([perf[..., 1:, :], perf[..., -1:, :]], dim=-2)
        return torch.cat([k_ff, perf], dim=-2)
    return k_ff


def make_safempc(
    env: Env,
    cfg: SafeMPCConfig,
    planner: Callable,
    warm_len: int | None = None,
    n_duals: int = 0,
    dual_shift: Callable | None = None,
):
    """Single-instance SafeMPC.

    ``planner(generator, ssm, x0, warm_mean[, lam], noise=None) -> (k_ff_all,
    feasible, violation, info)``. Returns (init_state, get_action, k_fb,
    (a, b)):
      * ``init_state() -> SafeMPCState``
      * ``get_action(generator, state, ssm, x, noise=None) -> (u, new_state,
        info)``; ``generator`` / ``noise`` go to the planner.
    """
    spec = env.spec
    a, b, k_fb = _lqr_feedback(env, cfg)
    dtype, device = a.dtype, a.device
    n_s, n_u = spec.n_s, spec.n_u
    t_len = cfg.n_safe
    n_warm = t_len if warm_len is None else warm_len

    def init_state() -> SafeMPCState:
        kw = {"dtype": dtype, "device": device}
        i32 = {"dtype": torch.int32, "device": device}
        return SafeMPCState(
            k_ff_plan=torch.zeros((t_len, n_u), **kw),
            p_plan=torch.zeros((t_len, n_s), **kw),
            plan_idx=torch.tensor(t_len, **i32),
            n_fail=torch.tensor(0, **i32),
            warm_mean=torch.zeros((n_warm, n_u), **kw),
            lam=torch.zeros((n_duals,), **kw),
        )

    def get_action(generator, state: SafeMPCState, ssm, x: torch.Tensor,
                   noise=None):
        if n_duals > 0:
            k_ff_new, feasible, violation, pinfo = planner(
                generator, ssm, x, state.warm_mean, state.lam, noise=noise)
            lam_next = pinfo["lam"]
        else:
            k_ff_new, feasible, violation, pinfo = planner(
                generator, ssm, x, state.warm_mean, noise=noise)
            lam_next = state.lam
        warm_next = pinfo.get("warm_next", k_ff_new)
        if bool(feasible):
            # control t applies at center p_t (p_0 = x)
            p_traj, _, _ = multistep_reachability(
                ssm, x, k_ff_new, k_fb.expand(t_len, *k_fb.shape), a, b,
                cfg.c_safety)
            u = k_ff_new[0]
            new_state = SafeMPCState(
                k_ff_plan=k_ff_new,
                p_plan=torch.cat([x[None], p_traj[:-1]], dim=0),
                plan_idx=torch.ones_like(state.plan_idx),
                n_fail=torch.zeros_like(state.n_fail),
                warm_mean=_shift_rows(warm_next, t_len),
                lam=dual_shift(lam_next) if dual_shift is not None else lam_next,
            )
        else:
            idx = torch.clamp(state.plan_idx, max=t_len - 1).long().reshape(1)
            u_stored = (state.k_ff_plan.index_select(0, idx)[0]
                        + k_fb @ (x - state.p_plan.index_select(0, idx)[0]))
            u_lqr = k_fb @ (x - spec.target)
            u = torch.clamp(torch.where(state.plan_idx < t_len, u_stored,
                                        u_lqr), spec.u_min, spec.u_max)
            new_state = SafeMPCState(
                k_ff_plan=state.k_ff_plan,
                p_plan=state.p_plan,
                plan_idx=torch.clamp(state.plan_idx + 1, max=t_len),
                n_fail=state.n_fail + 1,
                warm_mean=_shift_rows(state.warm_mean, t_len),
                lam=0.5 * state.lam,
            )
        info = {
            "feasible": feasible,
            "violation": violation,
            "n_fail": new_state.n_fail,
            "used_fallback": torch.logical_not(feasible),
            **pinfo,
        }
        return u, new_state, info

    return init_state, get_action, k_fb, (a, b)


def make_safempc_batch(
    env: Env,
    cfg: SafeMPCConfig,
    batch_planner: Callable,
    warm_len: int | None = None,
    n_duals: int = 0,
    dual_shift: Callable | None = None,
):
    """Batched SafeMPC over B lanes.

    Returns (init_state_batch, get_action_batch):
      * ``init_state_batch(batch) -> SafeMPCState``
      * ``get_action_batch(state, ssm, xs (B, n_s), noise=None) -> (u (B,
        n_u), new_state, info)``; ``noise`` (the planner's draws) goes to
        ``batch_planner`` when given.
    """
    spec = env.spec
    a, b, k_fb = _lqr_feedback(env, cfg)
    dtype, device = a.dtype, a.device
    n_s, n_u = spec.n_s, spec.n_u
    t_len = cfg.n_safe
    n_warm = t_len if warm_len is None else warm_len

    def init_state_batch(batch: int) -> SafeMPCState:
        kw = {"dtype": dtype, "device": device}
        return SafeMPCState(
            k_ff_plan=torch.zeros((batch, t_len, n_u), **kw),
            p_plan=torch.zeros((batch, t_len, n_s), **kw),
            plan_idx=torch.full((batch,), t_len, dtype=torch.int32,
                                device=device),
            n_fail=torch.zeros((batch,), dtype=torch.int32, device=device),
            warm_mean=torch.zeros((batch, n_warm, n_u), **kw),
            lam=torch.zeros((batch, n_duals), **kw),
        )

    def get_action_batch(state: SafeMPCState, ssm, xs: torch.Tensor,
                         noise=None):
        draws = {} if noise is None else {"noise": noise}
        if n_duals > 0:
            k_ff_new, feasible, violation, pinfo = batch_planner(
                ssm, xs, state.warm_mean, state.lam, **draws
            )
            lam_next = pinfo["lam"]
        else:
            k_ff_new, feasible, violation, pinfo = batch_planner(
                ssm, xs, state.warm_mean, **draws
            )
            lam_next = state.lam
        warm_next = pinfo.get("warm_next", k_ff_new)
        if "p_traj" in pinfo:
            p_traj = pinfo["p_traj"]                        # (B, T, n_s)
        else:
            p_traj, _, _ = multistep_reachability(
                ssm, xs, k_ff_new, k_fb.expand(t_len, *k_fb.shape), a, b,
                cfg.c_safety)
        p_refs = torch.cat([xs[:, None], p_traj[:, :-1]], dim=1)

        feas = feasible[:, None]
        feas_t = feasible[:, None, None]
        u_ok = k_ff_new[:, 0]
        idx = torch.clamp(state.plan_idx, max=t_len - 1)
        have_stored = (state.plan_idx < t_len)[:, None]
        onehot = (
            torch.arange(t_len, device=device)[None, :] == idx[:, None]
        ).to(dtype)
        kff_st = torch.einsum("bt,btu->bu", onehot, state.k_ff_plan)
        p_st = torch.einsum("bt,bts->bs", onehot, state.p_plan)
        u_stored = kff_st + (xs - p_st) @ k_fb.T
        u_lqr = (xs - spec.target[None]) @ k_fb.T
        u_fail = torch.clamp(torch.where(have_stored, u_stored, u_lqr),
                             spec.u_min, spec.u_max)
        u = torch.where(feas, u_ok, u_fail)
        shifted_lam = dual_shift(lam_next) if dual_shift is not None else lam_next
        ones = torch.ones_like(state.plan_idx)
        new_state = SafeMPCState(
            k_ff_plan=torch.where(feas_t, k_ff_new, state.k_ff_plan),
            p_plan=torch.where(feas_t, p_refs, state.p_plan),
            plan_idx=torch.where(feasible, ones,
                                 torch.clamp(state.plan_idx + 1, max=t_len)),
            n_fail=torch.where(feasible, torch.zeros_like(state.n_fail),
                               state.n_fail + 1),
            warm_mean=torch.where(feas_t, _shift_rows(warm_next, t_len),
                                  _shift_rows(state.warm_mean, t_len)),
            lam=torch.where(feas, shifted_lam, 0.5 * state.lam),
        )
        info = {
            "feasible": feasible,
            "violation": violation,
            "n_fail": new_state.n_fail,
            "used_fallback": torch.logical_not(feasible),
            **pinfo,
        }
        return u, new_state, info

    return init_state_batch, get_action_batch

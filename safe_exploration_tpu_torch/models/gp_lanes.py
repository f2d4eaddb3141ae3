"""Per-lane GP state, batch-last — port of
``safe_exploration_tpu/models/gp_lanes.py``.

The fleet runner (``runtime/batch.py``) runs B independent online-learning
episodes, each lane with its own evolving GP. This module stores those
models batch-LAST, the layout of the lane SQP that consumes them:

  * buffers   x (n_max, d_in, B), y (n_max, e, B);
  * factors   beta (e, n_max, B), kinv (e, n_max, n_max, B);
  * mask (n_max,) and head (an int) are SHARED: lanes come from one fitted
    model (:func:`lane_stack_ssm`) and append in lockstep, one point per
    step in every lane;
  * hyperparameters are shared (their unbatched shapes) or, after the
    between-episode per-lane fit (:func:`lane_restack_ssm`), per lane with
    a trailing (B,) axis (``per_lane_hypers``).

Posterior predicts, Jacobians and the O(n^2) append are lane-tiled
elementwise work unrolled over the tiny d_in plus (n, B) / (n, n, B)
contractions. The append keeps beta and K^-1 by the exact block-inverse
algebra of the bordered Gram; the Cholesky factor is not kept, so
:func:`lane_unstack_ssm` refactors once per episode boundary, through the
stacked GP's batched refit (one Gram launch, one Cholesky, one PSD solve
and one triangular inverse over all B * e matrices).

The port carries the RBF kernel only (``_KERNEL_PARTS``); other menus
raise naming ROADMAP Queue 1, item 3. ``lane_sharding_tree`` belongs to
item 13 (one card here).
"""

from __future__ import annotations

import dataclasses

import torch

from safe_exploration_tpu_torch.models import gp as gp_mod
from safe_exploration_tpu_torch.models.ssm import GPSSM

__all__ = ["LaneGP", "LaneGPSSM", "lane_stack_ssm", "lane_unstack_ssm",
           "lane_restack_ssm", "lane_predict", "lane_append_point",
           "lane_shrink_to_bucket", "lane_expand_to"]

_JITTER = gp_mod._JITTER

#: kernel type -> additive parts (the JAX package's menu, RBF only here)
_KERNEL_PARTS = {"rbf": ("rbf",)}


def _check_menu(kern_types: tuple) -> None:
    if any(kt not in _KERNEL_PARTS for kt in kern_types):
        raise NotImplementedError(
            f"kern_types={kern_types}: the port's lane models carry the RBF "
            "kernel only (ROADMAP Queue 1, item 3: lin/mat52/composites)")


@dataclasses.dataclass(frozen=True)
class LaneGP:
    """B independent per-lane GPs, batch-LAST (see the module docstring)."""

    kern_types: tuple     # (e,) kernel type per output dim
    x: torch.Tensor       # (n_max, d_in, B) padded per-lane inputs
    y: torch.Tensor       # (n_max, e, B) padded per-lane targets
    mask: torch.Tensor    # (n_max,) SHARED validity mask
    params: tuple         # per-dim hyperparameter dicts, shared or (..., B)
    log_noise: torch.Tensor  # (e,) or (e, B)
    beta: torch.Tensor    # (e, n_max, B) K^-1 (m * y) per lane
    kinv: torch.Tensor    # (e, n_max, n_max, B) K^-1 per lane
    head: int             # SHARED write pointer
    precision: str = "f32"
    per_lane_hypers: bool = False

    @property
    def n_max(self) -> int:
        return self.x.shape[0]

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    @property
    def n_lanes(self) -> int:
        return self.x.shape[-1]

    @property
    def n_points(self) -> torch.Tensor:
        return torch.sum(self.mask).to(torch.int32)

    def replace(self, **changes) -> "LaneGP":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class LaneGPSSM:
    """Per-lane GP-SSM, the lane-major counterpart of :class:`GPSSM`: the
    part of the model seam the lane SQP reads. ``l_mu`` / ``l_sigma`` are
    (n_s,) shared or (n_s, B) per lane, as the hyperparameters."""

    gp: LaneGP
    l_mu: torch.Tensor     # (n_s,) or (n_s, B)
    l_sigma: torch.Tensor  # (n_s,) or (n_s, B)
    z_scale: torch.Tensor | None = None  # (d_in,) or None

    def replace(self, **changes) -> "LaneGPSSM":
        return dataclasses.replace(self, **changes)


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s value and derivative (1/2 at the
    tie, where ``torch.clamp`` would give 1)."""
    return 0.5 * (x + torch.abs(x))


def _lane_d2(params, x, zz, d_in):
    """ARD squared distance of the lane queries to the per-lane buffers,
    unrolled over d_in: x (n, d_in, ..., B), zz a list of d_in (..., B)
    rows -> (n, ..., B)."""
    ls = torch.exp(params["log_lengthscales"])
    return _relu0(sum(((x[:, j] - zz[j][None]) / ls[j]) ** 2
                      for j in range(d_in)))


def _lane_kv_part(part, params, x, zz, d_in):
    """One kernel part's cross-covariance k(z_b, X_b), (n, ..., B)."""
    sf2 = torch.exp(2.0 * params["log_sf"])
    return sf2 * torch.exp(-0.5 * _lane_d2(params, x, zz, d_in))


def _lane_kzz_part(part, params, zz, d_in):
    """One kernel part's prior variance at the lane queries, (..., B)."""
    return torch.exp(2.0 * params["log_sf"]) * torch.ones_like(zz[0])


def _lane_jac_part(part, params, x, zz, c, d_in):
    """One kernel part's weighted-mean input gradient d/dz sum_n c_n
    k(z, x_n) as a (d_in, ..., B) stack; ``c`` carries the mask."""
    ls = torch.exp(params["log_lengthscales"])
    w = _lane_kv_part("rbf", params, x, zz, d_in) * c
    sum_w = torch.sum(w, dim=0)
    return torch.stack([
        (torch.sum(x[:, j] * w, dim=0) - zz[j] * sum_w) / (ls[j] * ls[j])
        for j in range(d_in)])


def lane_stack_ssm(ssm: GPSSM, batch: int) -> LaneGPSSM:
    """Broadcast ONE fitted GP-SSM into B lane-major per-lane copies (each
    lane then evolves its own buffers and factors by
    :func:`lane_append_point`)."""
    gp = ssm.gp
    _check_menu(gp.kern_types)

    def lanes(arr):
        return arr[..., None].expand(arr.shape + (batch,)).contiguous()

    lane_gp = LaneGP(
        kern_types=gp.kern_types, x=lanes(gp.x), y=lanes(gp.y),
        mask=gp.mask, params=gp.params, log_noise=gp.log_noise,
        beta=lanes(gp.beta), kinv=lanes(gp.kinv), head=gp.head,
        precision=gp.precision)
    return LaneGPSSM(gp=lane_gp, l_mu=ssm.l_mu, l_sigma=ssm.l_sigma,
                     z_scale=ssm.z_scale)


def lane_unstack_ssm(lssm: LaneGPSSM) -> GPSSM:
    """Lane-major state -> the STACKED GPSSM (a leading lane axis on every
    tensor but the lockstep mask and head, see ``models/gp.py``), refitted:
    the per-lane Cholesky is not kept lane-major, so the stacked GP's
    batched refit rebuilds chol, beta and K^-1 of all B lanes at once
    (exact, once per episode; the Gram reads the one shared mask)."""
    gp = lssm.gp
    b = gp.n_lanes

    def shared(arr):
        return arr[None].expand((b,) + arr.shape).contiguous()

    def front(arr):
        return torch.movedim(arr, -1, 0).contiguous()

    hyp = front if gp.per_lane_hypers else shared
    kinv = front(gp.kinv)
    stacked = gp_mod.GP(
        kern_types=gp.kern_types, x=front(gp.x), y=front(gp.y),
        mask=gp.mask,
        params=tuple({k: hyp(v) for k, v in p.items()} for p in gp.params),
        log_noise=hyp(gp.log_noise),
        chol=kinv,   # placeholder: the refit rebuilds chol, beta and kinv
        beta=front(gp.beta), kinv=kinv, head=gp.head,
        precision=gp.precision)
    return GPSSM(gp=gp_mod.gp_refit(stacked), l_mu=hyp(lssm.l_mu),
                 l_sigma=hyp(lssm.l_sigma),
                 z_scale=None if lssm.z_scale is None
                 else shared(lssm.z_scale))


def lane_restack_ssm(stacked: GPSSM) -> LaneGPSSM:
    """STACKED per-lane GPSSM (e.g. after the between-episode ``ssm_fit`` and
    ``calibrate_lipschitz``) -> lane-major, keeping each lane's own
    hyperparameters and Lipschitz constants as batch-last leaves
    (``per_lane_hypers``). Inverse of :func:`lane_unstack_ssm` up to the
    kept factors; mask and head are in lockstep (a per-lane mask gives
    lane 0's)."""
    gp = stacked.gp

    def to_lanes(arr):
        return torch.movedim(arr, 0, -1).contiguous()

    lane_gp = LaneGP(
        kern_types=gp.kern_types, x=to_lanes(gp.x), y=to_lanes(gp.y),
        mask=gp.mask if gp.mask.ndim == 1 else gp.mask[0],
        params=tuple({k: to_lanes(v) for k, v in p.items()}
                     for p in gp.params),
        log_noise=to_lanes(gp.log_noise), beta=to_lanes(gp.beta),
        kinv=to_lanes(gp.kinv), head=gp.head, precision=gp.precision,
        per_lane_hypers=True)
    return LaneGPSSM(
        gp=lane_gp, l_mu=to_lanes(stacked.l_mu),
        l_sigma=to_lanes(stacked.l_sigma),
        z_scale=None if stacked.z_scale is None else stacked.z_scale[0])


def lane_predict(lssm: LaneGPSSM, z: torch.Tensor, *, want_jac: bool = False):
    """Posterior mean / var (+ closed-form mean Jacobian) of the B per-lane
    GPs at lane queries: every lane queries ITS OWN model.

    ``z``: (d_in, W) RAW inputs, lane-last, with W = k B: query c B + b is
    copy c of lane b (the lane SQP's folded copies; k = 1 is the JAX
    package's call) and reads lane b's model by broadcasting, never by a
    copy of the buffers. Returns (mu (e, W), var (e, W)[, jac
    (e, d_in, W)]), with the conditioning-aware variance floor and the
    z_scale chain rule of the JAX package."""
    gp = lssm.gp
    bsz = gp.n_lanes
    zz = z if lssm.z_scale is None else z / lssm.z_scale[:, None]
    d_in, width = zz.shape
    k = width // bsz
    if k * bsz != width:
        raise ValueError(f"lane_predict: {width} queries for {bsz} lanes")
    eps = torch.finfo(zz.dtype).eps
    zr = [zz[j].reshape(k, bsz) for j in range(d_in)]       # (k, B) rows
    x = gp.x[:, :, None, :]                                 # (n, d_in, 1, B)
    mask = gp.mask[:, None, None]
    mus, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        kv = sum(_lane_kv_part(p, params, x, zr, d_in)
                 for p in parts) * mask                     # (n, k, B)
        mus.append(torch.sum(gp.beta[d][:, None, :] * kv, dim=0))
        kzz = sum(_lane_kzz_part(p, params, zr, d_in) for p in parts)
        floor = torch.clamp(8.0 * eps * kzz, min=1e-12)
        kiv = torch.einsum("ijb,jkb->ikb", gp.kinv[d], kv)   # (n, k, B)
        vars_.append(torch.maximum(kzz - torch.sum(kv * kiv, dim=0), floor))
        if want_jac:
            c = (gp.beta[d] * gp.mask[:, None])[:, None, :]  # (n, 1, B)
            jac = sum(_lane_jac_part(p, params, x, zr, c, d_in)
                      for p in parts)                       # (d_in, k, B)
            if lssm.z_scale is not None:
                jac = jac / lssm.z_scale[:, None, None]
            jacs.append(jac.reshape(d_in, width))
    mu = torch.stack(mus).reshape(gp.n_out, width)
    var = torch.stack(vars_).reshape(gp.n_out, width)
    if want_jac:
        return mu, var, torch.stack(jacs)
    return mu, var


def lane_append_point(lssm: LaneGPSSM, x: torch.Tensor, u: torch.Tensor,
                      y: torch.Tensor) -> LaneGPSSM:
    """O(n^2)-per-lane append of ONE transition to EVERY lane's own GP.

    x (B, n_s), u (B, n_u), y (B, e), in the runner's layout; the z_scale
    normalization is applied here. Lanes append in lockstep into the shared
    slot; on a full buffer the append is a no-op for every lane (the
    runner rejects overflowing schedules before the episode). The update is
    the exact block inverse of the bordered Gram: with w = K^-1 kv and S =
    k_nn + sigma_n^2 + jitter - kv^T w, K^-1 gains w w^T / S and the
    border [-w / S, 1 / S]; beta becomes beta + w c with -c in the slot,
    c = (kv^T beta - y_n) / S. kv is masked by the OLD mask, so padding
    rows stay identity."""
    gp = lssm.gp
    n_lanes = gp.n_lanes
    if x.ndim != 2 or x.shape[0] != n_lanes:
        raise ValueError(
            "lane_append_point requires one transition per lane in lockstep "
            f"(shared mask/head): got x shape {tuple(x.shape)} for "
            f"{n_lanes} lanes; per-lane variable-length schedules need the "
            "stacked runner (ROADMAP Queue 1, item 7)")
    if gp.head >= gp.n_max:
        return lssm
    z = torch.cat([x, u], dim=-1).T                         # (d_in, B)
    if lssm.z_scale is not None:
        z = z / lssm.z_scale[:, None]
    y_t = y.T                                               # (e, B)
    d_in = z.shape[0]
    slot = gp.head
    zr = [z[j] for j in range(d_in)]

    x_buf = gp.x.clone()
    x_buf[slot] = z
    y_buf = gp.y.clone()
    y_buf[slot] = y_t
    mask = gp.mask.clone()
    mask[slot] = 1.0

    betas, kinvs = [], []
    for d in range(gp.n_out):
        params = gp.params[d]
        parts = _KERNEL_PARTS[gp.kern_types[d]]
        noise_var = torch.exp(2.0 * gp.log_noise[d])
        kv = sum(_lane_kv_part(p, params, x_buf, zr, d_in)
                 for p in parts) * gp.mask[:, None]         # (n, B)
        w = torch.einsum("ijb,jb->ib", gp.kinv[d], kv)      # (n, B)
        knn = sum(_lane_kzz_part(p, params, zr, d_in) for p in parts)
        schur = torch.clamp(
            knn + noise_var + _JITTER - torch.sum(kv * w, dim=0), min=_JITTER)
        c = (torch.sum(kv * gp.beta[d], dim=0) - y_t[d]) / schur
        new_beta = gp.beta[d] + w * c[None, :]
        new_beta[slot] = -c
        new_kinv = gp.kinv[d] + w[:, None, :] * w[None, :, :] / schur
        slot_vec = -w / schur[None, :]
        slot_vec[slot] = 1.0 / schur
        new_kinv[slot, :, :] = slot_vec
        new_kinv[:, slot, :] = slot_vec
        betas.append(new_beta)
        kinvs.append(new_kinv)

    new_gp = gp.replace(x=x_buf, y=y_buf, mask=mask, beta=torch.stack(betas),
                        kinv=torch.stack(kinvs), head=gp.head + 1)
    return lssm.replace(gp=new_gp)


def lane_shrink_to_bucket(lssm: LaneGPSSM, n_free: int = 0, *,
                          min_bucket: int = 32) -> LaneGPSSM:
    """Slice the per-lane buffers to the smallest power-of-2 bucket holding
    the active points plus ``n_free`` upcoming appends (reads the mask on
    the host once). Lane models keep the lockstep prefix layout, and the
    identity padding makes every factor block-diagonal across the mask
    boundary, so the factors are sliced, not recomputed."""
    gp = lssm.gp
    n_need = int(gp.n_points) + n_free
    bucket = min_bucket
    while bucket < n_need:
        bucket *= 2
    bucket = min(bucket, gp.n_max)
    if bucket >= gp.n_max:
        return lssm
    return lssm.replace(gp=gp.replace(
        x=gp.x[:bucket], y=gp.y[:bucket], mask=gp.mask[:bucket],
        beta=gp.beta[:, :bucket], kinv=gp.kinv[:, :bucket, :bucket]))


def lane_expand_to(lssm: LaneGPSSM, n_max: int) -> LaneGPSSM:
    """Pad the per-lane buffers back out to ``n_max`` with inactive identity
    rows (mask 0, beta 0, K^-1 identity): the exact inverse of
    :func:`lane_shrink_to_bucket`."""
    gp = lssm.gp
    nb = gp.n_max
    if nb >= n_max:
        return lssm
    pad = n_max - nb

    def padded(arr, dims):
        shape = list(arr.shape)
        for dim in dims:
            shape[dim] = n_max
        out = arr.new_zeros(shape)
        out[tuple(slice(0, nb) if i in dims else slice(None)
                  for i in range(arr.ndim))] = arr
        return out

    kinv = padded(gp.kinv, (1, 2))
    idx = torch.arange(nb, n_max, device=kinv.device)
    kinv[:, idx, idx, :] = 1.0
    return lssm.replace(gp=gp.replace(
        x=padded(gp.x, (0,)), y=padded(gp.y, (0,)),
        mask=padded(gp.mask, (0,)), beta=padded(gp.beta, (1,)), kinv=kinv))

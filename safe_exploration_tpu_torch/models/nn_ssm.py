"""MC-dropout neural-network SSM — port of
``safe_exploration_tpu/models/nn_ssm.py``.

A dropout MLP whose predictive distribution comes from S stochastic forward
passes, a drop-in for the GP families wherever the runners and the portable
planners take a model (``predict_latent``, ``noise_var``, ``l_mu`` /
``l_sigma``). The concrete variant learns one keep probability per hidden
layer (``keep_logit``) through the concrete relaxation.

The JAX package derives the S prediction masks from a stored PRNG key; the
port stores what the masks are made of: per hidden layer the S passes'
uniforms ``mask_u`` (S, width), from which ``keep = u < p`` and the mask
``keep / p``. ``p`` is ``keep_prob``, or for the concrete variant
``clip(sigmoid(keep_logit), 0.05, 0.99)``, so there the masks follow the
learned p after each fit. :func:`mc_resample` draws new uniforms.

Prediction is a pure function of the model state: the S passes run as one
batched product, at inputs (..., d_in). The mean Jacobian is the closed form
through the tanh layers (:func:`mc_predict_mean_jac`). :func:`mc_fit` is
fixed-budget Adam (decoupled weight decay for the plain variant) on the
masked squared error, written in optax's order of operations, with its
draws given or made on the model's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from safe_exploration_tpu_torch.models.gp import adam_fit

__all__ = ["McDropoutSSM", "make_mc_dropout_ssm", "mc_draw_shapes",
           "mc_fit", "mc_fit_draws", "mc_update_data", "mc_resample",
           "mc_predict_mean_jac", "dropout_masks", "layer_keep_probs"]

# the concrete relaxation's temperature and the bounds of its uniforms
_TEMP = 0.1
_U_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class McDropoutSSM:
    """Dropout-MLP residual-dynamics model with its replay buffer."""

    n_s: int
    n_samples: int            # S MC passes
    keep_prob: float
    weights: tuple            # ((w (fan_in, fan_out), b (fan_out,)), ...)
    mask_u: tuple             # per hidden layer: (S, width) uniforms
    log_noise: torch.Tensor   # (e,) log aleatoric noise std
    l_mu: torch.Tensor        # (e,)
    l_sigma: torch.Tensor     # (e,)
    x: torch.Tensor           # (n_max, d_in) padded raw inputs (x, u)
    y: torch.Tensor           # (n_max, e)
    mask: torch.Tensor        # (n_max,)
    head: int                 # ring-buffer write pointer, modulo n_max
    keep_logit: torch.Tensor | None = None  # (n_hidden,) concrete variant

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    def predict_latent(self, z: torch.Tensor):
        """Mean and population variance (+1e-12) over the S passes at
        inputs z (..., d_in) -> ((..., e), (..., e))."""
        outs = _mc_forward(self, z)                  # (S, ..., e)
        mean = torch.mean(outs, dim=0)
        dev = outs - mean
        return mean, torch.mean(dev * dev, dim=0) + 1e-12

    def noise_var(self) -> torch.Tensor:
        return torch.exp(2.0 * self.log_noise)

    def replace(self, **changes) -> "McDropoutSSM":
        return dataclasses.replace(self, **changes)


def layer_keep_probs(ssm: McDropoutSSM) -> list:
    """Per-hidden-layer keep probabilities: ``keep_prob`` (a Python float),
    or the concrete variant's clipped sigmoids of ``keep_logit``."""
    n_hidden = len(ssm.weights) - 1
    if ssm.keep_logit is None:
        return [ssm.keep_prob] * n_hidden
    p = torch.clamp(torch.sigmoid(ssm.keep_logit), 0.05, 0.99)
    return [p[i] for i in range(n_hidden)]


def dropout_masks(ssm: McDropoutSSM) -> list:
    """The S passes' inverted-dropout masks, (S, width) per hidden layer,
    in the weights' dtype."""
    return [(u < p).to(w.dtype) / p for u, p, (w, _) in
            zip(ssm.mask_u, layer_keep_probs(ssm), ssm.weights)]


def _forward(weights: tuple, masks: list, h: torch.Tensor) -> torch.Tensor:
    """The MLP with each hidden layer's output times its mask (broadcast
    against the hidden activations)."""
    for (w, b), m in zip(weights[:-1], masks):
        h = torch.tanh(h @ w + b) * m
    w, b = weights[-1]
    return h @ w + b


def _mc_forward(ssm: McDropoutSSM, z: torch.Tensor) -> torch.Tensor:
    """The S passes at z (..., d_in) -> (S, ..., e)."""
    lead = z.shape[:-1]
    masks = [m[:, None, :] for m in dropout_masks(ssm)]
    outs = _forward(ssm.weights, masks, z.reshape(-1, z.shape[-1]))
    return outs.reshape((outs.shape[0],) + lead + (outs.shape[-1],))


def mc_predict_mean_jac(ssm: McDropoutSSM, z: torch.Tensor):
    """Mean, variance and the closed-form mean Jacobian at z (..., d_in)
    -> (..., e), (..., e), (..., e, d_in): the average over the passes of
    ``W_out^T diag(m_L (1 - h_L^2)) W_L^T ... diag(m_1 (1 - h_1^2))
    W_1^T``."""
    lead, d_in = z.shape[:-1], z.shape[-1]
    h = z.reshape(-1, d_in)
    gains = []
    for (w, b), m in zip(ssm.weights[:-1], dropout_masks(ssm)):
        t = torch.tanh(h @ w + b)
        m = m[:, None, :]
        gains.append(m * (1.0 - t * t))                # (S, N, width)
        h = t * m
    w_out, b_out = ssm.weights[-1]
    outs = h @ w_out + b_out                            # (S, N, e)
    g = w_out.T                                         # (e, width)
    for (w, _), gain in zip(reversed(ssm.weights[:-1]), reversed(gains)):
        g = (g * gain[..., None, :]) @ w.T              # (S, N, e, fan_in)
    mean = torch.mean(outs, dim=0)
    dev = outs - mean
    var = torch.mean(dev * dev, dim=0) + 1e-12
    e = outs.shape[-1]
    return (mean.reshape(lead + (e,)), var.reshape(lead + (e,)),
            torch.mean(g, dim=0).reshape(lead + (e, d_in)))


def _dims(d_in: int, hidden: tuple, e: int) -> tuple:
    return (d_in,) + tuple(int(h) for h in hidden) + (e,)


def mc_draw_shapes(d_in: int, e: int, *, hidden: tuple = (64, 64),
                   n_samples: int = 16) -> dict:
    """The shapes of :func:`make_mc_dropout_ssm`'s draws: ``w{i}`` (fan_in,
    fan_out) standard normals per layer, ``u{i}`` (S, width) uniforms on
    [0, 1) per hidden layer."""
    dims = _dims(d_in, hidden, e)
    shapes = {f"w{i}": ("normal", (dims[i], dims[i + 1]))
              for i in range(len(dims) - 1)}
    shapes.update({f"u{i}": ("uniform", (n_samples, dims[i + 1]))
                   for i in range(len(dims) - 2)})
    return shapes


def _draw(shapes: dict, generator: torch.Generator, dtype) -> dict:
    kw = {"generator": generator, "dtype": dtype, "device": generator.device}
    return {k: (torch.randn if kind == "normal" else torch.rand)(shape, **kw)
            for k, (kind, shape) in shapes.items()}


def make_mc_dropout_ssm(x: torch.Tensor, u: torch.Tensor, y: torch.Tensor,
                        *, n_max: int, l_mu: torch.Tensor,
                        l_sigma: torch.Tensor, hidden: tuple = (64, 64),
                        n_samples: int = 16, keep_prob: float = 0.9,
                        log_noise: float = -3.0, concrete: bool = False,
                        generator: torch.Generator | None = None,
                        draws: dict | None = None) -> McDropoutSSM:
    """Build the (untrained) model from initial transitions on the device of
    ``x``: He-normal weights (scale sqrt(2 / fan_in)), zero biases, the
    prediction uniforms, and for ``concrete`` one keep logit per hidden
    layer at logit(clip(keep_prob, 0.05, 0.99)). ``draws``
    (:func:`mc_draw_shapes`' keys) replaces the draws of ``generator``
    (``None``: a CPU generator seeded 0), which are made in ``x``'s
    dtype."""
    z = torch.cat([x, u], dim=-1)
    n, d_in = z.shape
    e = y.shape[1]
    kw = {"dtype": x.dtype, "device": x.device}
    shapes = mc_draw_shapes(d_in, e, hidden=hidden, n_samples=n_samples)
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = _draw(shapes, generator, x.dtype)
    dims = _dims(d_in, hidden, e)
    weights = tuple(
        (math.sqrt(2.0 / dims[i]) * torch.as_tensor(draws[f"w{i}"]).to(**kw),
         torch.zeros((dims[i + 1],), **kw))
        for i in range(len(dims) - 1))
    # the uniforms keep their own dtype (JAX draws the plain variant's in
    # p's, f64 under x64)
    mask_u = tuple(torch.as_tensor(draws[f"u{i}"]).to(device=x.device)
                   for i in range(len(dims) - 2))
    keep_logit = None
    if concrete:
        p0 = torch.clamp(torch.tensor(keep_prob, **kw), 0.05, 0.99)
        keep_logit = (torch.log(p0) - torch.log1p(-p0)).repeat(len(dims) - 2)
    xp = torch.zeros((n_max, d_in), **kw)
    yp = torch.zeros((n_max, e), **kw)
    mask = torch.zeros((n_max,), **kw)
    xp[:n], yp[:n], mask[:n] = z, y, 1.0
    return McDropoutSSM(
        n_s=x.shape[1], n_samples=n_samples, keep_prob=keep_prob,
        weights=weights, mask_u=mask_u,
        log_noise=torch.full((e,), log_noise, **kw), l_mu=l_mu,
        l_sigma=l_sigma, x=xp, y=yp, mask=mask, head=n,
        keep_logit=keep_logit)


def mc_update_data(ssm: McDropoutSSM, x: torch.Tensor, u: torch.Tensor,
                   y: torch.Tensor) -> McDropoutSSM:
    """Append transitions to the replay buffer, overwriting the oldest when
    full; a batch larger than the buffer keeps its newest n_max rows."""
    z = torch.cat([x, u], dim=-1)
    n_max = ssm.x.shape[0]
    if z.shape[0] > n_max:
        z, y = z[-n_max:], y[-n_max:]
    k = z.shape[0]
    idx = (ssm.head + torch.arange(k, device=z.device)) % n_max
    return ssm.replace(
        x=ssm.x.index_copy(0, idx, z.to(ssm.x.dtype)),
        y=ssm.y.index_copy(0, idx, y.to(ssm.y.dtype)),
        mask=ssm.mask.index_fill(0, idx, 1.0),
        head=(ssm.head + k) % n_max)


def mc_resample(ssm: McDropoutSSM, generator: torch.Generator
                ) -> McDropoutSSM:
    """Draw new prediction uniforms (a fresh epistemic sample set) from
    ``generator``, in the present ones' dtype."""
    return ssm.replace(mask_u=tuple(
        torch.rand(u.shape, generator=generator, dtype=u.dtype,
                   device=generator.device).to(u.device)
        for u in ssm.mask_u))


def mc_fit_draws(hidden: tuple, iters: int, *, n_max: int | None = None,
                 generator: torch.Generator | None = None,
                 dtype=torch.float32, device=None) -> tuple:
    """The fit's draws, per hidden layer of widths ``hidden``: the plain
    variant's (``n_max`` None) one mask a step (iters, width) uniforms on
    [0, 1); the concrete variant's relaxed masks, one per point of the
    ``n_max`` buffer and step, (iters, n_max, width) uniforms on
    (1e-6, 1 - 1e-6). From ``generator`` (``None``: a generator seeded 0
    on ``device``, as the JAX package's fixed PRNGKey(0)), in ``dtype``,
    on ``device`` (``None``: the generator's)."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    lead = (iters,) if n_max is None else (iters, n_max)
    kw = {"generator": generator, "dtype": dtype,
          "device": generator.device}
    out = []
    for width in hidden:
        u = torch.rand(lead + (int(width),), **kw)
        if n_max is not None:
            u = torch.clamp(u * ((1.0 - _U_EPS) - _U_EPS) + _U_EPS,
                            min=_U_EPS)
        out.append(u.to(device or generator.device))
    return tuple(out)


def mc_fit(ssm: McDropoutSSM, *, iters: int = 500, lr: float = 3e-3,
           weight_decay: float = 1e-5, draws: tuple | None = None
           ) -> McDropoutSSM:
    """``iters`` Adam steps on the masked squared error over the buffer,
    divided by max(n, 1).

    Plain variant: optax's ``adamw`` (decoupled decay on every leaf,
    biases included), one dropout mask a step shared by all points.
    Concrete variant: plain Adam on the weights and ``keep_logit``, relaxed
    masks per point (temperature 0.1), plus the concrete-dropout
    regularizer per hidden layer, ``weight_decay ||W||^2 / p`` and
    ``1e-3 width / n (p log p + (1 - p) log(1 - p))``. ``draws``
    (:func:`mc_fit_draws`' shapes; ``None``: that function's default
    draws) are the steps' uniforms."""
    concrete = ssm.keep_logit is not None
    w0 = ssm.weights[0][0]
    if draws is None:
        draws = mc_fit_draws(tuple(w.shape[1] for w, _ in ssm.weights[:-1]),
                             iters, n_max=ssm.x.shape[0] if concrete
                             else None, dtype=w0.dtype, device=w0.device)
    # the plain variant's uniforms keep their dtype (JAX draws them in p's)
    draws = tuple(torch.as_tensor(d).to(
        device=w0.device, dtype=w0.dtype if concrete else None)
        for d in draws)
    n_layers = len(ssm.weights)
    n_eff = torch.clamp(torch.sum(ssm.mask), min=1.0)
    xb, yb, mb = ssm.x, ssm.y, ssm.mask

    def unflat(leaves):
        weights = tuple((leaves[2 * i], leaves[2 * i + 1])
                        for i in range(n_layers))
        return weights, (leaves[-1] if concrete else None)

    def loss(leaves, *step_u):
        weights, keep_logit = unflat(leaves)
        model = ssm.replace(weights=weights, keep_logit=keep_logit)
        probs = layer_keep_probs(model)
        if concrete:
            masks = []
            for u, p in zip(step_u, probs):
                zr = torch.sigmoid((torch.log(p) - torch.log1p(-p)
                                    + torch.log(u) - torch.log1p(-u)) / _TEMP)
                masks.append(zr / p)
        else:
            masks = [(u < p).to(w.dtype) / p
                     for u, p, (w, _) in zip(step_u, probs, weights)]
        pred = _forward(weights, masks, xb)
        total = mb * torch.sum((pred - yb) ** 2, dim=-1)
        obj = torch.sum(total) / n_eff
        if concrete:
            reg = torch.zeros((), dtype=obj.dtype, device=obj.device)
            for (w, _), p in zip(weights[:-1], probs):
                q = 1.0 - p
                ent = p * torch.log(p) + q * torch.log(q)
                reg = reg + weight_decay * torch.sum(w * w) / p
                reg = reg + (1e-3 * w.shape[1] / n_eff) * ent
            obj = obj + reg
        return obj

    theta = [t for wb in ssm.weights for t in wb]
    if concrete:
        theta.append(ssm.keep_logit)
    theta = adam_fit(loss, theta, n_prior=None, iters=iters, lr=lr,
                     prior_strength=0.0,
                     weight_decay=0.0 if concrete else weight_decay,
                     step_inputs=draws)
    weights, keep_logit = unflat(theta)
    return ssm.replace(weights=weights, keep_logit=keep_logit)

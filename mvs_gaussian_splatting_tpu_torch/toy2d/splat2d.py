"""Single-image 2D Gaussian splatting fit — the small toy.

Port of the JAX package's ``toy2d/splat2d.py`` (itself re-creating the
vendored OutofAi/2D-Gaussian-Splatting, 2d_gaussian_splatting.py): fit ~1K
anisotropic 2D Gaussians to one image with L1+D-SSIM loss (λ=0.2,
:200-202), alpha-weighted sum compositing with clamp (:116-121), pruning by
alpha < 0.01 (:306-315) and gradient/size-thresholded split/clone into a
fixed-capacity slot pool (:344-383). The render is the dense per-pixel
quadratic form on the pixel grid (the JAX package has no kernel here
either), and Adam follows optax's update order. Every random draw comes
from a CPU ``torch.Generator`` seeded with ``seed``, or is passed in as
data (``init``, ``jitters``); the fit runs on ``device``, the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.grow import nonzero_padded
from ..utils.losses import dssim_l1_loss


class Splat2DParams(NamedTuple):
    sigma: torch.Tensor   # [C, 2] pre-sigmoid scales
    rho: torch.Tensor     # [C] pre-tanh correlation
    alpha: torch.Tensor   # [C] logit opacity
    color: torch.Tensor   # [C, 3] logit color
    xy: torch.Tensor      # [C, 2] center in [-1, 1] (tanh-activated)


def params_from_numpy(params, device="cuda") -> Splat2DParams:
    """Splat2DParams of float32 tensors on ``device`` from arrays keyed by
    field name (a mapping, or a named tuple such as the JAX toy's)."""
    d = params if isinstance(params, Mapping) else params._asdict()
    return Splat2DParams(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device)
        for k in Splat2DParams._fields})


def init_splats(capacity: int, n_alive: int,
                generator: Optional[torch.Generator] = None, device="cuda"):
    """(params, alive): uniform draws in the JAX toy's ranges, the first
    ``n_alive`` slots alive."""
    gen = generator if generator is not None else torch.Generator()

    def uniform(shape, lo, hi):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(device)

    params = Splat2DParams(
        sigma=uniform((capacity, 2), -2.0, -1.0),
        rho=torch.zeros(capacity, device=device),
        alpha=uniform((capacity,), -1.0, 1.0),
        color=uniform((capacity, 3), -1.0, 1.0),
        xy=uniform((capacity, 2), -1.2, 1.2),
    )
    alive = torch.arange(capacity, device=device) < n_alive
    return params, alive


def render_splats2d(params: Splat2DParams, alive: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """Sum-composited image [3, H, W] in [0, 1]."""
    sx = torch.sigmoid(params.sigma[:, 0])
    sy = torch.sigmoid(params.sigma[:, 1])
    rho = torch.tanh(params.rho)
    a = torch.sigmoid(params.alpha) * alive.to(params.alpha.dtype)
    c = torch.sigmoid(params.color)
    cx = torch.tanh(params.xy[:, 0])
    cy = torch.tanh(params.xy[:, 1])

    # inverse covariance of [[sx², ρ·sx·sy], [ρ·sx·sy, sy²]]
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    inv_a = sy ** 2 / det
    inv_c = sx ** 2 / det
    inv_b = -rho * sx * sy / det

    dev = params.xy.device
    ys = torch.linspace(-1.0, 1.0, height, device=dev)
    xs = torch.linspace(-1.0, 1.0, width, device=dev)
    dx = xs[None, None, :] - cx[:, None, None]     # [C, 1, W]
    dy = ys[None, :, None] - cy[:, None, None]     # [C, H, 1]
    q = (inv_a[:, None, None] * dx * dx + inv_c[:, None, None] * dy * dy
         + 2 * inv_b[:, None, None] * dx * dy)
    g = torch.exp(-0.5 * q)                        # [C, H, W]
    # Σ_n g[n]·c[n]·a[n] as one matrix product over the splats
    img = ((c * a[:, None]).T @ g.reshape(g.shape[0], -1)).reshape(
        3, height, width)
    return torch.clamp(img, 0.0, 1.0)


def _drop_set(leaf: torch.Tensor, dest: torch.Tensor, values: torch.Tensor,
              add: bool = False) -> torch.Tensor:
    """``leaf.at[dest].set(values, mode="drop")`` (or ``.add``): rows of
    ``dest`` equal to the capacity are dropped."""
    ext = torch.cat([leaf, leaf[:1]])
    ext = ext.index_put((dest,), values, accumulate=add)
    return ext[:leaf.shape[0]]


def _densify(params: Splat2DParams, alive: torch.Tensor,
             grads_xy: torch.Tensor, jitter: torch.Tensor, *,
             grad_threshold: float, size_threshold: float):
    """Prune by opacity, then split (large) / clone (small) high-grad splats
    into free slots; ``jitter`` [C, 2] are the standard normal draws of the
    split children's centre offsets. Fixed shapes, no host sync."""
    capacity = alive.shape[0]
    dev = alive.device
    arange = torch.arange(capacity, device=dev)

    opac = torch.sigmoid(params.alpha)
    alive = alive & (opac >= 0.01)

    gnorm = torch.linalg.vector_norm(grads_xy, dim=-1)
    size = torch.sigmoid(params.sigma).max(dim=-1).values
    hot = alive & (gnorm > grad_threshold)
    sel_split = hot & (size > size_threshold)
    sel_clone = hot & ~(size > size_threshold)

    free_idx = nonzero_padded(~alive, capacity, capacity)
    n_free = (~alive).sum()

    def scatter_copy(tree, src, dest):
        src_c = torch.clamp(src, 0, capacity - 1)
        return type(tree)(*[_drop_set(leaf, dest, leaf[src_c])
                            for leaf in tree])

    # clones first
    clone_src = nonzero_padded(sel_clone, capacity, capacity)
    n_clone = torch.minimum(sel_clone.sum(), n_free)
    clone_dest = torch.where(arange < n_clone, free_idx, capacity)
    params = scatter_copy(params, clone_src, clone_dest)
    alive = _drop_set(alive, clone_dest, torch.ones_like(clone_dest,
                                                         dtype=torch.bool))

    # splits: shrink parent, copy child into a free slot with jittered center
    split_src = nonzero_padded(sel_split, capacity, capacity)
    slot2 = n_clone + arange
    n_split = torch.minimum(sel_split.sum(),
                            torch.clamp(n_free - n_clone, min=0))
    split_dest = torch.where(
        arange < n_split, free_idx[torch.clamp(slot2, 0, capacity - 1)],
        capacity)
    params = scatter_copy(params, split_src, split_dest)
    jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev) * 0.02
    shrink = params.sigma - math.log(2.0)   # sigmoid-space halving (approx)
    src_ok = torch.where(arange < sel_split.sum(), split_src, capacity)
    src_c = torch.clamp(src_ok, 0, capacity - 1)
    params = params._replace(
        sigma=_drop_set(params.sigma, src_ok, shrink[src_c]),
        xy=_drop_set(params.xy, split_dest, jitter[src_c], add=True),
    )
    params = params._replace(
        sigma=_drop_set(params.sigma, split_dest,
                        shrink[torch.clamp(split_src, 0, capacity - 1)]))
    alive = _drop_set(alive, split_dest, torch.ones_like(split_dest,
                                                         dtype=torch.bool))
    return params, alive


class _Adam:
    """optax.adam's update, in its order: both moments, the f32 bias
    corrections, m̂ / (√v̂ + ε), then the step times −lr."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.reset(params)

    def reset(self, params):
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def step(self, params, grads):
        self.count += 1
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g ** 2) + self.b2 * self.nu[i]
            m_hat = self.mu[i] / bc1.to(p.device)
            v_hat = self.nu[i] / bc2.to(p.device)
            out.append(p + (m_hat / (torch.sqrt(v_hat) + self.eps))
                       * (-self.lr))
        return type(params)(*out)


def fit_image(target: np.ndarray, *, capacity: int = 5000, n_init: int = 1000,
              epochs: int = 500, lr: float = 0.01,
              densification_interval: int = 100,
              grad_threshold: float = 0.002, size_threshold: float = 0.75,
              lambda_dssim: float = 0.2, seed: int = 0, log_fn=None,
              device="cuda", init=None,
              jitters: Optional[Sequence] = None):
    """Fit 2D Gaussians to target [3, H, W] in [0,1]. Returns
    (params, alive, history dict). ``init`` is a (params, alive) start and
    ``jitters`` the [capacity, 2] draws of each densification round, in
    order; both are drawn from a generator seeded with ``seed`` unless
    given."""
    height, width = target.shape[1], target.shape[2]
    tgt = torch.as_tensor(np.asarray(target, np.float32), device=device)
    gen = torch.Generator().manual_seed(seed)
    if init is None:
        params, alive = init_splats(capacity, n_init, gen, device)
    else:
        params, alive = init
    alive = alive.to(device)
    params = Splat2DParams(*[p.detach().to(device) for p in params])
    adam = _Adam(params, lr)
    rounds = iter(jitters) if jitters is not None else None

    history = {"loss": [], "n_alive": []}
    for epoch in range(epochs):
        leaves = [p.detach().requires_grad_() for p in params]
        loss = dssim_l1_loss(render_splats2d(Splat2DParams(*leaves), alive,
                                             height, width), tgt,
                             lambda_dssim)
        grads = Splat2DParams(*torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            params = adam.step(Splat2DParams(*[p.detach() for p in leaves]),
                               grads)
            if epoch > 0 and epoch % densification_interval == 0:
                jitter = (next(rounds) if rounds is not None
                          else torch.randn((capacity, 2), generator=gen))
                params, alive = _densify(
                    params, alive, grads.xy, jitter,
                    grad_threshold=grad_threshold,
                    size_threshold=size_threshold)
                adam.reset(params)    # the reference re-creates the optimizer
        if epoch % 50 == 0:
            history["loss"].append(float(loss.detach()))
            history["n_alive"].append(int(alive.sum()))
            if log_fn:
                log_fn(f"epoch {epoch}: loss {history['loss'][-1]:.4f} "
                       f"alive {int(alive.sum())}")
    return params, alive, history


def main(argv=None):
    """Script entry mirroring the reference toy's config.yml workflow
    (2d_gaussian_splatting.py:222-238): fit an image, save the render.

    Accepts the reference's config.yml keys (primary_samples,
    backup_samples, num_epochs, densification_interval, learning_rate,
    image_file_name, gradient_threshold, gaussian_threshold, image_size);
    CLI flags override.
    """
    import argparse

    from PIL import Image

    parser = argparse.ArgumentParser(description="2D Gaussian splat fit")
    parser.add_argument("--config", default="", help="reference-format yml")
    parser.add_argument("--image", default="")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--out", default="2d_fit.png")
    parser.add_argument("--device", default="cuda",
                        help="torch device to fit on (default cuda)")
    args = parser.parse_args(argv)

    cfg = {}
    if args.config:
        import yaml
        with open(args.config) as f:
            cfg = yaml.safe_load(f)
    image_path = args.image or cfg.get("image_file_name", "")
    if not image_path:
        parser.error("need --image or image_file_name in --config")
    size = cfg.get("image_size", [256, 256, 3])
    img = Image.open(image_path).convert("RGB").resize((size[1], size[0]))
    target = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0

    n_init = int(cfg.get("primary_samples", 1000))
    capacity = n_init + int(cfg.get("backup_samples", 4000))
    epochs = args.epochs or int(cfg.get("num_epochs", 500))
    params, alive, history = fit_image(
        target, capacity=capacity, n_init=n_init, epochs=epochs,
        lr=float(cfg.get("learning_rate", 0.01)),
        densification_interval=int(cfg.get("densification_interval", 100)),
        grad_threshold=float(cfg.get("gradient_threshold", 0.002)),
        size_threshold=float(cfg.get("gaussian_threshold", 0.75)),
        log_fn=print, device=args.device)
    with torch.no_grad():
        out = render_splats2d(params, alive, target.shape[1],
                              target.shape[2]).cpu().numpy()
    Image.fromarray((np.clip(out, 0, 1).transpose(1, 2, 0) * 255)
                    .astype(np.uint8)).save(args.out)
    print(f"saved {args.out} (loss history {history['loss'][-1]:.4f}, "
          f"{int(alive.sum())} splats)")


if __name__ == "__main__":
    main()

"""Codebook quantization for Gaussian attributes (the compression pathway).

Port of the JAX package's ``models/quantize.py`` (the reference vendors
VQGAN-style quantizers, quantize.py: MixQuantize :10-194, GumbelQuantize
:200-366, ArgmaxQuantize :371-502):

- ``vq``: nearest-code lookup with straight-through gradients and
  commitment/codebook losses (the MixQuantize mechanism);
- ``gumbel``: Gumbel-softmax relaxed code selection with temperature;
- ``argmax``: deterministic straight-through argmax over code logits;

plus EMA k-means codebook fitting and the post-training compressor of
Gaussian attribute arrays (f_rest / scaling / rotation as uint codes and a
codebook each). Every random draw comes from a CPU ``torch.Generator`` and
is then moved to the data's device, so a card and a CPU run of one seed
take the same draws; each can also be passed in as data (the initial
indices, the re-seed indices of every iteration, the Gumbel uniforms).
The distance product is a library ``torch.matmul``, as the JAX package's
is a plain XLA dot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class CodebookState(NamedTuple):
    codebook: torch.Tensor   # [K, D]
    counts: torch.Tensor     # [K] EMA usage
    sums: torch.Tensor       # [K, D] EMA sums


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator()


def init_codebook(num_codes: int, dim: int, data=None,
                  generator: Optional[torch.Generator] = None,
                  idx=None, noise=None, device="cuda") -> CodebookState:
    """Data-sampled codebook (rows ``data[idx]``, ``idx`` drawn uniformly
    unless given) or, without ``data``, a random one (``noise`` [K, dim]
    standard normal draws times 0.1)."""
    if data is not None:
        if idx is None:
            idx = torch.randint(0, data.shape[0], (num_codes,),
                                generator=_generator(generator))
        cb = data[torch.as_tensor(idx, device=data.device).long()]
        device = data.device
    else:
        if noise is None:
            noise = torch.randn((num_codes, dim),
                                generator=_generator(generator))
        cb = torch.as_tensor(noise, dtype=torch.float32, device=device) * 0.1
    return CodebookState(codebook=cb,
                         counts=torch.ones(num_codes, device=cb.device),
                         sums=cb)


def nearest_code(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x [N, D], codebook [K, D] → code indices [N] (one matrix product)."""
    d2 = ((x * x).sum(-1, keepdim=True)
          - 2.0 * torch.matmul(x, codebook.T)
          + (codebook * codebook).sum(-1)[None, :])
    return torch.argmin(d2, dim=-1)


def vq_quantize(x: torch.Tensor, codebook: torch.Tensor,
                beta: float = 0.25
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Straight-through VQ: returns (quantized, codes, loss).

    loss = ‖sg(x) − e‖² + β·‖x − sg(e)‖² (VQ-VAE commitment form).
    """
    codes = nearest_code(x, codebook)
    e = codebook[codes]
    loss = (((x.detach() - e) ** 2).mean()
            + beta * ((x - e.detach()) ** 2).mean())
    quantized = x + (e - x).detach()
    return quantized, codes, loss


def gumbel_quantize(logits: torch.Tensor, codebook: torch.Tensor,
                    tau: float = 1.0, hard: bool = False,
                    generator: Optional[torch.Generator] = None,
                    uniform=None):
    """Gumbel-softmax code mixture: logits [N, K] → (quantized [N, D],
    probs). ``uniform`` are the U[0, 1) draws of the Gumbel noise."""
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=_generator(generator))
    u = torch.as_tensor(uniform, dtype=logits.dtype, device=logits.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((logits + g) / tau, dim=-1)
    if hard:
        idx = torch.argmax(y, dim=-1)
        y_hard = F.one_hot(idx, logits.shape[-1]).to(y.dtype)
        y = y_hard - y.detach() + y
    return y @ codebook, y


def argmax_quantize(logits: torch.Tensor, codebook: torch.Tensor):
    """Deterministic straight-through argmax selection (ArgmaxQuantize)."""
    y_soft = torch.softmax(logits, dim=-1)
    idx = torch.argmax(y_soft, dim=-1)
    y_hard = F.one_hot(idx, logits.shape[-1]).to(y_soft.dtype)
    y = y_hard - y_soft.detach() + y_soft
    return y @ codebook, idx


def kmeans_update(state: CodebookState, x: torch.Tensor,
                  decay: float = 0.99, eps: float = 1e-5) -> CodebookState:
    """One EMA k-means step over a batch (codebook fitting)."""
    codes = nearest_code(x, state.codebook)
    onehot = F.one_hot(codes, state.codebook.shape[0]).to(x.dtype)
    counts = decay * state.counts + (1 - decay) * onehot.sum(0)
    sums = decay * state.sums + (1 - decay) * (onehot.T @ x)
    codebook = sums / (counts[:, None] + eps)
    return CodebookState(codebook=codebook, counts=counts, sums=sums)


def fit_codebook(data: torch.Tensor, num_codes: int, iters: int = 50,
                 dead_count: float = 1e-3,
                 generator: Optional[torch.Generator] = None,
                 init_idx=None, reseed_idx=None) -> CodebookState:
    """Fit a codebook to [N, D] data with EMA k-means.

    Codes whose EMA assignment count decays below ``dead_count`` (never or
    rarely assigned) are re-seeded to random data points each iteration —
    without this, empty clusters collapse toward the zero vector via
    sums/(counts+eps) and later snap points to spurious near-zero centroids.
    ``init_idx`` [K] are the initial rows, ``reseed_idx`` [iters, K] each
    iteration's re-seed rows; both are drawn from ``generator`` unless
    given.
    """
    gen = _generator(generator)
    n = data.shape[0]
    if init_idx is None:
        init_idx = torch.randint(0, n, (num_codes,), generator=gen)
    if reseed_idx is None:
        reseed_idx = torch.randint(0, n, (iters, num_codes), generator=gen)
    reseed_idx = torch.as_tensor(reseed_idx, device=data.device).long()
    state = init_codebook(num_codes, data.shape[-1], data, idx=init_idx)
    for i in range(iters):
        state = kmeans_update(state, data)
        dead = state.counts < dead_count
        seed_rows = data[reseed_idx[i]]
        state = CodebookState(
            codebook=torch.where(dead[:, None], seed_rows, state.codebook),
            counts=torch.where(dead, torch.ones_like(state.counts),
                               state.counts),
            sums=torch.where(dead[:, None], seed_rows, state.sums))
    return state


def compress_gaussians(gaussians: dict, num_codes: int = 256,
                       attributes=("f_rest", "scaling", "rotation"),
                       generator: Optional[torch.Generator] = None,
                       device="cuda", draws: Optional[dict] = None) -> dict:
    """Post-training compression: per-attribute codebooks + codes.

    gaussians: compacted raw arrays (numpy or tensors). Returns
    {"codes": {attr: [N] int64}, "codebooks": {attr: [K, D]},
    "dequantized": {attr: [N, ...]}} on ``device``, plus the untouched
    attributes as given. ``draws`` maps an attribute to its
    (init_idx, reseed_idx) for :func:`fit_codebook`; the others are drawn
    from ``generator``, one attribute after another.
    """
    gen = _generator(generator)
    out = {"codes": {}, "codebooks": {}, "dequantized": {}}
    with torch.no_grad():
        for attr in attributes:
            x = torch.as_tensor(gaussians[attr], dtype=torch.float32,
                                device=device)
            flat = x.reshape(x.shape[0], -1)
            init_idx, reseed_idx = (draws or {}).get(attr, (None, None))
            state = fit_codebook(flat, num_codes, generator=gen,
                                 init_idx=init_idx, reseed_idx=reseed_idx)
            codes = nearest_code(flat, state.codebook)
            out["codes"][attr] = codes
            out["codebooks"][attr] = state.codebook
            out["dequantized"][attr] = state.codebook[codes].reshape(x.shape)
    for k, v in gaussians.items():
        if k not in attributes:
            out[k] = v
    return out

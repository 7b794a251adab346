"""Masked autoregressive flow (MAF) initial-state model (counterpart of
``prob_mbrl_tpu/models/flows.py``): a stack of MADE blocks, masked dense
nets [D -> hidden -> hidden -> 2 D] that predict each dimension's (mu,
log_scale) from the dimensions before it, the order reversed on odd blocks,
over a standard-normal base.

``log_prob`` is one masked pass a block. ``sample`` inverts each block
dimension by dimension in degree order (D is a state's size: small). Params
are a list of per-block dicts with JAX's names and ``(din, dout)`` layout.
"""
import dataclasses
import math

import torch

from ..utils.core import resolve_device

_LOG2PI = math.log(2.0 * math.pi)


def _made_masks(D, hidden, reverse=False, device=None):
    """Degree-based MADE masks (m1 [D, H], m2 [H, H], m3 [H, 2 D]) and the
    input degrees."""
    in_deg = torch.arange(1, D + 1, device=device)
    if reverse:
        in_deg = torch.flip(in_deg, (0,))
    h_deg = (torch.arange(hidden, device=device) % max(1, D - 1)) + 1
    out_deg = torch.cat([in_deg, in_deg])  # (mu, log_s) a dimension
    m1 = (h_deg[None, :] >= in_deg[:, None]).float()
    m2 = (h_deg[None, :] >= h_deg[:, None]).float()
    m3 = (out_deg[None, :] > h_deg[:, None]).float()
    return m1, m2, m3, in_deg


@dataclasses.dataclass(frozen=True)
class MAFSpec:
    dims: int
    n_blocks: int = 5
    hidden: int = 64
    max_log_scale: float = 5.0

    def init(self, generator, dtype=torch.float32, device=None):
        """Per block: normal weights (0.1, 0.1, 0.01 std), zero biases."""
        device = resolve_device(device)
        D, H = self.dims, self.hidden

        def normal(shape, std):
            return std * torch.randn(shape, generator=generator, dtype=dtype,
                                     device=device)

        def zeros(n):
            return torch.zeros((n,), dtype=dtype, device=device)

        return [{'w1': normal((D, H), 0.1), 'b1': zeros(H),
                 'w2': normal((H, H), 0.1), 'b2': zeros(H),
                 'w3': normal((H, 2 * D), 0.01), 'b3': zeros(2 * D)}
                for _ in range(self.n_blocks)]

    def _block_params(self, p, x, reverse):
        """A block's (mu, log_s), log_s clipped to +-max_log_scale."""
        m1, m2, m3, _ = _made_masks(self.dims, self.hidden, reverse,
                                    x.device)
        h = torch.relu(x @ (p['w1'] * m1) + p['b1'])
        h = torch.relu(h @ (p['w2'] * m2) + p['b2'])
        out = h @ (p['w3'] * m3) + p['b3']
        mu, log_s = out[..., :self.dims], out[..., self.dims:]
        return mu, torch.clamp(log_s, -self.max_log_scale, self.max_log_scale)

    def log_prob(self, params, x):
        """The exact log density of the rows of ``x``."""
        log_det = 0.0
        z = x
        for b, p in enumerate(params):
            mu, log_s = self._block_params(p, z, reverse=bool(b % 2))
            z = (z - mu) * torch.exp(-log_s)
            log_det = log_det - torch.sum(log_s, -1)
        return -0.5 * torch.sum(z ** 2 + _LOG2PI, -1) + log_det

    def sample(self, params, generator=None, n_samples=None, z=None):
        """``n_samples`` draws: the base draw ``z`` [n, D] (JAX's
        ``normal(key, (n, D))``), else drawn from ``generator``, pushed back
        through the blocks. A dimension of degree d depends only on those
        of smaller degree, so each block fills them in degree order; ``x``
        is built out of place, so the draw is differentiable in the
        params."""
        if z is None:
            p0 = params[0]['w1']
            z = torch.randn((n_samples, self.dims), generator=generator,
                            dtype=p0.dtype, device=p0.device)
        cols = torch.arange(self.dims, device=z.device)
        for b in range(self.n_blocks - 1, -1, -1):
            reverse = bool(b % 2)
            order = range(self.dims - 1, -1, -1) if reverse else range(
                self.dims)
            x = torch.zeros_like(z)
            for idx in order:
                mu, log_s = self._block_params(params[b], x, reverse)
                x_new = mu + z * torch.exp(log_s)
                x = torch.where(cols == idx, x_new, x)
            z = x
        return z

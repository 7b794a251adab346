"""Transformer sequence-model dynamics (counterpart of
``prob_mbrl_tpu/models/transformer.py``): a post-norm transformer encoder
reads the token stream [s_1..s_T, a_1..a_T] (one positional encoding a
timestep, shared by the two streams; causal and padding masks built from
the timesteps), the mean of each timestep's two output embeddings feeds
factorised next-state / reward / done heads with chained conditioning.

Params keep JAX's names and ``(din, dout)`` layout, so ``convert`` carries
them name for name: the qkv projection is reshaped [B, S, 3, H, hd] and
split in that order. Attention is an explicit float32 softmax over
``torch.matmul`` products with JAX's guard for fully-masked rows
(``where(isnan(w), 0, w)``); ``scaled_dot_product_attention`` treats such
rows and picks its backend otherwise. The heads are ``hids=()`` density
networks, which the fused MLP does not take (it needs a hidden layer), as in
JAX.
"""
import dataclasses
import math
from typing import Optional

import torch

from ..ops.distributions import AffineTril
from ..utils.core import resolve_device
from .conditional_density import GaussianDN, SoftmaxDN, density_network_mlp


def positional_encoding(T, d_model, dtype=torch.float32, device=None):
    """The sinusoidal table [T, d_model]: sin on the even columns, cos on
    the odd."""
    pos = torch.arange(T, dtype=dtype, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=dtype, device=device)
                    * (-math.log(10000.0) / d_model))
    return torch.stack([torch.sin(pos * div), torch.cos(pos * div)],
                       -1).reshape(T, d_model)


def causal_mask_from_times(q_times, k_times):
    """Additive mask [Q, K]: -inf where the key's timestep is after the
    query's."""
    blocked = k_times[None, :] > q_times[:, None]
    return torch.zeros(blocked.shape, device=blocked.device).masked_fill(
        blocked, -math.inf)


def padding_mask_from_lengths(times, seqlens):
    """Additive mask [B, K]: -inf where the token's timestep is at or past
    the sequence's length."""
    blocked = times[None, :] >= seqlens[:, None]
    return torch.zeros(blocked.shape, device=blocked.device).masked_fill(
        blocked, -math.inf)


def _linear_init(generator, din, dout, dtype, device):
    std = math.sqrt(2.0 / (din + dout))
    return {'w': std * torch.randn((din, dout), generator=generator,
                                   dtype=dtype, device=device),
            'b': torch.zeros((dout,), dtype=dtype, device=device)}


def _linear(p, x):
    return torch.matmul(x, p['w']) + p['b']


def _layer_norm(p, x, eps=1e-5):
    """Layer norm with the biased variance (``jnp.var``)."""
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p['scale'] + p['bias']


@dataclasses.dataclass(frozen=True)
class TransformerEncoderSpec:
    """Post-norm transformer encoder (torch ``TransformerEncoderLayer``'s
    order: attention, add, norm, feed-forward, add, norm)."""
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 256

    def init(self, generator, dtype=torch.float32, device=None):
        device = resolve_device(device)
        d = self.d_model

        def norm():
            return {'scale': torch.ones((d,), dtype=dtype, device=device),
                    'bias': torch.zeros((d,), dtype=dtype, device=device)}

        def lin(din, dout):
            return _linear_init(generator, din, dout, dtype, device)

        return [{'qkv': lin(d, 3 * d), 'proj': lin(d, d),
                 'ff1': lin(d, self.d_ff), 'ff2': lin(self.d_ff, d),
                 'ln1': norm(), 'ln2': norm()}
                for _ in range(self.n_layers)]

    def apply(self, params, x, attn_mask=None, pad_mask=None):
        """x [B, S, d_model]; ``attn_mask`` [S, S] and ``pad_mask`` [B, S]
        (over the keys) additive."""
        B, S, d = x.shape
        H = self.n_heads
        hd = d // H
        mask = None
        if attn_mask is not None:
            mask = attn_mask[None, None]                   # [1, 1, S, S]
        if pad_mask is not None:
            pm = pad_mask[:, None, None, :]                # [B, 1, 1, S]
            mask = pm if mask is None else mask + pm
        for p in params:
            qkv = _linear(p['qkv'], x).reshape(B, S, 3, H, hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
            if mask is not None:
                logits = logits + mask
            # a fully-masked row's softmax is NaN: it attends to nothing
            w = torch.softmax(logits, -1)
            w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
            att = torch.matmul(w, v).transpose(1, 2).reshape(B, S, d)
            x = _layer_norm(p['ln1'], x + _linear(p['proj'], att))
            ff = _linear(p['ff2'], torch.relu(_linear(p['ff1'], x)))
            x = _layer_norm(p['ln2'], x + ff)
        return x


@dataclasses.dataclass(frozen=True)
class NextStateRewardDoneHeads:
    """Factorised output heads with chained conditioning on the raw head
    outputs: p(s' | e), p(r | e, raw_s), p(done | e, raw_s, raw_r)."""
    embedding_size: int
    state_dims: int

    def __post_init__(self):
        E, D = self.embedding_size, self.state_dims
        object.__setattr__(self, 'ps', density_network_mlp(
            E, D, hids=(), dropout=None, input_dropout=0.1))
        object.__setattr__(self, 'pr', density_network_mlp(
            E + GaussianDN.n_params(D), 1, hids=(), dropout=None,
            input_dropout=0.1))
        object.__setattr__(self, 'pdone', density_network_mlp(
            E + GaussianDN.n_params(D) + GaussianDN.n_params(1), 2,
            density_model=SoftmaxDN, hids=(), dropout=None,
            input_dropout=0.1, one_hot=False))

    def init(self, generator, dtype=torch.float32, device=None):
        return {k: getattr(self, k).init(generator, dtype, device)
                for k in ('ps', 'pr', 'pdone')}

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return {k: getattr(self, k).sample_noise(generator, batch_shape,
                                                 dtype, device)
                for k in ('ps', 'pr', 'pdone')}

    def regularization_loss(self, params):
        return (self.ps.regularization_loss(params['ps'])
                + self.pr.regularization_loss(params['pr'])
                + self.pdone.regularization_loss(params['pdone']))

    def apply(self, params, emb, scaling=None, noise=None, temperature=1.0):
        """emb [..., E] -> the (ps, pr, pdone) distributions; ``scaling``'s
        ``'s'`` and ``'r'`` whitening trees map ps and pr back (AffineTril)."""
        def raw(model, mp, x, n):
            mlp_noise = n.get('mlp') if n is not None else None
            return model.mlp.apply(mp, x, mlp_noise)

        n = noise or {}
        s_sc = scaling.get('s') if scaling else None
        r_sc = scaling.get('r') if scaling else None
        raw_s = raw(self.ps, params['ps'], emb, n.get('ps'))
        ps = self.ps.get_dist(raw_s, temperature)
        if s_sc is not None:
            ps = AffineTril(ps, s_sc['mean'], s_sc['L'])
        x = torch.cat([emb, raw_s], -1)
        raw_r = raw(self.pr, params['pr'], x, n.get('pr'))
        pr = self.pr.get_dist(raw_r, temperature)
        if r_sc is not None:
            pr = AffineTril(pr, r_sc['mean'], r_sc['L'])
        x = torch.cat([x, raw_r], -1)
        raw_d = raw(self.pdone, params['pdone'], x, n.get('pdone'))
        return ps, pr, self.pdone.get_dist(raw_d, temperature)


@dataclasses.dataclass(frozen=True)
class TransformerDynamicsModel:
    """Sequence dynamics: (state sequence, action sequence) -> each step's
    distributions of the next state, the reward and done."""
    state_dims: int
    action_dims: int
    embedding_size: int = 128
    encoder: Optional[TransformerEncoderSpec] = None
    max_horizon: int = 64

    def __post_init__(self):
        if self.encoder is None:
            object.__setattr__(self, 'encoder', TransformerEncoderSpec(
                d_model=self.embedding_size))
        object.__setattr__(self, 'heads', NextStateRewardDoneHeads(
            self.embedding_size, self.state_dims))

    def init(self, generator, dtype=torch.float32, device=None):
        device = resolve_device(device)
        E = self.embedding_size
        return {
            's_proj': _linear_init(generator, self.state_dims, E, dtype,
                                   device),
            'a_proj': _linear_init(generator, self.action_dims, E, dtype,
                                   device),
            'encoder': self.encoder.init(generator, dtype, device),
            'heads': self.heads.init(generator, dtype, device),
        }

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return {'heads': self.heads.sample_noise(generator, batch_shape,
                                                 dtype, device)}

    def regularization_loss(self, params):
        return self.heads.regularization_loss(params['heads'])

    def apply(self, params, states, actions, seqlens=None, scaling=None,
              noise=None, temperature=1.0):
        """states [B, T, D], actions [B, T, U] -> (ps, pr, pdone) over [B,
        T, ...]: s_{t+1}, r_t and done_t given the history up to t
        (``seqlens`` [B] masks the tokens at and past each length)."""
        B, T, _ = states.shape
        dev = states.device
        pe = positional_encoding(T, self.embedding_size, states.dtype, dev)
        s_emb = _linear(params['s_proj'], states) + pe[None]
        a_emb = _linear(params['a_proj'], actions) + pe[None]
        x = torch.cat([s_emb, a_emb], 1)                    # [B, 2T, E]
        times = torch.arange(T, device=dev).repeat(2)
        attn_mask = causal_mask_from_times(times, times)
        pad_mask = (padding_mask_from_lengths(times, seqlens)
                    if seqlens is not None else None)
        out = self.encoder.apply(params['encoder'], x, attn_mask, pad_mask)
        emb = 0.5 * (out[:, :T] + out[:, T:])
        h_noise = noise.get('heads') if noise is not None else None
        return self.heads.apply(params['heads'], emb, scaling, h_noise,
                                temperature)

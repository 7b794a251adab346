"""Activation functions by name (counterpart of
``prob_mbrl_tpu/models/activations.py``)."""
import torch


def relu(x):
    return torch.relu(x)


def swish(x):
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def exp_rbf(x):
    """exp(-0.5 x^2) RBF activation."""
    return torch.exp(-0.5 * x ** 2)


def sin(x):
    return torch.sin(x)


def sinlu(x):
    """relu(x) - sin(relu(-x))."""
    return torch.relu(x) - torch.sin(torch.relu(-x))


def hh_sinlu(x):
    """Features times alternating (-1, +1); sin on the first half of the
    feature axis, relu on the second half."""
    n = x.shape[-1]
    signs = (2 * (torch.arange(n, device=x.device) % 2) - 1).to(x.dtype)
    x = x * signs
    half = n // 2
    return torch.cat([torch.sin(x[..., :half]), torch.relu(x[..., half:])], -1)


def tanh(x):
    return torch.tanh(x)


def identity(x):
    return x


ACTIVATIONS = {
    'relu': relu,
    'swish': swish,
    'exp': exp_rbf,
    'sin': sin,
    'sinlu': sinlu,
    'hhsinlu': hh_sinlu,
    'tanh': tanh,
    'identity': identity,
}


def get(name):
    if callable(name):
        return name
    return ACTIVATIONS[name]

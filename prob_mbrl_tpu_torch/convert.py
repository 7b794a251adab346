"""Conversion between JAX pytrees (as numpy arrays) and the port's tensors.

Both packages use the same nested-dict names and the same ``(din, dout)``
weight layout, so conversion is a name-for-name copy. An ``optax.adam`` state
(``(ScaleByAdamState(count, mu, nu), EmptyState())``) carries across to the
port's ``algorithms.value.AdamState`` and back, and the dict states of JAX's
``optim.radam`` and ``optim.sdlbfgs`` to ``optim.RAdamState`` and
``optim.SdLBFGSState`` and back (``dict_state_from_jax``,
``dict_state_to_jax``), their int32 counts and bool masks keeping their
dtypes.
"""
import numpy as np
import torch

from .algorithms.value import AdamState
from .utils.core import resolve_device, tree_map


def params_from_jax(np_tree, device=None, requires_grad=False):
    """A params (or stats) pytree of numpy arrays -> the same tree of float32
    tensors on ``device`` (leaf tensors, optionally requiring grad)."""
    device = resolve_device(device)

    def conv(a):
        t = torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
        return t.requires_grad_(requires_grad)

    return tree_map(conv, np_tree)


def noise_from_jax(np_tree, device=None):
    """A noise pytree of numpy arrays -> the same tree of tensors."""
    return params_from_jax(np_tree, device)


def params_to_numpy(tree):
    """The port's tensors -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _adam_part(np_state):
    """The ``ScaleByAdamState`` (the part with count, mu, nu) of an optax
    state."""
    return next(x for x in np_state if hasattr(x, 'mu') and hasattr(x, 'nu'))


def adam_state_from_jax(np_state, device=None):
    """An ``optax.adam`` state with numpy leaves -> ``AdamState`` on
    ``device``."""
    s = _adam_part(np_state)
    device = resolve_device(device)
    return AdamState(torch.tensor(np.asarray(s.count), dtype=torch.int32,
                                  device=device),
                     params_from_jax(s.mu, device),
                     params_from_jax(s.nu, device))


def adam_state_to_jax(state, like):
    """``AdamState`` -> an optax state of the structure of ``like`` (an
    ``optax.adam`` state) with numpy leaves."""
    return type(like)(
        x._replace(count=np.asarray(state.count.cpu().numpy(), np.int32),
                   mu=params_to_numpy(state.mu), nu=params_to_numpy(state.nu))
        if x is _adam_part(like) else x for x in like)


def dict_state_from_jax(cls, np_state, device=None):
    """A JAX optimiser's dict state with numpy leaves (``optim.radam``'s
    step, mu, nu; ``optim.sdlbfgs``'s n_iter, prev_grad, prev_d, prev_t, S,
    Ybar, valid) -> ``cls`` (``RAdamState``, ``SdLBFGSState``) on
    ``device``: integer and bool leaves keep their dtypes (int32, bool), the
    rest float32."""
    device = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=device)
        return torch.tensor(a, dtype=torch.float32, device=device)

    return cls(**{k: tree_map(conv, np_state[k]) for k in cls._fields})


def dict_state_to_jax(state):
    """``RAdamState`` or ``SdLBFGSState`` -> JAX's dict state, numpy
    leaves."""
    return {k: params_to_numpy(v) for k, v in state._asdict().items()}

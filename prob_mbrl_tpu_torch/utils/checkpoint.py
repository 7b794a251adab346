"""Checkpoint / resume: params, experience and flags
(counterpart of ``prob_mbrl_tpu/utils/checkpoint.py``).

A tree (nested dicts, lists and tuples of tensors or arrays) is saved with
numpy leaves in the layout of the JAX package's pickle format: ``path +
'.pkl'`` holding ``{'leaves', 'treedef_repr', 'tree'}``, so the JAX package's
``load_pytree`` reads it. The file names are the JAX package's:

  latest_dynamics / latest_policy / latest_critic  (trees)
  experience.pkl                                   (ExperienceDataset)
  args.json                                        (flags)
"""
import json
import os
import pickle
import warnings

import numpy as np
import torch

from .core import resolve_device, tree_leaves, tree_map


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def treedef_repr(tree):
    """The string ``str(jax.tree_util.tree_structure(tree))`` gives for a tree
    of nested dicts (keys sorted), lists and tuples."""
    def rec(t):
        if isinstance(t, dict):
            return '{' + ', '.join(f'{k!r}: {rec(t[k])}'
                                   for k in sorted(t)) + '}'
        if isinstance(t, tuple):
            inner = ', '.join(rec(v) for v in t)
            return '(' + inner + (',)' if len(t) == 1 else ')')
        if isinstance(t, list):
            return '[' + ', '.join(rec(v) for v in t) + ']'
        return 'None' if t is None else '*'
    return f'PyTreeDef({rec(tree)})'


def save_pytree(path, tree):
    """Save a tree of tensors or arrays with numpy leaves to ``path +
    '.pkl'``."""
    tree = tree_map(_to_numpy, tree)
    with open(path + '.pkl', 'wb') as f:
        pickle.dump({'leaves': tree_leaves(tree),
                     'treedef_repr': treedef_repr(tree), 'tree': tree}, f)


def load_pytree(path, device=None):
    """The tree saved at ``path``, its leaves as tensors on ``device`` (of
    the saved arrays' dtypes)."""
    device = resolve_device(device)
    with open(path + '.pkl', 'rb') as f:
        tree = pickle.load(f)['tree']
    return tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device),
                    tree)


def save_checkpoint(results_folder, dyn_params=None, pol_params=None,
                    critic_params=None, exp=None, args=None, extra=None):
    """Save whatever is given under the JAX package's fixed names."""
    os.makedirs(results_folder, exist_ok=True)
    named = {'latest_dynamics': dyn_params, 'latest_policy': pol_params,
             'latest_critic': critic_params}
    if extra:
        named.update(extra)
    for name, tree in named.items():
        if tree is not None:
            save_pytree(os.path.join(results_folder, name), tree)
    if exp is not None:
        exp.save(os.path.join(results_folder, 'experience.pkl'))
    if args is not None:
        d = args if isinstance(args, dict) else vars(args)
        with open(os.path.join(results_folder, 'args.json'), 'w') as f:
            json.dump(d, f, indent=2, default=str)


def load_checkpoint(results_folder, exp=None, device=None):
    """Tolerant reload: a missing or unreadable piece warns.

    Returns a dict with whichever of dyn/pol/critic (trees of tensors on
    ``device``), exp and args were found.
    """
    out = {}
    for key, name in [('dyn', 'latest_dynamics'), ('pol', 'latest_policy'),
                      ('critic', 'latest_critic')]:
        path = os.path.join(results_folder, name)
        try:
            out[key] = load_pytree(path, device)
        except (OSError, pickle.UnpicklingError, EOFError) as e:
            warnings.warn(f'could not load {name}: {e}')
    exp_path = os.path.join(results_folder, 'experience.pkl')
    if exp is not None and os.path.exists(exp_path):
        try:
            exp.load(exp_path)
            out['exp'] = exp
        except (OSError, pickle.UnpicklingError, EOFError) as e:
            warnings.warn(f'could not load experience: {e}')
    args_path = os.path.join(results_folder, 'args.json')
    if os.path.exists(args_path):
        with open(args_path) as f:
            out['args'] = json.load(f)
    return out

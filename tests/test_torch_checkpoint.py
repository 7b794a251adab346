"""The port's checkpoints: a round trip, the JAX package reading the port's
files, and the tolerant reload's warnings, as the JAX package gives them."""
import importlib
import json
import pickle
import warnings

import jax
import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.utils import checkpoint as tck
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset

jck = importlib.import_module('prob_mbrl_tpu.utils.checkpoint')


def _policy_params():
    pol = tm.Policy(tm.MLPSpec(5, 2, (16, 16), dropout=tm.bdropout(0.1)),
                    tm.DiagGaussianDensity(1), max_u=(10.0,))
    return pol.init(torch.Generator().manual_seed(0), device='cpu')


def _exp():
    exp = ExperienceDataset()
    rng = np.random.RandomState(0)
    exp.append_episode(list(rng.randn(5, 4)), list(rng.randn(5, 1)),
                       list(rng.rand(5, 1)), [False] * 5, [{}] * 5,
                       policy_params={'w': np.ones(2)})
    return exp


def test_round_trip(tmp_path):
    params = _policy_params()
    args = {'seed': 3, 'dyn_shape': [16, 16]}
    tck.save_checkpoint(str(tmp_path), dyn_params={'a': torch.ones(2)},
                        pol_params=params, exp=_exp(), args=args,
                        extra={'best_policy': params})
    exp = ExperienceDataset()
    with warnings.catch_warnings():
        warnings.simplefilter('error')  # nothing is missing but the critic
        with pytest.warns(UserWarning, match='latest_critic'):
            ck = tck.load_checkpoint(str(tmp_path), exp=exp, device='cpu')
    assert set(ck) == {'dyn', 'pol', 'exp', 'args'}
    for a, b in zip(tree_leaves(ck['pol']), tree_leaves(params)):
        assert a.device.type == 'cpu' and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ck['args'] == args
    assert ck['exp'] is exp and exp.n_samples() == 5
    np.testing.assert_array_equal(exp.policy_parameters[0]['w'], np.ones(2))
    best = tck.load_pytree(str(tmp_path / 'best_policy'), 'cpu')
    torch.testing.assert_close(best, params)


def test_jax_load_pytree_reads_the_ports_policy(tmp_path):
    params = _policy_params()
    tck.save_checkpoint(str(tmp_path), pol_params=params)
    jtree = jck.load_pytree(str(tmp_path / 'latest_policy'))
    leaves = jax.tree_util.tree_leaves(jtree)
    assert len(leaves) == len(tree_leaves(params))
    for a, b in zip(leaves, tree_leaves(params)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b.numpy())
    with open(tmp_path / 'latest_policy.pkl', 'rb') as f:
        saved = pickle.load(f)
    assert saved['treedef_repr'] == str(jax.tree_util.tree_structure(jtree))
    for a, b in zip(saved['leaves'], leaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('tree', [{'a': (np.ones(1), [np.zeros(2), None])},
                                  {'b': (np.ones(1),)}, [np.ones(1), {}]])
def test_treedef_repr_is_jaxs(tree):
    assert tck.treedef_repr(tree) == str(jax.tree_util.tree_structure(tree))


def test_load_checkpoint_warns_on_missing_pieces_as_jax_does(tmp_path):
    tck.save_checkpoint(str(tmp_path), pol_params=_policy_params())
    (tmp_path / 'args.json').write_text(json.dumps({'seed': 1}))
    out = {}
    for name, mod, kw in (('jax', jck, {}), ('port', tck, {'device': 'cpu'})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            ck = mod.load_checkpoint(str(tmp_path), exp=ExperienceDataset(),
                                     **kw)
        out[name] = (sorted(ck), sorted(str(x.message).split(':')[0]
                                        for x in w))
    assert out['port'] == out['jax']
    assert out['port'] == (['args', 'pol'], ['could not load latest_critic',
                                             'could not load latest_dynamics'])

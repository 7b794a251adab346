#!/usr/bin/env python3
"""Float32 against float64 in one ``transformer_models`` dynamics step, in
the port and in the JAX package, on the same inputs, leaf by leaf: which
leaf of the step's gradient lies farthest from float64, and whether JAX's
float32 step lies as far from its float64 step as the port's.

    python3 tools/torch_transformer_precision.py [--seed 1] [--batch 32]
        [--fresh | --inputs FILE]

Runs on the CPU. The inputs are the driver's at its defaults on Cartpole
(D = 5, U = 1; a transformer of d_model 64, window 16; the heads' dropout
noise at (batch, 1)): two 40-step random-action episodes of the port's
Cartpole, their sliding windows (``batch`` of them, picked with numpy) and
the heads' noise drawn by JAX, and the dynamics params and whitening that
one iteration of the port's driver leaves at its defaults on the CPU
(``driver_models``), or with ``--fresh`` JAX's initial params and the
windows' whitening (JAX's ``fit_scaling``); or with ``--inputs`` the
params, whitening, noise and batch that ``chip_smoke.check_tm_steps(...,
dump=FILE)`` saved on the card. Each package computes the gradient of its
driver's dynamics loss (``make_dyn_train_fn``: JAX's through an optax
transformation that hands the gradient back as its state, the port's
through an optimiser that does the same) in float32 and in float64 on those inputs cast up; JAX's float64
step runs in a process of its own with x64 on. Prints, per leaf, max|g64|
and each float32 step's max|g32 - g64| / max|g64|, then the worst leaf of
each package and the two float64 steps' distance; then the ReLU units of
the port's feed-forward layers whose float32 and float64 pre-activations
take different branches; then each package's worst leaf again on the
states moved by k 1e-6 relative, k = 1 ... ``--moves``. Ends with one JSON
line (``PRECISION``).
"""
import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
WIDTH, WINDOW, EPISODES, STEPS = 64, 16, 2, 40


def flat(tree, prefix='', leaf=np.asarray):
    """(path, leaf(array)) pairs of nested dicts and lists, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat(tree[k], f'{prefix}/{k}', leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flat(v, f'{prefix}/{i}', leaf)]
    return [(prefix, leaf(tree))]


def jax_grads(inputs, x64):
    """JAX's dynamics-step gradient (``examples/transformer_models.py``
    ``make_dyn_train_fn``) on ``inputs``, in float64 with ``x64``."""
    import importlib.util

    import jax
    import jax.numpy as jnp
    import optax
    from prob_mbrl_tpu.models.transformer import TransformerDynamicsModel

    spec = importlib.util.spec_from_file_location(
        'jax_transformer_models', ROOT / 'examples' / 'transformer_models.py')
    jtm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtm)
    dt = jnp.float64 if x64 else jnp.float32

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dt) if np.issubdtype(
                np.asarray(a).dtype, np.floating) else jnp.asarray(a), tree)

    dyn = TransformerDynamicsModel(5, 1, embedding_size=WIDTH,
                                   max_horizon=WINDOW)
    noise = cast(inputs['noise'])

    class Pinned:  # the step draws its heads' noise: give it these draws
        def __getattr__(self, name):
            return getattr(dyn, name)

        def sample_noise(self, key, shape):
            return noise

    def zeros(tree):
        return jax.tree_util.tree_map(jnp.zeros_like, tree)

    capture = optax.GradientTransformation(zeros,
                                           lambda g, s, p=None: (zeros(g), g))
    step = jtm.make_dyn_train_fn(Pinned(), capture)
    params = cast(inputs['params'])
    b = inputs['batch']
    _, grads, loss, e_lml = step(
        params, capture.init(params), cast(inputs['scaling']),
        *[cast(b[k]) for k in ('s', 'a', 'ns', 'r', 'd')],
        jnp.asarray(b['lens']), jax.random.PRNGKey(0))
    return dict(flat(grads)), float(loss), float(e_lml)


def port_grads(inputs, dtype, relu_inputs=None):
    """The port's dynamics-step gradient on ``inputs`` cast to ``dtype``;
    the inputs of each ``torch.relu`` call appended to ``relu_inputs``."""
    from unittest import mock

    import torch
    from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
    from prob_mbrl_tpu_torch.examples import transformer_models as tmd
    from prob_mbrl_tpu_torch.models.transformer import (
        TransformerDynamicsModel)
    from prob_mbrl_tpu_torch.utils.core import tree_map

    class Capture:  # hands the gradient back as the optimiser's state
        def init(self, params):
            return None

        def step(self, grads, state, params):
            return params, grads

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    dyn = TransformerDynamicsModel(5, 1, embedding_size=WIDTH,
                                   max_horizon=WINDOW)
    step = tmd.make_dyn_train_fn(dyn, Capture())
    params = tree_map(cast, params_from_jax(inputs['params'], 'cpu'))
    noise = tree_map(cast, noise_from_jax(inputs['noise'], 'cpu'))
    scaling = tree_map(cast, params_from_jax(inputs['scaling'], 'cpu'))
    b = {k: cast(torch.as_tensor(v)) for k, v in inputs['batch'].items()}
    relu = torch.relu

    def recorded(x):
        relu_inputs.append(x.detach().double().numpy())
        return relu(x)

    with mock.patch('torch.relu', recorded if relu_inputs is not None
                    else relu):
        _, grads, loss, e_lml = step(params, None, scaling,
                                     *[b[k] for k in ('s', 'a', 'ns', 'r',
                                                      'd', 'lens')],
                                     noise=noise)
    return (dict(flat(grads, leaf=lambda t: t.detach().double().numpy())),
            float(loss), float(e_lml))


def driver_models(seed):
    """The dynamics params and the scaling that one iteration of the port's
    ``transformer_models`` driver leaves at its defaults on the CPU
    (``chip_smoke.py`` phase 14's ``--seed 1 --ps_iters 1``): 400 fit
    steps, 200 flow steps, 100 policy steps and a real episode."""
    from prob_mbrl_tpu_torch.convert import params_to_numpy
    from prob_mbrl_tpu_torch.examples import transformer_models as tmd
    params, history = tmd.main(['--seed', str(seed), '--ps_iters', '1'],
                               device='cpu')
    return (params_to_numpy(params['dyn']),
            params_to_numpy(history[-1]['scaling']))


def make_inputs(seed, batch, fresh):
    """The driver's inputs (the module's docstring), as numpy trees."""
    import jax
    import torch
    from prob_mbrl_tpu.models.conditional_density import fit_scaling
    from prob_mbrl_tpu.models.transformer import TransformerDynamicsModel
    from prob_mbrl_tpu_torch import envs
    from prob_mbrl_tpu_torch.examples import transformer_models as tmd
    from prob_mbrl_tpu_torch.utils.apply_controller import apply_controller
    from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset

    env = envs.make('Cartpole', device='cpu')
    env.seed(seed)
    rnd = np.random.RandomState(seed)
    exp = ExperienceDataset()
    for _ in range(EPISODES):
        exp.append_episode(*apply_controller(
            env, lambda x, t=0: rnd.uniform(env.action_space.low,
                                            env.action_space.high), STEPS))
    S, A, NS, R, DN, L = tmd.sliding_windows(exp, WINDOW)
    idx = rnd.randint(0, S.shape[0], batch)
    D = S.shape[-1]
    dyn = TransformerDynamicsModel(D, A.shape[-1], embedding_size=WIDTH,
                                   max_horizon=WINDOW)
    kp, kn = jax.random.split(jax.random.PRNGKey(seed))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    torch.set_num_threads(1)
    params = np_tree(dyn.init(kp))
    scaling = np_tree({'s': fit_scaling(NS.reshape(-1, D)),
                       'r': fit_scaling(R.reshape(-1, 1))})
    if not fresh:  # the models of one iteration of the driver
        params, scaling = driver_models(seed)
    return dict(
        params=params,
        noise=np_tree(dyn.sample_noise(kn, (batch, 1))),
        scaling=scaling,
        batch=dict(s=S[idx], a=A[idx], ns=NS[idx], r=R[idx], d=DN[idx],
                   lens=L[idx]))


def rel(a, r):
    return float(np.abs(a - r).max() / max(np.abs(r).max(), 1e-30))


def compare(inputs, verbose=False):
    """Per leaf, each float32 step's distance from its float64 step, and
    the two float64 steps' (and float32 steps') distance: (rows, JAX's
    worst row, the port's worst row, the four losses)."""
    import torch
    jx = {}
    with tempfile.TemporaryDirectory() as tmp:
        io = os.path.join(tmp, 'inputs.pkl')
        with open(io, 'wb') as f:
            pickle.dump(inputs, f)
        for mode in ('f32', 'f64'):
            env = dict(os.environ, JAX_PLATFORMS='cpu',
                       JAX_ENABLE_X64='1' if mode == 'f64' else '0')
            subprocess.run([sys.executable, __file__, '--jax', mode, '--io',
                            io], check=True, env=env)
            with open(f'{io}.{mode}', 'rb') as f:
                jx[mode] = pickle.load(f)
    pt = {'f32': port_grads(inputs, torch.float32),
          'f64': port_grads(inputs, torch.float64)}
    names = sorted(jx['f64'][0])
    assert names == sorted(pt['f64'][0]), 'the two trees differ'
    rows = []
    for n in names:
        j32, j64 = jx['f32'][0][n], jx['f64'][0][n]
        p32, p64 = pt['f32'][0][n], pt['f64'][0][n]
        rows.append(dict(leaf=n, size=int(j64.size),
                         max_g64=float(np.abs(j64).max()),
                         jax32=rel(j32, j64), port32=rel(p32, p64),
                         port64_jax64=rel(p64, j64),
                         port32_jax32=rel(p32, j32)))
        r = rows[-1]
        if verbose:
            print(f'{n:40s} {r["size"]:6d} max|g64| {r["max_g64"]:.3e}  '
                  f'f32 from f64: JAX {r["jax32"]:.3e}, port '
                  f'{r["port32"]:.3e}; port64 from JAX64 '
                  f'{r["port64_jax64"]:.3e}; port32 from JAX32 '
                  f'{r["port32_jax32"]:.3e}')
    losses = dict(jax32=jx['f32'][1], jax64=jx['f64'][1],
                  port32=pt['f32'][1], port64=pt['f64'][1])
    return (rows, max(rows, key=lambda r: r['jax32']),
            max(rows, key=lambda r: r['port32']), losses)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--fresh', action='store_true')
    ap.add_argument('--inputs')
    ap.add_argument('--moves', type=int, default=2)
    ap.add_argument('--jax', choices=('f32', 'f64'))
    ap.add_argument('--io')
    args = ap.parse_args()
    if args.jax:  # one of JAX's steps, in a process of its own
        with open(args.io, 'rb') as f:
            inputs = pickle.load(f)
        out = jax_grads(inputs, args.jax == 'f64')
        with open(args.io + '.' + args.jax, 'wb') as f:
            pickle.dump(out, f)
        return 0

    import torch
    if args.inputs:
        from prob_mbrl_tpu_torch.convert import params_to_numpy
        inputs = params_to_numpy(torch.load(args.inputs))
    else:
        inputs = make_inputs(args.seed, args.batch, args.fresh)
    rows, wj, wp, losses = compare(inputs, verbose=True)
    print(f'worst leaf, JAX float32 from float64: {wj["leaf"]} '
          f'{wj["jax32"]:.3e} (port {wj["port32"]:.3e} there)')
    print(f'worst leaf, port float32 from float64: {wp["leaf"]} '
          f'{wp["port32"]:.3e} (JAX {wp["jax32"]:.3e} there)')
    print('loss: ' + ', '.join(f'{k} {v:.9g}' for k, v in losses.items()))
    r32, r64 = [], []
    port_grads(inputs, torch.float32, r32)
    port_grads(inputs, torch.float64, r64)
    edges = []
    for layer, (a, b) in enumerate(zip(r32, r64)):
        flip = (a > 0) != (b > 0)
        for idx in zip(*np.nonzero(flip)):
            edges.append(dict(layer=layer, index=[int(i) for i in idx],
                              x32=float(a[idx]), x64=float(b[idx]),
                              rel=float(abs(b[idx]) / np.abs(b).max())))
            print(f'ReLU edge: feed-forward layer {layer} unit {idx}: '
                  f'float32 {a[idx]:.3e}, float64 {b[idx]:.3e} '
                  f'({edges[-1]["rel"]:.2e} of the layer\'s max|x|)')
    print(f'{len(edges)} ReLU units take different branches in the port\'s '
          f'float32 and float64 steps (of {sum(a.size for a in r64)})')
    moved = []
    for k in range(1, args.moves + 1):
        m = dict(inputs, batch=dict(inputs['batch']))
        m['batch']['s'] = (m['batch']['s'] * (1 + k * 1e-6)).astype(
            np.float32)
        _, mj, mp, _ = compare(m)
        moved.append(dict(k=k, jax=[mj['leaf'], mj['jax32']],
                          port=[mp['leaf'], mp['port32']]))
        print(f'states x (1 + {k}e-6): worst leaf, JAX float32 from float64 '
              f'{mj["leaf"]} {mj["jax32"]:.3e}; port {mp["leaf"]} '
              f'{mp["port32"]:.3e}')
    print('PRECISION ' + json.dumps(dict(
        worst_jax=wj, worst_port=wp,
        port64_jax64=max(r['port64_jax64'] for r in rows),
        loss=losses, relu_edges=edges, moved=moved)))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Sequence-model MBRL (counterpart of the repo's
``examples/transformer_models.py``): a transformer dynamics model fitted to
sliding windows of (state, action) -> (next state, reward, done) sequences,
a masked autoregressive flow for the initial states, and a sigmoid-squashed
stochastic policy optimised by backpropagating through imagined rollouts
of the dynamics. Each of ``--ps_iters`` iterations fits the dynamics
(``--dyn_opt_iters`` steps of batch 32), the flow (200 steps) and the
policy (``--pol_opt_iters`` steps on 25 x0s drawn from the flow, each a
``--pred_H``-step imagined rollout), then runs ``--control_H`` real steps
with the policy's mean and prints one line.

    python -m prob_mbrl_tpu_torch.examples.transformer_models [flags]

Runs on ``cuda`` unless ``main`` is given ``device='cpu'``. The policy is a
[64, 64] Bernoulli-dropout MLP: on CUDA every imagined step and every
control step is one fused-MLP forward launch and a policy step's backward
one backward launch an imagined step; the transformer, its heads (no hidden
layer) and the flow run as PyTorch products, as JAX runs them in XLA.
"""
import collections
import time

import numpy as np
import torch

from .. import models
from ..models.conditional_density import fit_scaling
from ..models.flows import MAFSpec
from ..models.transformer import TransformerDynamicsModel
from ..utils.apply_controller import apply_controller
from ..utils.core import resolve_device
from ..utils.experience import ExperienceDataset
from ..utils.experiments import get_argument_parser, init_env
from ..utils.optim import Adam, loss_and_grads

FLOW_STEPS = 200  # flow fit steps an iteration
N_X0 = 25  # initial states a policy step rolls out from
DYN_BATCH = 32  # windows a dynamics step, at most

RolloutDraws = collections.namedtuple('RolloutDraws',
                                      'pol_noise h_noise eps_s eps_r')
RolloutDraws.__doc__ = """The draws of a policy step: the policy's noise at
batch (B,), the dynamics heads' noise at (B, 1), and each imagined step's
standard normals of the next state [T, B, D] and the reward [T, B, 1]
(JAX draws [B, T, .] a step and keeps column t)."""


def sliding_windows(exp, T):
    """[N, T, ...] windows of (state, action, next state, reward, done) and
    their lengths, zero-padded past each length, as numpy."""
    S, A, NS, R, DN, L = [], [], [], [], [], []
    for ep in range(exp.n_episodes()):
        s = np.asarray(exp.states[ep], np.float32)
        a = np.asarray(exp.actions[ep], np.float32).reshape(len(s), -1)
        r = np.asarray(exp.rewards[ep], np.float32).reshape(len(s), -1)
        d = np.asarray(exp.done[ep], np.float32).reshape(len(s), -1) \
            if exp.done[ep] else np.zeros((len(s), 1), np.float32)
        H = len(s) - 1
        if H < 1:
            continue
        for start in range(0, max(1, H - 1)):
            end = min(start + T, H)
            n = end - start
            pad = T - n

            def padded(x):
                return np.concatenate(
                    [x[start:end], np.zeros((pad,) + x.shape[1:],
                                            np.float32)], 0)[None]
            S.append(padded(s))
            A.append(padded(a))
            NS.append(padded(s[1:]))
            R.append(padded(r))
            DN.append(padded(d))
            L.append(n)
    return (np.concatenate(S), np.concatenate(A), np.concatenate(NS),
            np.concatenate(R), np.concatenate(DN),
            np.asarray(L, np.int32))


def make_dyn_train_fn(dyn, optimizer, reg_weight=1e-3):
    """``step(params, opt_state, scaling, s, a, ns, r, d, lens,
    generator=None, noise=None) -> (params, opt_state, loss, E_lml)``: one
    optimiser step on the windows' mean log-likelihood of next state,
    reward and done over their valid steps, less ``reg_weight`` times the
    heads' regulariser. ``noise``: the heads' noise at (batch, 1), else
    drawn from ``generator``."""
    def loss_fn(params, scaling, s, a, ns, r, d, lens, noise):
        ps, pr, pdone = dyn.apply(params, s, a, seqlens=lens,
                                  scaling=scaling, noise=noise)
        T = s.shape[1]
        valid = (torch.arange(T, device=s.device)[None, :]
                 < lens[:, None]).to(s.dtype)
        lp_s = ps.log_prob(ns) * valid
        lp_r = pr.log_prob(r) * valid
        lp_d = pdone.log_prob(d[..., 0].long()) * valid
        n_valid = torch.clamp(torch.sum(valid), min=1.0)
        E_lml = torch.sum(lp_s + lp_r + lp_d) / n_valid
        return (-E_lml + reg_weight * dyn.regularization_loss(params),
                E_lml.detach())

    def step(params, opt_state, scaling, s, a, ns, r, d, lens,
             generator=None, noise=None):
        if noise is None:
            noise = dyn.sample_noise(generator, (s.shape[0], 1),
                                     device=s.device)
        (loss, E_lml), grads = loss_and_grads(
            lambda p: loss_fn(p, scaling, s, a, ns, r, d, lens, noise),
            params, has_aux=True)
        params, opt_state = optimizer.step(grads, opt_state, params)
        return params, opt_state, loss, E_lml

    return step


def make_policy(D, U, limits, fused=None):
    """The sigmoid-squashed stochastic policy: (spec, apply). ``apply(params,
    x, noise=None)`` samples with ``noise`` (a ``Policy`` noise tree) and
    takes the density's mean without it; the action is ``low + (high -
    low) sigmoid(u)``. ``fused``: the MLP's (``MLPSpec.fused``)."""
    density = models.DiagGaussianDensity(U)
    mlp = models.MLPSpec(D, density.n_inputs, (64, 64),
                         dropout=models.bdropout(0.1), fused=fused)
    low, high = limits

    def apply(params, x, noise=None):
        u = mlp.apply(params, x, noise.get('mlp') if noise else None)
        if noise is not None and 'density' in noise:
            u = density.apply(u, noise['density'], return_samples=True)
        else:
            u = density.apply(u, None, return_samples=False)[0]  # the mean
        return low + (high - low) * torch.sigmoid(u)

    spec = models.Policy(mlp=mlp, output_density=density)  # its noise
    return spec, apply


def draw_rollout_noise(generator, dyn, pol_spec, B, T, device):
    """A policy step's ``RolloutDraws`` from ``generator``."""
    return RolloutDraws(
        pol_spec.sample_noise(generator, (B,), device=device),
        dyn.sample_noise(generator, (B, 1), device=device),
        torch.randn((T, B, dyn.state_dims), generator=generator,
                    device=device),
        torch.randn((T, B, 1), generator=generator, device=device))


def imagined_rollout(dyn, dyn_params, scaling, pol_apply, pol_params,
                     pol_noise, x0, T, h_noise, eps_s, eps_r):
    """An autoregressive imagined rollout from ``x0`` [B, D]: each step
    re-encodes the whole zero-padded context of T steps with ``lens = t +
    1`` (no cache of keys and values, as in JAX), samples s_{t+1} and r_t
    from column t of the heads' distributions with ``eps_s[t]``,
    ``eps_r[t]``. Returns (states [B, T + 1, D], actions [B, T, U],
    rewards [B, T, 1]), differentiable in the policy's params."""
    B, D = x0.shape
    U = dyn.action_dims
    states, actions, rewards = [x0], [], []
    zeros_s = x0.new_zeros((B, T, D))
    zeros_a = x0.new_zeros((B, T, U))
    for t in range(T):
        actions.append(pol_apply(pol_params, states[t], pol_noise))
        ctx_s = torch.cat([torch.stack(states, 1), zeros_s[:, t + 1:]], 1)
        ctx_a = torch.cat([torch.stack(actions, 1), zeros_a[:, t + 1:]], 1)
        lens = torch.full((B,), t + 1, device=x0.device)
        ps, pr, _ = dyn.apply(dyn_params, ctx_s, ctx_a, seqlens=lens,
                              scaling=scaling, noise=h_noise)
        # column t's sample: a row's draw depends on its own noise alone
        es = x0.new_zeros((B, T, D))
        es[:, t] = eps_s[t]
        er = x0.new_zeros((B, T, 1))
        er[:, t] = eps_r[t]
        states.append(ps.rsample(eps=es)[:, t])
        rewards.append(pr.rsample(eps=er)[:, t])
    return (torch.stack(states, 1), torch.stack(actions, 1),
            torch.stack(rewards, 1))


def make_pol_step(dyn, pol_spec, pol_apply, optimizer, T):
    """``step(pol_params, opt_state, dyn_params, scaling, x0,
    generator=None, draws=None) -> (pol_params, opt_state, loss)``: one
    optimiser step on minus the mean imagined return of a T-step rollout
    from ``x0``; ``draws`` a ``RolloutDraws``, else drawn from
    ``generator``."""
    def step(pol_params, opt_state, dyn_params, scaling, x0, generator=None,
             draws=None):
        if draws is None:
            draws = draw_rollout_noise(generator, dyn, pol_spec, x0.shape[0],
                                       T, x0.device)

        def loss_fn(p):
            _, _, rewards = imagined_rollout(
                dyn, dyn_params, scaling, pol_apply, p, draws.pol_noise, x0,
                T, draws.h_noise, draws.eps_s, draws.eps_r)
            return -torch.mean(torch.sum(rewards, 1))

        loss, grads = loss_and_grads(loss_fn, pol_params)
        pol_params, opt_state = optimizer.step(grads, opt_state, pol_params)
        return pol_params, opt_state, loss

    return step


def make_flow_step(flow, optimizer):
    """``step(params, opt_state, x0s, generator=None, jitter=None) ->
    (params, opt_state, loss)``: one optimiser step on the flow's mean
    negative log density of the x0s jittered by 0.01 ``jitter`` (standard
    normals like ``x0s``, else drawn from ``generator``), so that the flow
    does not collapse onto them."""
    def step(params, opt_state, x0s, generator=None, jitter=None):
        if jitter is None:
            jitter = torch.randn(x0s.shape, generator=generator,
                                 device=x0s.device)
        x = x0s + 0.01 * jitter
        loss, grads = loss_and_grads(
            lambda p: -torch.mean(flow.log_prob(p, x)), params)
        params, opt_state = optimizer.step(grads, opt_state, params)
        return params, opt_state, loss

    return step


def get_parser():
    """The shared flags with this driver's defaults and its two own."""
    parser = get_argument_parser('transformer_models')
    parser.set_defaults(pred_H=16, control_H=40, dyn_opt_iters=400,
                        pol_opt_iters=100, ps_iters=10)
    parser.add_argument('--embedding_size', type=int, default=64)
    parser.add_argument('--window', type=int, default=16)
    return parser


def build(env, args, device):
    """The driver's models and steps: a dict of the specs (``dyn``,
    ``pol_spec``, ``pol_apply``, ``flow``) and the steps (``dyn_step``,
    ``flow_step``, ``pol_step``) at ``args``' widths on ``env``."""
    D, U = env.observation_size, env.action_size
    low = torch.tensor(np.asarray(env.action_space.low, np.float32),
                       device=device)
    high = torch.tensor(np.asarray(env.action_space.high, np.float32),
                        device=device)
    dyn = TransformerDynamicsModel(D, U, embedding_size=args.embedding_size,
                                   max_horizon=args.window)
    pol_spec, pol_apply = make_policy(D, U, (low, high))
    flow = MAFSpec(dims=D, n_blocks=4, hidden=64)
    return dict(dyn=dyn, pol_spec=pol_spec, pol_apply=pol_apply, flow=flow,
                dyn_step=make_dyn_train_fn(dyn, Adam(3e-4)),
                flow_step=make_flow_step(flow, Adam(1e-3)),
                pol_step=make_pol_step(dyn, pol_spec, pol_apply, Adam(1e-3),
                                       args.pred_H))


def main(argv=None, device=None):
    """Parse the flags (``argv``, default the command line) and run the
    loop. Returns (params, history): the dynamics', flow's and policy's
    params, and per iteration a dict of the fit's ``E_lml`` and ``loss``,
    the flow's and the policy's losses an iteration (numpy), the real
    return, the control steps taken, the whitening ``scaling`` the fits
    used, and the host-clock seconds of the three fits
    (``dyn_s``/``flow_s``/``pol_s``, each ending on a copy to the host)."""
    args = get_parser().parse_args(argv)
    device = resolve_device(device)
    env = init_env(args.env, args.seed, device)
    D = env.observation_size
    m = build(env, args, device)
    dyn, flow, pol_apply = m['dyn'], m['flow'], m['pol_apply']
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dyn_params = dyn.init(gen, device=device)
    pol_params = m['pol_spec'].mlp.init(gen, device=device)
    flow_params = flow.init(gen, device=device)
    adam = Adam(1e-3)  # init is the same for the three
    dyn_state, pol_state, flow_state = (adam.init(p) for p in (
        dyn_params, pol_params, flow_params))

    exp = ExperienceDataset()
    rnd = np.random.RandomState(args.seed)
    for _ in range(max(2, args.n_initial_epi)):
        exp.append_episode(*apply_controller(
            env, lambda x, t=0: rnd.uniform(env.action_space.low,
                                            env.action_space.high),
            args.control_H))

    def act(x, t=0):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(x, np.float32),
                                device=device).reshape(1, -1)
            return pol_apply(pol_params, x, None).cpu().numpy().flatten()

    history = []
    for it in range(args.ps_iters):
        S, A, NS, R, DN, L = (torch.as_tensor(v, device=device)
                              for v in sliding_windows(exp, args.window))
        scaling = {'s': fit_scaling(NS.reshape(-1, D)),
                   'r': fit_scaling(R.reshape(-1, 1))}
        n = S.shape[0]
        t0 = time.perf_counter()
        losses, e_lmls = [], []
        for _ in range(args.dyn_opt_iters):
            idx = torch.randint(0, n, (min(DYN_BATCH, n),), generator=gen,
                                device=device)
            dyn_params, dyn_state, loss, E_lml = m['dyn_step'](
                dyn_params, dyn_state, scaling, S[idx], A[idx], NS[idx],
                R[idx], DN[idx], L[idx], generator=gen)
            losses.append(loss)
            e_lmls.append(E_lml)
        rec = {'loss': torch.stack(losses).cpu().numpy(),
               'E_lml': torch.stack(e_lmls).cpu().numpy()}
        t1 = time.perf_counter()
        x0s = torch.tensor(np.stack([np.asarray(ep[0]) for ep in exp.states
                                     if len(ep)]), dtype=torch.float32,
                           device=device)
        flow_losses = []
        for _ in range(FLOW_STEPS):
            flow_params, flow_state, fl = m['flow_step'](
                flow_params, flow_state, x0s, generator=gen)
            flow_losses.append(fl)
        rec['flow_loss'] = torch.stack(flow_losses).cpu().numpy()
        t2 = time.perf_counter()
        pol_losses = []
        for _ in range(args.pol_opt_iters):
            with torch.no_grad():
                x0 = flow.sample(flow_params, gen, N_X0)
            pol_params, pol_state, pl = m['pol_step'](
                pol_params, pol_state, dyn_params, scaling, x0,
                generator=gen)
            pol_losses.append(pl)
        rec['pol_loss'] = torch.stack(pol_losses).cpu().numpy()
        t3 = time.perf_counter()
        rec.update(dyn_s=t1 - t0, flow_s=t2 - t1, pol_s=t3 - t2,
                   scaling=scaling)

        ret = apply_controller(env, act, args.control_H)
        exp.append_episode(*ret)
        rec['real_return'] = float(np.sum([np.sum(r) for r in ret[2]]))
        rec['control_steps'] = len(ret[1])
        history.append(rec)
        print(f'[transformer] it {it}: dyn E_lml={rec["E_lml"][-1]:.3f} '
              f'flow_loss={rec["flow_loss"][-1]:.3f} '
              f'pol_loss={rec["pol_loss"][-1]:.3f} '
              f'real_return={rec["real_return"]:.3f}', flush=True)
    params = {'dyn': dyn_params, 'flow': flow_params, 'pol': pol_params}
    return params, history


if __name__ == '__main__':
    main()

"""Model-based DDPG: an actor and a critic trained on imagined transitions of
a learned dropout-BNN dynamics model (counterpart of
``prob_mbrl_tpu/algorithms/mbddpg.py``).

Models (JAX ``mbddpg.py:48-76``):
  * actor: a Bernoulli-dropout (0.1) [200, 200] relu MLP with a tanh output,
    squashed to the action bounds by ``Policy``; exploration noise enters
    the imagined rollout through its ``action_eps``;
  * critic: a concrete-dropout (0.1) [200, 200] relu MLP on concat(state,
    action) with a scalar output;
  * dynamics: a concrete-dropout (0.5, temperature 0.1) [200, 200] relu MLP
    with a diagonal-Gaussian (or mixture) head; without ``reward_func`` it
    learns the reward as its last output.

One iteration (JAX ``mbddpg.py:79-187``): initial states drawn from a pool
and perturbed by ``x0_noise`` times its population std; an imagined rollout
with the actor's masks and exploration noise, detached (under
``torch.no_grad``); the T B transitions flattened time-major; then a sweep of
``n_batches = T B // B`` shuffled minibatches, each a TD(0) critic step on
``r + gamma Q_tgt(s', pi_tgt(s'))`` (the regulariser divided by the T B
transitions) and an actor step on ``-mean Q(s, pi(s))`` under the critic
just stepped and the critic loss's masks, its gradient taken wrt the actor
alone; last, one polyak step of both targets. On CUDA every actor, critic
and dynamics call goes through the fused-MLP kernels: an iteration launches
``fused_mlp_fwd`` 7 T times (2 T in the rollout, 5 a minibatch) and
``fused_mlp_bwd`` 3 T times (the critic loss's, then the actor loss's
through the critic and the actor).

Randomness: the port cannot reproduce ``jax.random``, so an iteration takes
its draws as one ``DDPGNoise`` (``draw_ddpg_noise`` draws them from a
``torch.Generator``); tests build them from JAX's key as JAX does.

The reference's transition flattening (``MBDDPG.py:155-162``) works only for
a 3-step rollout; the port follows JAX, which flattens (s_t, a_t, r_t,
s_{t+1}) over time and particles.
"""
import collections

import numpy as np
import torch

from ..models import (DiagGaussianDensity, DynamicsModel,
                      GaussianMixtureDensity, MLPSpec, Policy, Regressor,
                      bdropout, cdropout)
from ..utils.core import polyak_averaging, resolve_device, tree_map
from ..utils.optim import Adam, loss_and_grads
from ..utils.rollout import rollout
from ..utils.train_regressor import train_regressor
from .mc_pilco import derive_seed, seeded_generator

_INIT, _FIT, _POOL, _ITER = 0xDD1, 0xDD2, 0xDD3, 0xDD4

DDPGNoise = collections.namedtuple('DDPGNoise', [
    'idx', 'x0_eps', 'dyn_noise', 'actor_noise', 'action_eps', 'perm',
    'q_noise', 'qt_noise', 'at_noise', 'an_noise'])
DDPGNoise.__doc__ = """The draws of one DDPG iteration (JAX ``mbddpg.py:
108-148``): ``idx`` [B] rows of the initial-state pool, ``x0_eps`` [B, D]
and ``action_eps`` [T, B, U] standard normals (scaled by ``x0_noise`` times
the pool's std and by ``expl_noise``), the rollout's ``dyn_noise`` and
``actor_noise`` ({'mlp': ...}) at batch B, ``perm`` [T B] a permutation of
the transitions, and per minibatch the critic's noise of the critic and
actor losses (``q_noise``), the target critic's (``qt_noise``), the target
actor's (``at_noise``) and the actor's (``an_noise``), stacked over the T
minibatches: leaves [T, B, ...]."""


def make_actor(state_dim, action_dim, max_action, pol_shape=(200, 200)):
    """The actor (JAX ``mbddpg.py:48-54``): a Bernoulli-dropout MLP with a
    tanh output, squashed to ``max_action``."""
    mlp = MLPSpec(state_dim, action_dim, pol_shape, nonlin='relu',
                  output_nonlin='tanh', dropout=bdropout(0.1))
    max_u = (tuple(float(v) for v in max_action) if np.ndim(max_action)
             else (float(max_action),) * action_dim)
    return Policy(mlp=mlp, output_density=None, max_u=max_u)


def make_critic(state_dim, action_dim, critic_hidden=(200, 200)):
    """The critic (JAX ``mbddpg.py:57-61``): a concrete-dropout MLP on
    concat(state, action) with a scalar output."""
    mlp = MLPSpec(state_dim + action_dim, 1, critic_hidden, nonlin='relu',
                  dropout=cdropout(0.1))
    return Regressor(mlp=mlp, output_density=None)


def make_dyn_model(state_dim, action_dim, reward_func=None, dyn_components=1,
                   dyn_shape=(200, 200)):
    """The dynamics (JAX ``mbddpg.py:64-76``): D + 1 outputs, the last the
    learned reward, without ``reward_func``."""
    out_dim = state_dim + 1 if reward_func is None else state_dim
    if dyn_components > 1:
        density = GaussianMixtureDensity(out_dim, dyn_components)
    else:
        density = DiagGaussianDensity(out_dim)
    mlp = MLPSpec(state_dim + action_dim, density.n_inputs, dyn_shape,
                  nonlin='relu', dropout=cdropout(0.5, temperature=0.1))
    return DynamicsModel(regressor=Regressor(mlp=mlp, output_density=density),
                         reward_func=reward_func)


def draw_ddpg_noise(generator, actor, critic, dyn, horizon, batch_size,
                    pool_size, device=None):
    """A ``DDPGNoise`` drawn from ``generator`` on ``device``."""
    device = resolve_device(device)
    B, T = batch_size, horizon
    U, D = len(actor.max_u), dyn.state_dims

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    idx = torch.randint(0, pool_size, (B,), generator=generator,
                        device=device)
    x0_eps = normal(B, D)
    dyn_noise = dyn.sample_noise(generator, (B,), device=device)
    actor_noise = {'mlp': actor.mlp.sample_noise(generator, (B,),
                                                 device=device)}
    action_eps = normal(T, B, U)
    perm = torch.randperm(T * B, generator=generator, device=device)
    # T B transitions make T minibatches of B
    return DDPGNoise(
        idx, x0_eps, dyn_noise, actor_noise, action_eps, perm,
        critic.sample_noise(generator, (T, B), device=device),
        critic.sample_noise(generator, (T, B), device=device),
        {'mlp': actor.mlp.sample_noise(generator, (T, B), device=device)},
        {'mlp': actor.mlp.sample_noise(generator, (T, B), device=device)})


def make_ddpg_iteration_fn(actor, critic, dyn, actor_opt, critic_opt,
                           horizon, batch_size=100, discount=0.99, tau=0.005,
                           expl_noise=1.0, x0_noise=0.1):
    """One DDPG iteration (JAX ``mbddpg.py:79-187``).

    ``actor_opt`` / ``critic_opt``: ``algorithms.value.Adam``s. Returns
    ``iteration(actor_params, actor_tgt, a_opt_state, critic_params,
    critic_tgt, c_opt_state, critic_stats, dyn_params, dyn_stats, x0_pool,
    noise=None, generator=None) -> (actor_params, actor_tgt, a_opt_state,
    critic_params, critic_tgt, c_opt_state, metrics)``: ``noise`` a
    ``DDPGNoise``, else drawn from ``generator`` on the pool's device;
    ``metrics`` the last minibatch's ``actor_loss`` and ``critic_loss`` and
    the imagined ``mean_reward``, as 0-dim tensors on the device.
    """
    U, B = len(actor.max_u), batch_size

    def critic_apply(params, stats, s, a, noise):
        return critic.apply(params, stats, torch.cat([s, a], -1), noise)

    def critic_loss_fn(params, stats, s, a, targets, noise, N):
        q = critic_apply(params, stats, s, a, noise)
        return (torch.mean((q - targets) ** 2)
                + critic.regularization_loss(params) / N)

    def actor_loss_fn(params, critic_params, stats, s, a_noise, q_noise):
        pi = actor.apply(params, s, a_noise, return_samples=True)
        return -torch.mean(critic_apply(critic_params, stats, s, pi, q_noise))

    def iteration(actor_params, actor_tgt, a_opt_state, critic_params,
                  critic_tgt, c_opt_state, critic_stats, dyn_params,
                  dyn_stats, x0_pool, noise=None, generator=None):
        if noise is None:
            if generator is None:
                raise ValueError('make_ddpg_iteration_fn: pass noise= or a '
                                 'generator to draw it')
            noise = draw_ddpg_noise(generator, actor, critic, dyn, horizon,
                                    B, x0_pool.shape[0], x0_pool.device)
        with torch.no_grad():
            x0 = (x0_pool[noise.idx] + x0_noise
                  * torch.std(x0_pool, 0, correction=0) * noise.x0_eps)
            states, actions, rewards = rollout(
                x0, dyn, actor, horizon, dyn_params, dyn_stats, actor_params,
                noise.dyn_noise, noise.actor_noise,
                action_eps=expl_noise * noise.action_eps)
        D = states.shape[-1]
        s = states[:-1].reshape(-1, D)
        s_next = states[1:].reshape(-1, D)
        a = actions.reshape(-1, U)
        r = rewards.reshape(-1, 1)
        N = s.shape[0]
        for i in range(N // B):
            rows = noise.perm[i * B:(i + 1) * B]
            mb_s, mb_sn, mb_a, mb_r = s[rows], s_next[rows], a[rows], r[rows]
            q_noise, qt_noise, at_noise, an_noise = (
                tree_map(lambda x: x[i], n) for n in noise[6:])
            # the TD(0) target from the frozen nets
            with torch.no_grad():
                pi_tgt = actor.apply(actor_tgt, mb_sn, at_noise,
                                     return_samples=True)
                q_tgt = critic_apply(critic_tgt, critic_stats, mb_sn, pi_tgt,
                                     qt_noise)
                targets = mb_r + discount * q_tgt
            c_loss, c_grads = loss_and_grads(
                lambda p: critic_loss_fn(p, critic_stats, mb_s, mb_a, targets,
                                         q_noise, N), critic_params)
            critic_params, c_opt_state = critic_opt.step(
                c_grads, c_opt_state, critic_params)
            # under the critic just stepped, with the critic loss's masks
            a_loss, a_grads = loss_and_grads(
                lambda p: actor_loss_fn(p, critic_params, critic_stats, mb_s,
                                        an_noise, q_noise), actor_params)
            actor_params, a_opt_state = actor_opt.step(
                a_grads, a_opt_state, actor_params)
        critic_tgt = polyak_averaging(critic_params, critic_tgt, tau)
        actor_tgt = polyak_averaging(actor_params, actor_tgt, tau)
        metrics = {'actor_loss': a_loss, 'critic_loss': c_loss,
                   'mean_reward': torch.mean(r)}
        return (actor_params, actor_tgt, a_opt_state, critic_params,
                critic_tgt, c_opt_state, metrics)

    return iteration


class MBDDPG:
    """Specs, params and optimizers of model-based DDPG in one object (JAX
    ``mbddpg.py:190-266``).

    Its draws come from generators on ``device`` seeded from ``seed``: the
    initial params', each dynamics fit's and each ``fit`` call's iterations'
    (one generator a call); each call's initial-state pool comes from a
    seeded ``np.random.RandomState``. The actor and the critic keep one Adam
    (1e-3) state each across calls; the dynamics fit starts a fresh Adam
    (1e-3) state every call, as JAX's does.
    """

    def __init__(self, state_dim, action_dim, max_action, reward_func=None,
                 dyn_components=1, seed=0, device=None):
        self.device = resolve_device(device)
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.seed = seed
        self.actor = make_actor(state_dim, action_dim, max_action)
        self.critic = make_critic(state_dim, action_dim)
        self.dyn = make_dyn_model(state_dim, action_dim, reward_func,
                                  dyn_components)

        gen = seeded_generator(self.device, seed, _INIT)
        self.actor_params = self.actor.init(gen, device=self.device)
        self.actor_target = tree_map(torch.clone, self.actor_params)
        self.critic_params = self.critic.init(gen, device=self.device)
        self.critic_target = tree_map(torch.clone, self.critic_params)
        self.critic_stats = self.critic.init_stats(device=self.device)
        self.dyn_params = self.dyn.init(gen, device=self.device)
        self.dyn_stats = self.dyn.init_stats(device=self.device)

        self.actor_opt = Adam(1e-3)
        self.critic_opt = Adam(1e-3)
        self.dyn_opt = Adam(1e-3)
        self.actor_opt_state = self.actor_opt.init(self.actor_params)
        self.critic_opt_state = self.critic_opt.init(self.critic_params)
        self.dyn_opt_state = None
        self.n_fits = 0

    def __call__(self, state, **kwargs):
        """The greedy action (the mean net, no dropout) for one state."""
        s = torch.as_tensor(np.asarray(state, np.float32).reshape(1, -1),
                            device=self.device)
        with torch.no_grad():
            u = self.actor.apply(self.actor_params, s, noise=None,
                                 return_samples=True)
        return u.cpu().numpy().flatten()

    def fit_dynamics(self, exp, batch_size=100, iterations=2000):
        """Fit the dynamics to the experience from a fresh Adam state;
        returns the fit's metrics."""
        X, Y = exp.get_dynmodel_dataset(
            deltas=True, return_costs=self.dyn.reward_func is None)
        X = torch.as_tensor(X, device=self.device)
        Y = torch.as_tensor(Y, device=self.device)
        self.dyn_stats = self.dyn.fit_stats(X, Y)
        self.dyn_params, self.dyn_opt_state, metrics = train_regressor(
            self.dyn.regressor, self.dyn_params, self.dyn_stats, X, Y,
            seeded_generator(self.device, self.seed, _FIT, self.n_fits),
            iters=iterations, batchsize=batch_size, optimizer=self.dyn_opt)
        return metrics

    def fit(self, exp, horizon, iterations, model_fit_iters=2000,
            batch_size=100, discount=0.99, tau=0.005, callback=None):
        """Fit the dynamics, then ``iterations`` DDPG iterations from 4096
        states of the experience. Returns the history: a dict of numpy
        scalars an iteration (one copy to the host at the end);
        ``callback(it, metrics)`` gets each iteration's device metrics."""
        self.fit_dynamics(exp, batch_size, model_fit_iters)
        iteration = make_ddpg_iteration_fn(
            self.actor, self.critic, self.dyn, self.actor_opt,
            self.critic_opt, horizon, batch_size, discount, tau)
        rng = np.random.RandomState(
            derive_seed(self.seed, _POOL, self.n_fits) % 2 ** 32)
        x0_pool = torch.as_tensor(exp.sample_states(4096, timestep=None,
                                                    rng=rng),
                                  device=self.device)
        gen = seeded_generator(self.device, self.seed, _ITER, self.n_fits)
        self.n_fits += 1
        history = []
        for it in range(iterations):
            (self.actor_params, self.actor_target, self.actor_opt_state,
             self.critic_params, self.critic_target, self.critic_opt_state,
             metrics) = iteration(
                self.actor_params, self.actor_target, self.actor_opt_state,
                self.critic_params, self.critic_target, self.critic_opt_state,
                self.critic_stats, self.dyn_params, self.dyn_stats, x0_pool,
                generator=gen)
            history.append(metrics)
            if callable(callback):
                callback(it, metrics)
        if not history:
            return []
        stacked = {k: torch.stack([m[k] for m in history]).cpu().numpy()
                   for k in history[0]}
        return [{k: v[i] for k, v in stacked.items()}
                for i in range(len(history))]

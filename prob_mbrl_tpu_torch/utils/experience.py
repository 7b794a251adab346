"""Episodic experience dataset and the prioritized-replay SumTree
(counterpart of ``prob_mbrl_tpu/utils/experience.py``).

Host-side numpy, as in the JAX package: episodes are stored ragged and
append-only; ``get_dynmodel_dataset`` turns them into dense float32 arrays
that the dynamics fit copies to the device once per episode. ``save`` and
``load`` pickle the same dict as the JAX package, so either package reads the
other's file.
"""
import collections.abc
import os
import pickle

import numpy as np

from ..ops.angles import to_complex


class ExperienceDataset:
    """Episodic store of (t, state, action, reward, done, info, policy_params)
    (`experience_dataset.py:9-268`)."""

    def __init__(self, name='Experience'):
        self.name = name
        self.time_stamps = []
        self.states = []
        self.actions = []
        self.rewards = []
        self.done = []
        self.info = []
        self.policy_parameters = []
        self.curr_episode = -1
        self.state_changed = True

    # -- episode bookkeeping ------------------------------------------------
    def new_episode(self, policy_params=None):
        self.time_stamps.append([])
        self.states.append([])
        self.actions.append([])
        self.rewards.append([])
        self.done.append([])
        self.info.append([])
        self.policy_parameters.append(policy_params or [])
        self.curr_episode += 1
        self.state_changed = True

    def add_sample(self, x_t=None, u_t=None, c_t=None, done=None, info=None,
                   t=None):
        if self.curr_episode < 0:
            self.new_episode()
        ep = self.curr_episode
        self.states[ep].append(x_t)
        self.actions[ep].append(u_t)
        self.rewards[ep].append(c_t)
        self.done[ep].append(done)
        self.info[ep].append(info)
        self.time_stamps[ep].append(t)
        self.state_changed = True

    def append_episode(self, states, actions, rewards, dones=None, infos=None,
                       policy_params=None, ts=None):
        if policy_params is not None:
            self.policy_parameters.append(policy_params)
        if dones is not None:
            self.done.append(list(dones))
        if infos is not None:
            self.info.append(list(infos))
        if ts is not None:
            self.time_stamps.append(list(ts))
        self.states.append(list(states))
        self.actions.append(list(actions))
        self.rewards.append(list(rewards))
        self.curr_episode += 1
        self.state_changed = True

    def n_samples(self):
        return sum(len(s) for s in self.states)

    def n_episodes(self):
        return len(self.states)

    def reset(self):
        self.__init__(self.name)
        self.state_changed = False

    def truncate(self, episode):
        if 0 < episode <= self.curr_episode:
            self.curr_episode = episode
            for attr in ('time_stamps', 'states', 'actions', 'rewards',
                         'done', 'info', 'policy_parameters'):
                setattr(self, attr, getattr(self, attr)[episode:])

    # -- supervised conversion ---------------------------------------------
    def get_dynmodel_dataset(self, deltas=True, filter_episodes=None,
                             angle_dims=None, x_steps=1, u_steps=1,
                             output_steps=1, return_costs=False, stack=False):
        """(state, action) history -> future state deltas (+rewards) pairs.

        Mirrors `experience_dataset.py:122-234`: multi-step history stacking
        with initial-state padding for states and zero padding for actions;
        outputs are per-step deltas (or raw next states) over
        ``output_steps`` future steps, with rewards appended when
        ``return_costs``.
        """
        angle_dims = tuple(angle_dims or ())
        eps = filter_episodes
        if eps is None or (isinstance(eps, list) and not eps):
            eps = list(range(self.n_episodes()))
        if not isinstance(eps, (list, tuple)):
            eps = [eps]

        if stack:
            u_steps = x_steps
            output_steps = x_steps + output_steps - 1
        join = np.stack if stack else np.concatenate

        inputs, targets = [], []
        for epi in eps:
            if len(self.states[epi]) == 0:
                continue
            states = np.asarray(self.states[epi], np.float64)
            actions = np.asarray(self.actions[epi], np.float64)
            if actions.ndim == 1:
                actions = actions[:, None]
            H = states.shape[0]
            n_out = H - output_steps  # rows in the supervised pairs

            s_emb = to_complex(states, angle_dims)
            # pad history with the initial state
            s_pad = np.concatenate([np.repeat(s_emb[:1], x_steps - 1, 0),
                                    s_emb], 0)
            s_hist = join([s_pad[i:i + n_out] for i in range(x_steps)], 1)

            a_pad = np.concatenate(
                [np.zeros((u_steps - 1, actions.shape[1])), actions], 0)
            a_hist = join([a_pad[i:i + n_out] for i in range(u_steps)], 1)

            inp = np.concatenate([s_hist, a_hist], -1)

            o_states = join([states[i:H - (output_steps - i - 1)]
                             for i in range(output_steps)], 1)
            tgt = (o_states[1:] - o_states[:-1]) if deltas else o_states[1:]

            if return_costs:
                rewards = np.asarray(self.rewards[epi], np.float64).reshape(
                    H, -1)
                o_costs = join([rewards[i:H - (output_steps - i - 1)]
                                for i in range(output_steps)], 1)
                tgt = np.concatenate([tgt, o_costs[:-1]], -1)

            inputs.append(inp)
            targets.append(tgt)

        X = np.concatenate(inputs).astype(np.float32)
        Y = np.concatenate(targets).astype(np.float32)
        return X, Y

    def sample_states(self, n_samples=1, timestep=0, rng=None):
        """Sample states from chosen timesteps (`experience_dataset.py:236-249`)."""
        rng = rng if rng is not None else np.random
        if timestep is None:
            x0 = np.concatenate([np.asarray(ep) for ep in self.states
                                 if len(ep)])
        else:
            if not isinstance(timestep, collections.abc.Iterable):
                timestep = [timestep]
            rows = [np.asarray(ep[t]) for ep in self.states
                    for t in timestep if t < len(ep)]
            x0 = np.stack(rows)
        idx = rng.choice(len(x0), n_samples)
        return x0[idx].astype(np.float32)

    # -- persistence --------------------------------------------------------
    def save(self, filename):
        d = os.path.dirname(filename)
        if d:
            os.makedirs(d, exist_ok=True)
        state = dict(states=self.states, actions=self.actions,
                     rewards=self.rewards, info=self.info, done=self.done,
                     time_stamps=self.time_stamps,
                     curr_episode=self.curr_episode,
                     policy_parameters=self.policy_parameters)
        with open(filename, 'wb') as f:
            pickle.dump(state, f)

    def load(self, filename):
        with open(filename, 'rb') as f:
            self.__dict__.update(pickle.load(f))


class SumTree:
    """Array-backed sum tree with priority renormalization, visit counts and
    stratified batched sampling (`experience_dataset.py:271-367`).

    Vectorized numpy retrieval; importance weights are ``(N p)^-beta``
    normalized by their max.
    """

    def __init__(self, max_size):
        self.max_size = max_size
        self.data = [None] * max_size
        self.tree = np.zeros(2 * max_size - 1)
        self.counts = np.zeros(max_size)
        self.idx = 0
        self.max_p = 1.0
        self.max_count = 0
        self.size = 0
        self.norm_factor = 1.0

    def append(self, data, priority):
        self.data[self.idx] = data
        self.counts[self.idx] = 1
        self.update(self.idx + self.max_size - 1, priority)
        self.idx = (self.idx + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def update(self, tree_idx, priority):
        self.tree[tree_idx] = priority * self.norm_factor
        i = tree_idx
        while i != 0:
            parent = (i - 1) // 2
            left = 2 * parent + 1
            self.tree[parent] = self.tree[left] + self.tree[left + 1]
            i = parent
        self.max_p = max(self.max_p, priority)

    def renormalize(self):
        total = self.tree[0]
        if total > 0:
            nf = 1.0 / total
            self.norm_factor *= nf
            self.tree *= nf

    def _retrieve_batch(self, priorities):
        n_nodes = len(self.tree)
        idx = np.zeros(len(priorities), np.int64)
        p = priorities.astype(np.float64).copy()
        left = 2 * idx + 1
        in_bounds = left < n_nodes
        while in_bounds.any():
            left_val = self.tree[np.minimum(left, n_nodes - 1)]
            go_left = p <= left_val
            new_idx = np.where(go_left, left, left + 1)
            idx = np.where(in_bounds, new_idx, idx)
            p = np.where(in_bounds & ~go_left, p - left_val, p)
            left = 2 * idx + 1
            in_bounds = left < n_nodes
        return idx

    def get_batch(self, priorities):
        priorities = np.atleast_1d(priorities)
        idxs = self._retrieve_batch(priorities)
        data_idxs = idxs - self.max_size + 1
        return idxs, self.tree[idxs], [self.data[i] for i in data_idxs]

    def sample(self, batchsize, beta=1.0, rng=None):
        rng = rng if rng is not None else np.random
        total = self.tree[0]
        seg = total / batchsize
        targets = (np.arange(batchsize) + rng.rand(batchsize)) * seg
        idxs, priorities, samples = self.get_batch(targets)
        data_idxs = idxs - self.max_size + 1
        self.counts[data_idxs] += 1
        self.max_count = max(self.max_count, self.counts[data_idxs].max())
        probs = np.asarray(priorities) / total
        weights = (self.size * np.maximum(probs, 1e-12)) ** -beta
        weights = weights / weights.max()
        return samples, idxs, weights

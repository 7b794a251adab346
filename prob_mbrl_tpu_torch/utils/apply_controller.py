"""Real-environment controller runner
(counterpart of ``prob_mbrl_tpu/utils/apply_controller.py``).

Host loop: steps a gym-style env with a policy callable for ``max_steps``,
with optional preprocessing, per-step callback, real-time pacing via
``env.dt`` and early stop on done. Returns (states, actions, costs, dones,
infos) tuples, as the JAX package does.
"""
import time

import numpy as np


def apply_controller(env, policy, max_steps, preprocess=None, callback=None,
                     realtime=False, stop_when_done=True, quiet=True):
    if not quiet:
        if hasattr(env, 'dt'):
            print('apply_controller', 'Running for %f seconds'
                  % (max_steps * env.dt))
        else:
            print('apply_controller', 'Running for %d steps' % max_steps)
    dt = getattr(env, 'dt', None)
    x_t = env.reset()

    data = []
    t_ = time.time()
    t0 = t_
    for t in range(max_steps):
        x_t_ = preprocess(x_t) if callable(preprocess) else x_t
        u_t = policy(x_t_, t=t)
        if isinstance(u_t, (list, tuple)):
            u_t = np.asarray(u_t[0]).flatten()
        else:
            u_t = np.asarray(u_t).flatten()

        x_next, c_t, done, info = env.step(u_t)
        info = dict(info)
        info['done'] = done
        info['t'] = t * dt if (realtime and dt) else time.time() - t0

        data.append((np.asarray(x_t), u_t, np.asarray(c_t).reshape(-1),
                     done, info))
        if callable(callback):
            callback(x_t, u_t, c_t, done, info)
        if done and stop_when_done:
            break
        x_t = x_next

        if realtime and dt:
            time.sleep(max(float(dt - (time.time() - t_)), 0))
        t_ = time.time()

    states, actions, costs, dones, infos = zip(*data)
    if not quiet:
        total = float(np.sum([np.sum(c) for c in costs]))
        print('apply_controller',
              'Done after [%d] steps. Value of run [%f]' % (t + 1, total))
    if hasattr(env, 'stop'):
        env.stop()
    return states, actions, costs, dones, infos

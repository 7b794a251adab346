"""Trajectory plotting helpers (counterpart of
``prob_mbrl_tpu/utils/plotting.py``; reference ``prob_mbrl/utils/core.py:18-120``).

matplotlib is imported when a function draws, not with the module (the
card's machine has none): there a plot function raises ImportError. The
backend is Agg unless a display backend is configured. Figures are returned
so callers save or show them; ``plot_rollout`` runs an imagined rollout
without moment matching through ``utils.rollout`` and plots its particles.
"""
import numpy as np
import torch


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('prob_mbrl_tpu_torch.utils.plotting needs '
                          'matplotlib, which is not installed') from e
    if not matplotlib.get_backend().lower().startswith(('qt', 'tk',
                                                        'macosx')):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_sample(data, axarr, colors=None, **kwargs):
    """Per-dimension line plots of one trajectory sample [H, D] on the
    matplotlib axes ``axarr``."""
    data = _numpy(data)
    H, D = data.shape
    if colors is None:
        colors = [f'C{i % 10}' for i in range(D)]
    for d in range(D):
        axarr[d].plot(np.arange(H), data[:, d], color=colors[d], **kwargs)
    return axarr


def plot_mean_var(data, axarr, colors=None, k=2.0, **kwargs):
    """Mean +/- k sigma bands over the particle axis of ``data``
    [H, N_particles, D], on the matplotlib axes ``axarr``."""
    data = _numpy(data)
    H, N, D = data.shape
    t = np.arange(H)
    if colors is None:
        colors = [f'C{i % 10}' for i in range(D)]
    mean = data.mean(1)
    std = data.std(1)
    for d in range(D):
        axarr[d].plot(t, mean[:, d], color=colors[d], **kwargs)
        axarr[d].fill_between(t, mean[:, d] - k * std[:, d],
                              mean[:, d] + k * std[:, d],
                              color=colors[d], alpha=0.3)
    return axarr


def plot_trajectories(states, actions, rewards, plot_samples=True,
                      fig_prefix=''):
    """Three figures (states, actions, rewards), one axis a dimension: up to
    50 particles' samples and the mean +/- 2 sigma band. states
    [H+1, N, D] or [H+1, D]; actions [H, N, U]; rewards [H, N, 1]. Returns
    the figures."""
    plt = _pyplot()
    figs = []
    for name, data in [('states', states), ('actions', actions),
                       ('rewards', rewards)]:
        data = _numpy(data)
        if data.ndim == 2:
            data = data[:, None, :]
        D = data.shape[-1]
        fig, axarr = plt.subplots(D, 1, squeeze=False, sharex=True,
                                  num=f'{fig_prefix}{name}')
        axarr = [a[0] for a in axarr]
        for ax in axarr:
            ax.clear()
        if plot_samples and data.shape[1] > 1:
            for i in range(min(data.shape[1], 50)):
                plot_sample(data[:, i], axarr, alpha=0.3, linewidth=0.5)
        plot_mean_var(data, axarr)
        axarr[0].set_title(f'{fig_prefix}{name}')
        figs.append(fig)
    return figs


def plot_rollout(x0, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
                 generator=None, **kwargs):
    """Roll the particles ``x0`` [B, D] for ``steps`` steps through
    ``utils.rollout`` (dynamics and policy noise drawn from ``generator``,
    default one seeded with 0; ``kwargs`` go to ``rollout``) and plot them
    (``plot_trajectories``). Returns the three figures."""
    from .rollout import rollout

    _pyplot()
    if generator is None:
        generator = torch.Generator(device=x0.device)
        generator.manual_seed(0)
    B = x0.shape[0]
    dyn_noise = dyn.sample_noise(generator, (B,), device=x0.device)
    pol_noise = pol.sample_noise(generator, (B,), device=x0.device)
    with torch.no_grad():
        states, actions, rewards = rollout(x0, dyn, pol, steps, dyn_params,
                                           dyn_stats, pol_params, dyn_noise,
                                           pol_noise, **kwargs)[:3]
    return plot_trajectories(states, actions, rewards)

"""2-D multimodal BNN regression with a mixture density network
(counterpart of the repo's ``examples/bnn_regression_2d.py``): the target is
one-to-many (points on two concentric noisy circles, a multimodal p(y | x));
a GaussianMDN captures the modes where a GaussianDN averages them.

    python -m prob_mbrl_tpu_torch.examples.bnn_regression_2d

Runs on ``cuda`` unless ``main`` is given ``device='cpu'``. The fused-MLP
kernels take no hhSinLU, so these networks run on the MLP's unfused path.
"""
import numpy as np
import torch

from ..utils.core import resolve_device
from .bnn_regression import fit_models


def make_dataset(n=2000, seed=0, device=None):
    """x = an angle -> y = a point on one of two concentric noisy circles:
    (X [n, 1], Y [n, 2]) float32, from the same ``np.random.RandomState``
    draws as JAX's."""
    rng = np.random.RandomState(seed)
    theta = rng.uniform(-np.pi, np.pi, n)
    radius = np.where(rng.rand(n) > 0.5, 1.0, 2.0)
    y = np.stack([radius * np.cos(theta), radius * np.sin(theta)], -1)
    y = y + 0.05 * rng.randn(n, 2)
    device = resolve_device(device)
    return (torch.tensor(theta[:, None], dtype=torch.float32, device=device),
            torch.tensor(y, dtype=torch.float32, device=device))


def main(iters=10000, plot=True, device=None, out='bnn_regression_2d.png'):
    """Fit both models and, with ``plot``, draw samples of each into ``out``
    (Agg); returns the fits."""
    X, Y = make_dataset(device=device)
    results = fit_models(X, Y, iters, 'bnn_regression_2d', outputs=2)
    if plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(1, len(results), figsize=(12, 5))
        gen = torch.Generator(X.device).manual_seed(7)
        xg = torch.tensor(np.random.RandomState(1).uniform(
            -np.pi, np.pi, 2000)[:, None], dtype=torch.float32,
            device=X.device)
        Yn = Y.cpu().numpy()
        for ax, (name, (model, params, scaling, nll)) in zip(
                np.atleast_1d(axs), results.items()):
            with torch.no_grad():
                noise = model.sample_noise(gen, (xg.shape[0],),
                                           device=X.device)
                dist = model.apply(params, scaling, xg, noise)
                s = dist.rsample(generator=gen).cpu().numpy()
            ax.plot(Yn[:, 0], Yn[:, 1], 'k.', markersize=1, alpha=0.2,
                    label='data')
            ax.plot(s[:, 0], s[:, 1], 'C1.', markersize=1.5, alpha=0.4,
                    label='samples')
            ax.set_title(f'{name} (NLL {nll:.3f})')
            ax.legend()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f'[bnn_regression_2d] plot -> {out}', flush=True)
    return results


if __name__ == '__main__':
    main()

"""1-D heteroscedastic BNN regression with full-covariance density networks
(counterpart of the repo's ``examples/bnn_regression.py``): a GaussianDN and
a 5-component GaussianMDN (concrete dropout, hhSinLU activations) fit a
gap-riddled noisy sine; the plot shows the posterior's per-particle mean and
std bands and noiseless samples at temperature -> 0.

    python -m prob_mbrl_tpu_torch.examples.bnn_regression

Runs on ``cuda`` unless ``main`` is given ``device='cpu'``. The fused-MLP
kernels take no hhSinLU, so these networks run on the MLP's unfused path.
"""
import numpy as np
import torch

from ..models import density_network_mlp, mixture_density_network_mlp
from ..utils.core import resolve_device
from ..utils.optim import Adam
from ..utils.train_model import train_model


def make_dataset(n=1000, seed=0, device=None):
    """The gap-riddled heteroscedastic sine: (X [n, 1], Y [n, 1]) float32,
    from the same ``np.random.RandomState`` draws as JAX's."""
    rng = np.random.RandomState(seed)
    segments = [(-4.0, -3.0), (-2.0, -1.0), (0.5, 1.5), (2.5, 4.0)]
    xs = np.concatenate([rng.uniform(a, b, n // len(segments))
                         for a, b in segments])
    noise = (0.1 + 0.3 * np.abs(np.cos(0.5 * xs))) * rng.randn(len(xs))
    ys = np.sin(xs) + 1e-1 * xs ** 2 + noise
    device = resolve_device(device)
    return (torch.tensor(xs[:, None], dtype=torch.float32, device=device),
            torch.tensor(ys[:, None], dtype=torch.float32, device=device))


def build_models(outputs=1):
    """[(name, model)]: the GaussianDN and the 5-component GaussianMDN, [200,
    200] hhSinLU with concrete dropout 0.1, from 1 input to ``outputs``."""
    return [('GaussianDN', density_network_mlp(
                1, outputs, hids=(200, 200), dropout=0.1,
                activation='hhsinlu')),
            ('GaussianMDN', mixture_density_network_mlp(
                1, outputs, nc=5, hids=(200, 200), dropout=0.1,
                activation='hhsinlu'))]


def fit_models(X, Y, iters, tag, outputs=1):
    """Fit each model (seeded params, Adam 1e-4, batch 100); returns {name:
    (model, params, scaling, nll)}, nll the last 100 steps' mean -E_lml."""
    device = X.device
    results = {}
    for name, model in build_models(outputs):
        params = model.init(torch.Generator(device).manual_seed(0),
                            device=device)
        scaling = model.fit_scaling(X, Y)
        params, _, metrics = train_model(
            model, params, scaling, X, Y,
            torch.Generator(device).manual_seed(1), iters=iters,
            batchsize=100, optimizer=Adam(1e-4))
        nll = -float(np.asarray(metrics['E_lml'])[-100:].mean())
        print(f'[{tag}] {name}: final NLL = {nll:.4f}', flush=True)
        results[name] = (model, params, scaling, nll)
    return results


def posterior_particles(model, params, scaling, x_grid, n_particles=50,
                        temperature=1.0, generator=None):
    """[P, N, D] samples over a grid, each particle with its own dropout
    masks; drawn from ``generator`` (default seeded 42)."""
    if generator is None:
        generator = torch.Generator(x_grid.device).manual_seed(42)
    out = []
    with torch.no_grad():
        for _ in range(n_particles):
            noise = model.sample_noise(generator, (x_grid.shape[0],),
                                       device=x_grid.device)
            dist = model.apply(params, scaling, x_grid, noise,
                               temperature=temperature)
            out.append(dist.rsample(generator=generator))
    return torch.stack(out)


def main(iters=15000, plot=True, device=None, out='bnn_regression.png'):
    """Fit both models and, with ``plot``, draw them into ``out`` (Agg);
    returns the fits."""
    X, Y = make_dataset(device=device)
    results = fit_models(X, Y, iters, 'bnn_regression')
    if plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        x_grid = torch.linspace(-5, 5, 400, device=X.device)[:, None]
        xg = x_grid.cpu().numpy()[:, 0]
        fig, axs = plt.subplots(1, len(results), figsize=(12, 5))
        for ax, (name, (model, params, scaling, nll)) in zip(
                np.atleast_1d(axs), results.items()):
            samples = posterior_particles(model, params, scaling,
                                          x_grid).cpu().numpy()
            noiseless = posterior_particles(
                model, params, scaling, x_grid,
                temperature=1e-9).cpu().numpy()
            ax.plot(X.cpu().numpy()[:, 0], Y.cpu().numpy()[:, 0], 'k.',
                    markersize=1, alpha=0.3)
            for i in range(min(20, samples.shape[0])):
                ax.plot(xg, noiseless[i, :, 0], 'C0-', alpha=0.2,
                        linewidth=0.5)
            m, s = samples.mean(0)[:, 0], samples.std(0)[:, 0]
            ax.plot(xg, m, 'C1-')
            ax.fill_between(xg, m - 2 * s, m + 2 * s, color='C1', alpha=0.2)
            ax.set_title(f'{name} (NLL {nll:.3f})')
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f'[bnn_regression] plot -> {out}', flush=True)
    return results


if __name__ == '__main__':
    main()

"""The port's tooling against the JAX package, on the CPU:
``utils/profiling.py`` (a Chrome trace written by ``trace`` with the spans
of ``annotate``; ``section`` accumulating; ``device_memory_stats`` empty
for the CPU, as JAX's is where the backend has none) and
``utils/plotting.py`` (each figure's axes, lines and bands against JAX's
functions on the same arrays, exactly; ``plot_rollout`` through the port's
rollout; matplotlib imported only when a function draws).
"""
import importlib
import json
import sys
import time

import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch.utils import plotting as tplot
from prob_mbrl_tpu_torch.utils import profiling as tprof
from prob_mbrl_tpu_torch.convert import params_from_jax
from test_torch_mm_variants import B, D, T, one_thread, setup  # noqa: F401


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with tprof.trace(str(tmp_path / 'tr')) as prof:
        with tprof.annotate('port_span'):
            torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / 'tr' / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'port_span' for e in events)
    assert any(e.key == 'port_span' for e in prof.key_averages())


def test_section_accumulates_and_memory_stats_on_the_cpu():
    jprof = pytest.importorskip('prob_mbrl_tpu.utils.profiling')
    results = {}
    for _ in range(2):
        with tprof.section('work', results):
            time.sleep(0.01)
    with tprof.section('other', results, sync=False):
        pass
    assert set(results) == {'work', 'other'} and results['work'] >= 0.02
    assert tprof.device_memory_stats('cpu') == {}
    assert jprof.device_memory_stats() == {}


def _drawn(figs):
    """Each figure's axes: (lines' xy data, bands' vertices, title)."""
    out = []
    for fig in figs:
        axes = []
        for ax in fig.axes:
            axes.append(([np.asarray(ln.get_xydata()) for ln in ax.lines],
                         [np.asarray(p.vertices) for c in ax.collections
                          for p in c.get_paths()], ax.get_title()))
        out.append(axes)
    return out


@pytest.mark.parametrize('samples', [True, False])
def test_plot_trajectories_draws_what_jax_draws(samples):
    """The same lines (one a particle, up to 50, and the mean) and mean +/-
    2 sigma bands in each axis of the states, actions and rewards figures
    as JAX's ``plot_trajectories`` on the same arrays; tensors are taken as
    well as arrays."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    jplot = importlib.import_module('prob_mbrl_tpu.utils.plotting')
    rng = np.random.RandomState(0)
    s = rng.randn(6, 60, 3).astype(np.float32)
    a = rng.randn(5, 60, 1).astype(np.float32)
    r = rng.randn(5, 60, 1).astype(np.float32)
    ref = _drawn(jplot.plot_trajectories(s, a, r, samples, 'jax_'))
    got = _drawn(tplot.plot_trajectories(torch.tensor(s), a, r, samples,
                                         'port_'))
    plt.close('all')
    assert [len(f) for f in got] == [3, 1, 1]
    assert [[len(ax[0]) for ax in f] for f in got] == [
        [(51 if samples else 1)] * len(f) for f in got]
    for gf, rf in zip(got, ref):
        assert len(gf) == len(rf)
        for (gl, gb, gt), (rl, rb, rt) in zip(gf, rf):
            assert gt.replace('port_', '') == rt.replace('jax_', '')
            assert len(gl) == len(rl) and len(gb) == len(rb)
            for x, y in zip(gl + gb, rl + rb):
                np.testing.assert_array_equal(x, y)


def test_plot_rollout_plots_the_ports_rollout(setup):
    """``plot_rollout``: three figures of the port's rollout of x0 with the
    noise of a generator seeded with 0; its mean line is the rollout's
    particle mean."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from prob_mbrl_tpu_torch.utils.rollout import rollout
    _, _, tdyn, tpol = setup['specs']
    dp = params_from_jax(setup['dyn_params'], 'cpu')
    st = params_from_jax(setup['dyn_stats'], 'cpu')
    pp = params_from_jax(setup['pol_params'], 'cpu')
    x0 = torch.tensor(setup['x0'])
    figs = tplot.plot_rollout(x0, tdyn, tpol, 2 * T, dp, st, pp)
    gen = torch.Generator()
    gen.manual_seed(0)
    dn = tdyn.sample_noise(gen, (B,), device='cpu')
    pn = tpol.sample_noise(gen, (B,), device='cpu')
    with torch.no_grad():
        states = rollout(x0, tdyn, tpol, 2 * T, dp, st, pp, dn, pn)[0]
    drawn = _drawn(figs)
    plt.close('all')
    assert [len(f) for f in drawn] == [D, 1, 1]
    for d, (lines, bands, _) in enumerate(drawn[0]):
        assert len(lines) == B + 1 and len(bands) == 1
        np.testing.assert_allclose(lines[-1][:, 1],
                                   states[:, :, d].mean(1).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_plotting_imports_without_matplotlib_and_raises_when_drawing(
        monkeypatch):
    """The module imports with no matplotlib (the card's machine has none);
    a plot function then raises ImportError naming it."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    mod = importlib.reload(tplot)
    try:
        with pytest.raises(ImportError, match='needs matplotlib'):
            mod.plot_trajectories(np.zeros((3, 2, 1)), np.zeros((2, 2, 1)),
                                  np.zeros((2, 2, 1)))
    finally:
        monkeypatch.undo()
        importlib.reload(tplot)

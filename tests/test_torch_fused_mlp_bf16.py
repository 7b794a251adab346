"""The fused dropout-MLP with bf16 operands (rows 1-2's bf16 instance)
against the JAX package's Pallas ``fused_mlp(..., compute_dtype=bfloat16)``.

On the CPU the port runs the kernels' plain version
(``fused_mlp_plain(compute_dtype='bfloat16')``, whose backward rounds the
operands of each product as the Pallas kernel's ``_bwd_kernel`` does); JAX
runs its Pallas kernel in interpret mode. Inputs, masks and the output
cotangent are made with numpy from a seed and fed to both.

Tolerance: the products of two bf16 values are exact in float32, so the two
sides differ only by the order of float32 sums: every entry of the value,
dx, dW, db and d(mask) within 1e-5 * max|JAX| + 1e-6, except a share of at
most 5% of an output's entries, which must stay within 1e-2 * max|JAX|:
where an operand's float32 value lies within rounding of a bf16 tie, the two
sides round it to neighbouring bf16 values (one bf16 ulp, 2^-8 relative, of
one term). One such g_a entry moves a whole column of dW (6 of 240 entries
of dW_0 at these widths). JAX's own bf16 and float32 outputs
differ by ~2e-3 to 4e-2 of the max at these shapes; the test asserts that
the difference is live (above 1e-4 of the max) on the value and dx.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm

TIGHT, FLIP_SHARE, LOOSE = 1e-5, 5e-2, 1e-2
DIMS = (6, 40, 24, 10)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, B, dims, masks, biases=True):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    x = rng.randn(B, dims[0]).astype(f32)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(f32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.randn(b)).astype(f32) if biases else None
          for b in dims[1:]]
    ms = [((rng.rand(B, d) < 0.9) / f32(0.9)).astype(f32) if masks else None
          for d in dims[1:-1]]
    g = rng.randn(B, dims[-1]).astype(f32)
    return x, ws, bs, ms, g


def _jax(x, ws, bs, ms, nonlins, g, cdt):
    """JAX's value and VJP: [out, dx, *dW, *db (present), *dmask
    (present)]."""
    pb = [i for i, b in enumerate(bs) if b is not None]
    pm = [i for i, m in enumerate(ms) if m is not None]

    def f(x, ws, bs_p, ms_p):
        bs_all, ms_all = [None] * len(bs), [None] * len(ms)
        for i, b in zip(pb, bs_p):
            bs_all[i] = b
        for i, m in zip(pm, ms_p):
            ms_all[i] = m
        return jax_fused_mlp(x, tuple(ws), tuple(bs_all), tuple(ms_all),
                             nonlins, compute_dtype=cdt)

    out, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws],
                       [jnp.asarray(bs[i]) for i in pb],
                       [jnp.asarray(ms[i]) for i in pm])
    dx, dws, dbs, dms = vjp(jnp.asarray(g))
    return [np.asarray(v) for v in [out, dx, *dws, *dbs, *dms]]


def _port(fn, x, ws, bs, ms, nonlins, g):
    def t(a):
        return None if a is None else torch.tensor(a, requires_grad=True)

    tx, tws, tbs, tms = t(x), [t(w) for w in ws], [t(b) for b in bs], \
        [t(m) for m in ms]
    out = fn(tx, tws, tbs, tms, nonlins, compute_dtype='bfloat16')
    leaves = ([tx, *tws] + [b for b in tbs if b is not None]
              + [m for m in tms if m is not None])
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    return [out.detach().numpy()] + [v.numpy() for v in grads]


def _hold(got, ref, what):
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    off = err > TIGHT * scale + 1e-6
    assert off.mean() <= FLIP_SHARE, (what, float(off.mean()))
    assert float(err.max()) <= LOOSE * scale + 1e-6, (what, float(err.max()),
                                                       scale)


@pytest.mark.parametrize('nonlins', [('relu', 'relu'), ('tanh', 'swish'),
                                     ('sin', 'sinlu'), ('exp', 'identity')])
@pytest.mark.parametrize('B, masks', [(37, True), (203, True),
                                      (1030, False)])
def test_bf16_plain_matches_jax_pallas(nonlins, B, masks):
    """Value, dx, dW, db and d(mask) with Bernoulli masks at batches that
    are no multiple of the kernels' row groups of 4; B = 1030 runs JAX's
    kernel over three tiles of 512, the last one partial, without masks:
    there JAX's interpret-mode dW reads the masks' padded rows, which hold
    NaN, at either operand dtype (a limit of the reference)."""
    x, ws, bs, ms, g = _problem(B, B, DIMS, masks=masks)
    ref = _jax(x, ws, bs, ms, nonlins, g, 'bfloat16')
    f32 = _jax(x, ws, bs, ms, nonlins, g, None)
    for fn in (fm.fused_mlp, fm.fused_mlp_plain):
        got = _port(fn, x, ws, bs, ms, nonlins, g)
        assert len(got) == len(ref) == 2 + 3 + 3 + (2 if masks else 0)
        for i, (a, r) in enumerate(zip(got, ref)):
            _hold(a, r, (fn.__name__, nonlins, B, i))
    for i in (0, 1):  # the rounding is live: bf16 is not float32
        assert np.abs(ref[i] - f32[i]).max() > 1e-4 * np.abs(ref[i]).max()


def test_bf16_plain_without_masks_or_biases_matches_jax():
    x, ws, bs, ms, g = _problem(5, 23, (3, 16, 16, 16, 4), masks=False,
                                biases=False)
    nl = ('relu', 'tanh', 'relu')
    ref = _jax(x, ws, bs, ms, nl, g, 'bfloat16')
    got = _port(fm.fused_mlp_plain, x, ws, bs, ms, nl, g)
    assert len(got) == len(ref) == 2 + 4
    for i, (a, r) in enumerate(zip(got, ref)):
        _hold(a, r, i)


def test_mlp_spec_fused_bf16_matches_jax():
    """``MLPSpec(fused=True, compute_dtype='bfloat16')`` runs the kernel's
    plain version on the CPU and agrees with JAX's fused spec (its Pallas
    kernel, interpret mode), value and grads wrt the params and the
    concrete-dropout logits; ``fused=None`` stays on the unfused path, whose
    bf16 activations between layers (JAX's XLA path) differ from it."""
    kw = dict(hidden_dims=(24, 24), nonlin='tanh')
    jspec = jm.MLPSpec(5, 4, fused=True, compute_dtype='bfloat16',
                       **dict(kw, dropout=jm.cdropout(0.1)))
    tspec = tm.MLPSpec(5, 4, fused=True, compute_dtype='bfloat16',
                       **dict(kw, dropout=tm.cdropout(0.1)))
    B = 19
    jp = jspec.init(jax.random.PRNGKey(0))
    jn = jspec.sample_noise(jax.random.PRNGKey(1), (B,))
    x = np.random.RandomState(2).randn(B, 5).astype(np.float32)
    g = np.random.RandomState(3).randn(B, 4).astype(np.float32)

    def jf(p):
        return jspec.apply(p, jnp.asarray(x), jn, train=True)

    jout, vjp = jax.vjp(jf, jp)
    (jg,) = vjp(jnp.asarray(g))
    tp = params_from_jax(jp, 'cpu', requires_grad=True)
    tn = noise_from_jax(jn, 'cpu')
    tout = tspec.apply(tp, torch.tensor(x), tn, train=True)
    _hold(tout.detach().numpy(), np.asarray(jout), 'out')
    leaves = [tp['linear_0']['w'], tp['linear_out']['w'],
              tp['drop_1']['logit_p']]
    refs = [jg['linear_0']['w'], jg['linear_out']['w'],
            jg['drop_1']['logit_p']]
    for got, ref in zip(torch.autograd.grad(tout, leaves, torch.tensor(g)),
                        refs):
        _hold(got.numpy(), np.asarray(ref), 'grad')
    unfused = tm.MLPSpec(5, 4, compute_dtype='bfloat16',
                         **dict(kw, dropout=tm.cdropout(0.1)))
    assert not unfused._kernel_takes_it() and unfused._kernel_fits()
    other = unfused.apply(tp, torch.tensor(x), tn, train=True)
    assert float((other - tout).detach().abs().max()) > 0


def test_bf16_launch_plan_halves_the_weight_ring():
    """The bf16 plan's ring stages are 2 bytes an element, half of a
    float32 stage: its shared memory counts them so (and holds as many
    stages as fit, up to the weights' stages); the operands change nothing
    else of the plan at these shapes."""
    for dims, B in (((5, 200, 200, 2), 100), ((6, 200, 200, 10), 1000),
                    ((6, 1000, 1000, 10), 100)):
        p32, p16 = fm.launch_plan(dims, B), fm.launch_plan(dims, B, True)
        assert p16.stage == p32.stage
        assert p16.fwd_stages >= p32.fwd_stages
        assert p16.fwd_smem == (p32.fwd_smem - 4 * p32.fwd_stages * p32.stage
                                + 2 * p16.fwd_stages * p16.stage)
        assert p16.bwd_smem == (p32.bwd_smem - 4 * p32.bwd_stages * p32.stage
                                + 2 * p16.bwd_stages * p16.stage)
        assert max(p16.fwd_smem, p16.bwd_smem) <= fm.SMEM_MAX
        assert (p16.tile_rows, p16.clusters, p16.threads) == \
            (p32.tile_rows, p32.clusters, p32.threads)
    for cdt in (None, 'float32', torch.float32):
        assert fm.operand_dtype(cdt) is None
    assert fm.operand_dtype('bfloat16') is torch.bfloat16
    with pytest.raises(ValueError, match='bfloat16'):
        fm.operand_dtype('float16')
    with pytest.raises(ValueError, match='bfloat16'):
        tm.MLPSpec(3, 2, fused=True, compute_dtype='float16')


def _bf16_specs(mod, reward, D=5, U=1):
    """The Deep-PILCO Cartpole models at [16, 16] with fused bf16 MLPs."""
    kw = dict(fused=True, compute_dtype='bfloat16')
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * D, (16, 16), dropout=mod.cdropout(0.1), **kw),
        mod.DiagGaussianDensity(D)), reward_func=reward())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, (16, 16), dropout=mod.bdropout(0.1),
                                 **kw), mod.DiagGaussianDensity(U),
                     max_u=(10.0,))
    return dyn, pol


def _counting(monkeypatch):
    """Count the calls of the kernels' plain version with bf16 operands."""
    calls = []
    plain = fm.fused_mlp_plain

    def counted(*a, **k):
        calls.append(fm.operand_dtype(a[5] if len(a) > 5 else
                                      k.get('compute_dtype')))
        return plain(*a, **k)

    monkeypatch.setattr(fm, 'fused_mlp_plain', counted)
    return calls


def test_the_route_with_fused_bf16_mlps_matches_jax(monkeypatch):
    """MC-PILCO's loss on the ``utils.rollout`` route (the gate refuses
    bf16, as JAX's ``fused_mode`` does) with ``fused=True`` bf16 MLPs:
    JAX's rollout through its Pallas kernel with ``compute_dtype`` against
    the port's through the kernels' plain version (2 T calls of it, all
    bf16), B = 12, T = 4, states and rewards moment-matched; loss and
    mean_return within 1e-4 relative, the policy's gradient within 1e-3 of
    its max (float32 rounding carried through four Cholesky resamples)."""
    import importlib
    from prob_mbrl_tpu.envs import cartpole_reward as j_reward
    from prob_mbrl_tpu.utils.rollout import rollout as j_rollout
    from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
    from prob_mbrl_tpu_torch.envs import cartpole_reward as t_reward
    from prob_mbrl_tpu_torch.utils.core import tree_leaves
    jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
    B, T, D = 12, 4, 5
    jdyn, jpol = _bf16_specs(jm, j_reward)
    tdyn, tpol = _bf16_specs(tm, t_reward)
    k = jax.random.split(jax.random.PRNGKey(0), 6)
    rng = np.random.RandomState(1)
    X = (rng.randn(40, D + 1) * [1, 2, 3, 0.7, 0.7, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(40, D)).astype(np.float32)
    x0 = (rng.randn(B, D) * 0.1 + [0, 0, 0, 0, 1]).astype(np.float32)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    dp, pp = np_(jdyn.init(k[0])), np_(jpol.init(k[1]))
    st = np_(jdyn.fit_stats(jnp.asarray(X), jnp.asarray(Y)))
    noise = (np_(jdyn.sample_noise(k[2], (B,))),
             np_(jpol.sample_noise(k[3], (B,))),
             np.asarray(jax.random.normal(k[4], (B, D))),
             np.asarray(jax.random.normal(k[5], (B, 1))))

    w_t, _ = jmc.discount_weights(None, T)

    def jloss(p):
        _, _, r = j_rollout(jnp.asarray(x0), jdyn, jpol, T, dp, st, p,
                            noise[0], noise[1], mm_states=True,
                            mm_rewards=True, z_mm=noise[2], z_rr=noise[3],
                            mm_rewards_mean_only=True)
        return (jnp.mean(jnp.sum(r[..., 0] * w_t[:, None], 0)),
                jnp.mean(jnp.sum(r[..., 0], 0)))

    (jl, jr), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, pp))
    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                            mm_rewards=True, maximize=False)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu')
    assert opt.mode is None  # the utils.rollout route
    calls = _counting(monkeypatch)
    tp = params_from_jax(pp, 'cpu', requires_grad=True)
    tl, tr = opt.loss_fn(tp, torch.tensor(x0), params_from_jax(dp, 'cpu'),
                         params_from_jax(st, 'cpu'),
                         tuple(noise_from_jax(n, 'cpu') for n in noise))
    assert calls == [torch.bfloat16] * (2 * T)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tr.detach()), float(jr), rtol=1e-4)
    got = torch.autograd.grad(tl, tree_leaves(tp))
    ref = jax.tree_util.tree_leaves(jg)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-3 * scale)


def test_train_regressor_fits_a_fused_bf16_dynamics_model(monkeypatch):
    """``make_train_fn`` on a ``fused=True`` bf16 dynamics regressor: one
    call of the kernels' plain version (bf16) a step, finite losses and
    E_lml rising over 30 steps."""
    from prob_mbrl_tpu_torch.algorithms.value import Adam
    from prob_mbrl_tpu_torch.envs import cartpole_reward as t_reward
    from prob_mbrl_tpu_torch.utils.train_regressor import (make_train_fn,
                                                           normalize_dataset)
    dyn, _ = _bf16_specs(tm, t_reward)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(2)
    X = torch.tensor((rng.randn(60, 6) * [1, 2, 3, 0.7, 0.7, 5])
                     .astype(np.float32))
    Y = torch.tensor(0.1 * np.tanh(X.numpy()[:, :5]))
    Xn, Yn = normalize_dataset(dyn.fit_stats(X, Y), X, Y)
    params = dyn.init(gen, device='cpu')
    train = make_train_fn(dyn.regressor, Adam(1e-2), 20)
    calls = _counting(monkeypatch)
    _, _, metrics, _ = train(params, Adam(1e-2).init(params), Xn, Yn, gen, 30)
    assert calls == [torch.bfloat16] * 30
    lml = np.asarray(metrics['E_lml'])
    assert np.all(np.isfinite(metrics['loss'])) and np.all(np.isfinite(lml))
    assert lml[-5:].mean() > lml[:5].mean()

"""Optimisers (counterpart of ``prob_mbrl_tpu/optim``): rectified Adam and
stochastic damped L-BFGS as pure functions of an explicit state, in the
shape of ``utils.optim.Adam``: ``init(params)`` gives the state and
``step(grads, state, params)`` the new params and the next state, so either
drops into ``utils.train_regressor.make_train_fn``, ``utils.train_model`` or
``models.ensembles.make_ensemble_train_fn``. ``convert`` carries their
states across from the optax transformations and back."""
from .radam import RAdam, RAdamState
from .sdlbfgs import SdLBFGS, SdLBFGSState

__all__ = ['RAdam', 'RAdamState', 'SdLBFGS', 'SdLBFGSState']

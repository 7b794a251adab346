"""Policy-search algorithms: MC-PILCO, the TD(H) value and Q updates, and
model-based DDPG."""
from .mbddpg import MBDDPG, make_ddpg_iteration_fn
from .value import make_q_update_fn, make_value_update_fn

__all__ = ['MBDDPG', 'make_ddpg_iteration_fn', 'make_q_update_fn',
           'make_value_update_fn']

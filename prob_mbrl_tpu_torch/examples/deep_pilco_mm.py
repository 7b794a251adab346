"""MC-PILCO with moment-matched particle propagation (counterpart of the
repo's ``examples/deep_pilco_mm.py``): states and rewards moment-matched,
policy lr 1e-3, initial-state noise 1e-2 * std.

    python -m prob_mbrl_tpu_torch.examples.deep_pilco_mm [flags]
"""
from .deep_pilco_common import main

SETTINGS = dict(mm_states=True, mm_rewards=True, name='mc_pilco_mm',
                init_state_noise_mult=1e-2, arg_overrides=dict(pol_lr=1e-3))

if __name__ == '__main__':
    main(**SETTINGS)

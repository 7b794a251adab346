"""MC-PILCO with sampled-particle propagation, no moment matching
(counterpart of the repo's ``examples/deep_pilco_no_mm.py``): policy lr
1e-4, initial-state noise 1e-1 * std.

    python -m prob_mbrl_tpu_torch.examples.deep_pilco_no_mm [flags]
"""
from .deep_pilco_common import main

SETTINGS = dict(mm_states=False, mm_rewards=False, name='mc_pilco_no_mm',
                init_state_noise_mult=1e-1, arg_overrides=dict(pol_lr=1e-4))

if __name__ == '__main__':
    main(**SETTINGS)

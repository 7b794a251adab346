"""MC-PILCO without moment matching and with a TD(H) fitted-value terminal
bootstrap (counterpart of the repo's
``examples/deep_pilco_no_mm_with_value.py``): a concrete-dropout MSE critic
refit every policy iteration, no target network (``--val_polyak 1``), the
critic's masks those of the PEGASUS epoch; policy lr 1e-4.

    python -m prob_mbrl_tpu_torch.examples.deep_pilco_no_mm_with_value [flags]
"""
from .deep_pilco_common import main

SETTINGS = dict(mm_states=False, mm_rewards=False, use_value=True,
                name='mc_pilco_no_mm_value', init_state_noise_mult=1e-1,
                arg_overrides=dict(pol_lr=1e-4))

if __name__ == '__main__':
    main(**SETTINGS)

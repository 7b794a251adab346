"""The Deep-PILCO drivers: ``python -m prob_mbrl_tpu_torch.examples.<name>``
with the flags of ``utils.experiments.get_argument_parser``."""

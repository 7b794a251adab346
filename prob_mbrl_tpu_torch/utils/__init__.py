"""Rollout engine, experience dataset, controller runner, dynamics fit,
checkpoints and experiment helpers."""

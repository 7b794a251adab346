"""Rollout engine and helpers."""

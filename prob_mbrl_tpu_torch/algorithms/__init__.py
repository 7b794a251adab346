"""Policy-search algorithms."""

"""Dtypes, places and random state."""

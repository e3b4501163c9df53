"""Serialization."""

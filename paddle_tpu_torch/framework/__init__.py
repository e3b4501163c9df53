"""Serialization (io_utils) and global flags (flags)."""

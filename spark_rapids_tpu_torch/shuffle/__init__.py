"""Partitioning and the broadcast exchange."""

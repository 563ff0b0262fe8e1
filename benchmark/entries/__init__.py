"""Timed entries, one a kind of traffic, found by name."""

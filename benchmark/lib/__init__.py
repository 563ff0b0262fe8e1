"""The harness's shared pieces."""

"""Command-line tools that drive the port end to end (counterparts of the
JAX repository's ``tools/`` scripts)."""

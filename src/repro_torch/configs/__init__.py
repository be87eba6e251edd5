"""Declarative deployment configuration (the ``batann-serve`` preset)."""

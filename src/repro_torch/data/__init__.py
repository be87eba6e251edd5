"""Synthetic datasets (numpy, identical to the reference's for one seed)."""

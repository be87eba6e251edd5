"""Fault tolerance and elasticity (host code, copies of ``repro/ft``):
client-side baton recovery (``faults``) and elastic placement and
partition maps (``elastic``)."""

"""Measurement scripts of the port that run on the card: the Hopper
counterparts of the JAX package's ``tools/probe_kernel_anatomy*.py``."""

"""Ops: kernels written by hand for Hopper, each beside its plain version."""

"""Attention kernels, their plain versions and the hook protocol."""

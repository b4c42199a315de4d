"""Sequence attention: the plain blockwise version and the kernel's entry."""

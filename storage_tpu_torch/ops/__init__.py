"""Kernels (and their plain tensor versions) of the LSMC main path."""

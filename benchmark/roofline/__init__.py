"""Peaks of one H100 and the operations and bytes of kernels B and C."""

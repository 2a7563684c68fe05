"""Plain PyTorch reference of the benchmark's forwards.

Imports nothing of the program under test: every quantity the program
derives (layers, paths, interpolated and mixed k, line parameters, the
synthesis) is worked out here again from the benchmark's own inputs.
"""

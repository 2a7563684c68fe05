"""Retrieval: state vector, optimal estimation, output files."""

"""Aligner layer of the port: the batched aligner and the junction polish."""

"""Aligner layer of the port: chaining, extension, records, the batched
aligners and the junction polish."""

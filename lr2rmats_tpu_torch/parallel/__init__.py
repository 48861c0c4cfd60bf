"""Process groups, the (dp, tp) device mesh and the sharded index's
collective arm, on torch.distributed.

No module is imported here: `distributed` is host code that every run
touches, while `mesh` and `shard_index` are imported only by the callers
that need them (the reference's `parallel/__init__.py` imports its JAX
mesh eagerly, which is why `lr2rmats_tpu_torch/_reference.py` exists).
"""

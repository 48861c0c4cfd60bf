"""Process groups, the (dp, tp) device mesh and the sharded index, on
torch.distributed.

No module is imported here: `distributed` is host code that every run
touches, while `mesh` and `shard_index` are imported only by the callers
that need them.
"""

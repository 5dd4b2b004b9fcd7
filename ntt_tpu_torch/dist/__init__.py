"""The distributed six-step NTT (``dist.sixstep``): one transform sharded
over a mesh of shards, on one process or one rank a shard."""

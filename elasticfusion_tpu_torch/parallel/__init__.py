"""Multi-device and multi-process runs: the sharded surfel map
(`sharding`, `shard_step`) and the `torch.distributed` bring-up with the
partitioned fern database (`distributed`)."""

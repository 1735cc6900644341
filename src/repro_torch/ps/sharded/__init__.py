"""The sharded (partitioned) parameter server and its shard plan."""

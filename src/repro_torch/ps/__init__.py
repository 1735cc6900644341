"""Parameter-server runtime: the sharded server and its worker threads."""

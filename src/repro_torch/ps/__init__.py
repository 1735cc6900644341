"""Parameter-server runtime: the monolithic and sharded servers, the
coalescing window and the worker threads."""

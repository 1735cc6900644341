"""Process launch: the spawned transport worker pool (``proc_pool``)."""

"""Launchers: the SPMD trainer and its CLI (``train``), the
train-and-serve CLI (``serve``) and the spawned transport worker pool
(``proc_pool``)."""

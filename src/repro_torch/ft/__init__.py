"""Fault tolerance: so far the retry policies the transports use
(``backoff``); the rest comes with ROADMAP queue 1, item 8."""

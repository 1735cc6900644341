"""Run-wide tracing: the process-local ``TRACE`` recorder."""

"""Algorithm 1 (gates) and Algorithm 2 (controller): pure Python."""

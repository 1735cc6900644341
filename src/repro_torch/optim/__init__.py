"""Gradient compression for the parameter-server wire (``compression``)."""

"""The dense transformer, its config and parameter trees."""

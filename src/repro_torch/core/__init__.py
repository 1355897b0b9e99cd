"""Objective and the in-core MO-ALS driver."""

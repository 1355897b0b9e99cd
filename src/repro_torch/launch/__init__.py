"""Meshes of cells for the multi-device path (``launch.mesh``)."""

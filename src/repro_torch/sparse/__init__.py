"""Host-side sparse layouts and synthetic data (numpy, bit-equal to the
reference's ``repro.sparse``)."""

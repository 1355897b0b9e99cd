"""layout_s: host seconds of the port's layout build (``bin_rows`` for R and
R^T, ``pad_csr_fast`` for the test split; ``block_coo`` for SGD), timed
by the benchmark around those calls in set-up."""


def read(ctx):
    return ctx["spans"].get("layout")

"""Paper §4.2 / Fig. 5: one-phase vs two-phase (topology-aware) parallel
reduction — the analytic link traffic of ``distributed.collective_bytes_
reduce``, timed with NVLink as the fast link and a modelled PCIe Gen 5 x16
link as the slow one."""
from __future__ import annotations

from repro_torch.distributed.collectives import collective_bytes_reduce

from benchmarks_torch.common import NVLINK_BW, PCIE5_X16_BW, emit


def run():
    # Netflix-scale reduction payload (the reference's): a q-batch of
    # Hermitians, 32768 rows x 128 x 128 fp32
    nbytes = 32768 * 128 * 128 * 4
    for p_fast, p_slow in ((16, 2), (16, 4)):
        r = collective_bytes_reduce(nbytes, p_fast, p_slow)
        t_flat = r["flat"]["fast_link"] / NVLINK_BW + \
            r["flat"]["slow_link"] / PCIE5_X16_BW
        t_hier = r["hierarchical"]["fast_link"] / NVLINK_BW + \
            r["hierarchical"]["slow_link"] / PCIE5_X16_BW
        emit(f"fig5_reduction_p{p_fast}x{p_slow}_flat", t_flat * 1e6,
             f"slow_link_bytes={r['flat']['slow_link']:.3g}")
        emit(f"fig5_reduction_p{p_fast}x{p_slow}_two_phase", t_hier * 1e6,
             f"slow_link_bytes={r['hierarchical']['slow_link']:.3g};"
             f"slow_link_saving={r['slow_link_saving']:.1f}x;"
             f"speedup={t_flat / t_hier:.2f}x")


if __name__ == "__main__":
    run()

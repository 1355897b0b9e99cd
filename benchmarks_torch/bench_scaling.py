"""Paper Fig. 9/10: SU-ALS multi-device scaling.

(a) the measured one-device iteration on the card (kernel mode), and (b)
the modelled p-device iteration from the SU-ALS roofline terms at Netflix
scale (per-device operations and reduction bytes both shrink ~1/p — the
paper's Fig. 9 close-to-linear claim; its small overhead is the
reduce-scatter), priced with the H100's published figures and NVLink as
the reduction link.  f is the paper's 100, unpadded: the port's kernels
take f as it is."""
from __future__ import annotations

from repro_torch.backend import resolve_device
from repro_torch.core import als as als_mod
from repro_torch.sparse import synth

from benchmarks_torch.common import HBM_BW, NVLINK_BW, PEAK_FP32_FLOPS, emit, time_fn


def run(device: str = "cuda"):
    dev = resolve_device(device)
    spec = synth.SynthSpec("scaling-mini", m=4096, n=512, nnz=400_000,
                           f=32, lam=0.05)
    r, rt, _, _ = synth.make_synthetic_ratings(spec, seed=1)
    cfg = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=1, device=str(dev))
    state = als_mod.als_init(r.m, rt.m, cfg)
    rr, rtt = als_mod.ell_triplet(r, dev), als_mod.ell_triplet(rt, dev)

    us1 = time_fn(lambda s: als_mod.als_iteration(s, rr, rtt, cfg), state, iters=3)
    emit("fig9_scaling_1dev_measured", us1,
         f"m={r.m};nnz={r.nnz};f={spec.f};mode={cfg.mode}")

    # modelled p-device iteration time at paper scale (Netflix, f=100)
    s = synth.DATASETS["netflix"]
    f = s.f
    flops = 2 * s.nnz * f * f * 2          # both half-iterations, A only
    herm_bytes = 2 * (s.nnz * f * 4 + (s.m + s.n) * f * f * 4)
    t1 = None
    for p in (1, 2, 4, 8, 16):
        comp = flops / p / PEAK_FP32_FLOPS
        mem = herm_bytes / p / HBM_BW
        red = 2 * (s.m + s.n) / p * f * f * 4 * (p - 1) / p / NVLINK_BW
        t = max(comp, mem) + red
        if t1 is None:
            t1 = t * 1.0
        eff = t1 / (t * p)        # parallel efficiency vs 1 device
        emit(f"fig9_scaling_modeled_p{p}", t * 1e6,
             f"eff={eff:.2f};comp_s={comp:.4f};mem_s={mem:.4f};"
             f"reduce_s={red:.4f};f={f}")


if __name__ == "__main__":
    run()

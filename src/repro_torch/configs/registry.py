"""Architecture registry: ``--arch <id>`` resolution, and the dry-run's
stand-ins for a cell's inputs and decode cache (the reference's
``configs/registry.py``): meta tensors of the reference's shapes and
dtypes, or, on a mesh, ``distributed.sharding.Sharded`` leaves of meta
cells laid out as the reference's ``NamedSharding``s (where the reference
has ``ShapeDtypeStruct``s)."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ArchSpec, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.ARCH


def smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.SMOKE


def dp_entry(dp_spec):
    """A batch spec entry as the mesh forward writes it: a tuple of axes,
    or None."""
    if dp_spec is None:
        return None
    return (dp_spec,) if isinstance(dp_spec, str) else tuple(dp_spec)


def _stand_in(shape, dtype, spec, mesh):
    from repro_torch.distributed import sharding as shd

    if mesh is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return shd.zeros(shape, spec, mesh, dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, dp_spec=None):
    """Stand-ins for every model input of an (arch x shape) cell: meta
    tensors, or with ``mesh`` ``Sharded`` leaves of its (meta) cells, the
    batch dim split over ``dp_spec`` (None: replicated).

    train:   {tokens|embeds, labels, mask}
    prefill: {tokens|embeds}
    decode:  {tokens_or_embeds [B], lengths [B]}; the cache comes from
             :func:`cache_specs`.
    """
    B, S = shape.batch, shape.seq
    dp = dp_entry(dp_spec)
    stub = cfg.frontend in ("audio_stub", "vision_stub")

    def mk(shp, dtype):
        return _stand_in(shp, dtype, (dp,) + (None,) * (len(shp) - 1), mesh)

    if shape.kind in ("train", "prefill"):
        batch = ({"embeds": mk((B, S, cfg.d_model), torch.bfloat16)} if stub
                 else {"tokens": mk((B, S), torch.int32)})
        if shape.kind == "train":
            batch["labels"] = mk((B, S), torch.int32)
            batch["mask"] = mk((B, S), torch.float32)
        return batch
    tok = mk((B, cfg.d_model), torch.bfloat16) if stub else mk((B,), torch.int32)
    return {"tokens_or_embeds": tok, "lengths": mk((B,), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, dp_spec=None,
                seq_shard_cache: bool = False, dtype=torch.bfloat16, stacked: bool = False,
                rglru_layout: str = "port"):
    """The decode cache of a cell: ``transformer.init_cache``'s tree of
    meta tensors (``stacked``: a leading layer dim; else one subtree a
    layer, the reference's default), or with ``mesh`` of ``Sharded``
    leaves laid out by ``models.mesh_forward.block_cache_layout`` with the
    batch over ``dp_spec``: k/v over "model" by sequence
    (``seq_shard_cache``) or by kv heads where the padded kv count divides
    it and there is no window; ``pos`` and RWKV6's ``x_prev_*`` by batch
    only; RWKV6's ``s`` by heads where they divide "model" (replicated
    otherwise); RG-LRU's ``conv`` and ``h`` by channel over "model"
    (``rglru_layout="port"``, where the mesh forward makes and reads them)
    or replicated over "model" (``"reference"``, the reference's layout)."""
    from repro_torch.models import mesh_forward as MF
    from repro_torch.models import transformer as T

    if rglru_layout not in ("port", "reference"):
        raise ValueError(f"unknown RG-LRU cache layout {rglru_layout!r}")
    B, S = shape.batch, shape.seq
    if mesh is None:
        return T.init_cache(cfg, B, S, dtype, stacked=stacked, device="meta")
    dp = dp_entry(dp_spec)
    lead = (None,) if stacked else ()
    groups = []
    for pattern, repeat in T.scan_groups(cfg):
        def layer(lead_shape):
            out = {}
            for pi, kind in enumerate(pattern):
                lay = MF.block_cache_layout(cfg, kind, mesh, B, S, dtype, seq_shard_cache)
                leaves = {}
                for nm, (shp, spec, dt) in lay.items():
                    spec = (dp,) + tuple(spec[1:])
                    if rglru_layout == "reference" and nm in ("conv", "h"):
                        spec = (dp,) + (None,) * (len(shp) - 1)
                    leaves[nm] = _stand_in(lead_shape + shp, dt, lead + spec, mesh)
                out[str(pi)] = leaves
            return out
        groups.append(layer((repeat,)) if stacked else [layer(()) for _ in range(repeat)])
    return {"blocks": groups}

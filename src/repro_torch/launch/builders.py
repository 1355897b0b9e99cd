"""Cell builders: (arch x shape x mesh) -> the port's step and its
arguments laid out on the mesh's cells (the reference's
``launch/builders.py``).

Shared by ``launch/dryrun.py`` (layouts, bytes, fits) and
``benchmarks_torch/roofline.py`` (costs).  On a mesh of ``meta`` cells
(``launch.mesh.make_production_mesh``) nothing is allocated: every
argument is a tree of ``distributed.sharding.Sharded`` leaves whose cell
tensors are meta tensors of the reference's per-device shapes.  On a mesh
of CUDA cells the same builders lay the arguments out on the card (as
zeros) and the step runs there.

Each builder returns a :class:`Cell`: the port's callable, its arguments,
what it reads and writes (``io``) and the reference's ``meta`` dict.
Where the reference's ``jit`` kwargs donate buffers, ``io["in_place"]``
names the arguments the step writes in place (the decode cache, the train
state): the port reuses those leaves, so a live set counts them once.
``io["outputs"]`` lays out what the step returns besides them, as
:class:`Layout`\\ s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ArchSpec, ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as lm_mod
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class CellOpts:
    """Implementation knobs a perf iteration can flip per cell."""
    causal_skip: bool = False
    fused_loss: bool = False
    chunk_q: int = 512
    chunk_kv: int = 512
    pod_compress: bool = False
    remat: bool = True
    microbatch: Optional[int] = None     # override ArchSpec.microbatch
    tp1: bool = False   # the "model" axis as more data parallelism: every
                        # weight and the batch over ("data", "model"), no TP


class Layout(NamedTuple):
    """A global tensor's shape, its spec on the cell's mesh and its dtype."""
    shape: tuple
    spec: tuple
    dtype: torch.dtype


class Cell(NamedTuple):
    """A built cell: ``fn(*args)`` runs the step; ``io`` = {"in_place":
    argument positions the step writes in place, "outputs": [Layout, ...]
    of what else it returns, "arg_specs": per-argument specs of plain
    tensors (the ALS cell's global arrays), "mesh": the mesh the step runs
    on (a ``tp1`` cell's view)}; ``meta`` the reference's dict.  A skipped
    cell has ``fn`` and ``args`` None and ``meta == {"skip": reason}``."""
    fn: Optional[Callable]
    args: Optional[tuple]
    io: Optional[dict]
    meta: dict


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in shd.dp_axes(mesh))


def _dp_spec(mesh: Mesh, batch: int, tp1: bool = False):
    """The batch's spec entry: the data axes (and "model" under ``tp1``)
    where they divide ``batch``, else None (replicated: ``long_500k``'s
    batch of 1)."""
    axes = shd.dp_axes(mesh)
    if tp1 and "model" in mesh.axis_names:
        axes = axes + ("model",)
    n = math.prod(mesh.shape[a] for a in axes)
    if batch % n != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def tp1_view(mesh: Mesh) -> Mesh:
    """``mesh`` with its "model" axis folded into "data": data' = data x
    model, model' = 1, the same cells in the same order.  The train policy
    on this view is the reference's ``train_tp1`` layout (every weight
    1D-split over the merged axis, the batch over it, no TP collective):
    the port's FSDP path on the view is that layout, and the mesh forward
    needs no code of its own for it."""
    shape = dict(mesh.shape)
    shape["data"], shape["model"] = shape["data"] * shape["model"], 1
    dims = tuple(shape[a] for a in mesh.axis_names)
    return Mesh(axis_names=mesh.axis_names, shape=shape, devices=mesh.devices.reshape(dims))


def param_structs(cfg: ModelConfig, policy: shd.ShardingPolicy, mesh: Mesh,
                  dtype=torch.float32):
    """The parameter tree as ``Sharded`` zeros laid out by ``policy`` (on
    meta cells: shapes only)."""
    specs = shd.tree_specs(T.logical_axes_tree(cfg), policy)

    def build(shapes, sp):
        if isinstance(shapes, dict):
            return {k: build(shapes[k], sp[k]) for k in shapes}
        if isinstance(shapes, list):
            return [build(a, b) for a, b in zip(shapes, sp)]
        return shd.zeros(shapes[0], sp, mesh, dtype)
    return build(T.param_shapes(cfg), specs)


def _train_policy(spec: ArchSpec, mesh: Mesh, tp1: bool = False) -> shd.ShardingPolicy:
    """``sharding.train_policy_for`` on ``mesh`` (on :func:`tp1_view` of
    it with ``tp1``); an arch without FSDP keeps its d_model dims whole."""
    pol = shd.train_policy_for(spec.model, tp1_view(mesh) if tp1 else mesh)
    if not spec.fsdp:
        pol = pol.with_overrides(**{a: None for a in shd.D_MODEL_AXES})
    return pol


def _serve_policy(spec: ArchSpec, mesh: Mesh) -> shd.ShardingPolicy:
    return shd.serve_policy_for(spec.model, mesh, mlp_2d=spec.serve_mlp_2d,
                                seq_shard_cache=spec.serve_seq_shard)


def train_state_structs(spec: ArchSpec, mesh: Mesh, tp1: bool = False) -> lm_mod.TrainState:
    """A train state laid out as the reference's ``train_state_structs``:
    float32 parameters by the train policy, AdamW's ``m``/``v`` beside
    them, or Adafactor's ``vr`` (every spec entry but the last) and ``vc``
    (every entry but the second-to-last; a rank-1 leaf's ``[1]``
    replicated), the step counters on the mesh's first cell.  ``tp1``: on
    :func:`tp1_view` of ``mesh``."""
    view = tp1_view(mesh) if tp1 else mesh
    params = param_structs(spec.model, _train_policy(spec, mesh, tp1), view, torch.float32)
    init, _ = opt_mod.make_optimizer(opt_mod.OptConfig(name=spec.opt))
    return lm_mod.TrainState(params=params, opt=init(params),
                             step=torch.zeros((), dtype=torch.int32, device=view.home))


def _scalar() -> Layout:
    return Layout((), (), torch.float32)


def _layouts(tree) -> list[Layout]:
    return [Layout(t.shape, t.spec, t.dtype) for t in T.tree_leaves(tree)]


def build_train_cell(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
                     opts: CellOpts = CellOpts()) -> Cell:
    """``models.lm.make_train_step`` on ``mesh``: args (state, batch); the
    state written in place, the loss and gradient norm returned."""
    cfg = spec.model
    view = tp1_view(mesh) if opts.tp1 else mesh
    mb = opts.microbatch or spec.microbatch
    mb = max(1, min(mb, shape.batch // dp_size(view)))
    step = lm_mod.make_train_step(
        cfg, opt_mod.OptConfig(name=spec.opt), mesh=view, microbatch=mb,
        remat=opts.remat and spec.remat, fused_loss=opts.fused_loss,
        causal_skip=opts.causal_skip, chunk_q=opts.chunk_q, chunk_kv=opts.chunk_kv,
        pod_compress=opts.pod_compress)
    state = train_state_structs(spec, mesh, tp1=opts.tp1)
    batch = registry.input_specs(cfg, shape, mesh=view,
                                 dp_spec=_dp_spec(view, shape.batch))

    def train(st, b):
        return step(st, shd.unshard_tree(b))

    io = {"in_place": (0,), "outputs": [_scalar(), _scalar()], "mesh": view}
    return Cell(train, (state, batch), io, {"microbatch": mb, "opt": spec.opt, "tp1": opts.tp1})


def build_prefill_cell(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
                       opts: CellOpts = CellOpts()) -> Cell:
    """``models.lm.make_prefill_step`` on ``mesh``: args (params, batch);
    returns the next tokens and the stacked cache in the decode layout
    (``registry.cache_specs``, the reference's ``out_shardings``)."""
    cfg = spec.model
    prefill = lm_mod.make_prefill_step(
        cfg, mesh=mesh, serve_seq_shard=spec.serve_seq_shard, chunk_q=opts.chunk_q,
        chunk_kv=opts.chunk_kv, causal_skip=opts.causal_skip)
    params = param_structs(cfg, _serve_policy(spec, mesh), mesh, torch.bfloat16)
    dp = _dp_spec(mesh, shape.batch)
    batch = registry.input_specs(cfg, shape, mesh=mesh, dp_spec=dp)
    cache = registry.cache_specs(cfg, shape, mesh=mesh, dp_spec=dp,
                                 seq_shard_cache=spec.serve_seq_shard, stacked=True)

    def run(p, b):
        return prefill(p, shd.unshard_tree(b))

    tok = Layout((shape.batch,), (registry.dp_entry(dp),), torch.int32)
    io = {"in_place": (), "outputs": [tok] + _layouts(cache), "mesh": mesh}
    return Cell(run, (params, batch), io, {})


def build_decode_cell(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh,
                      opts: CellOpts = CellOpts()) -> Cell:
    """``models.lm.make_decode_step`` on ``mesh``: args (params, cache,
    tokens, lengths); the cache written in place, the next tokens and the
    lengths + 1 returned."""
    cfg = spec.model
    decode = lm_mod.make_decode_step(cfg, mesh=mesh, serve_seq_shard=spec.serve_seq_shard)
    params = param_structs(cfg, _serve_policy(spec, mesh), mesh, torch.bfloat16)
    dp = _dp_spec(mesh, shape.batch)
    inp = registry.input_specs(cfg, shape, mesh=mesh, dp_spec=dp)
    cache = registry.cache_specs(cfg, shape, mesh=mesh, dp_spec=dp,
                                 seq_shard_cache=spec.serve_seq_shard, stacked=True)

    def run(p, c, t, ln):
        return decode(p, c, t.unshard(), ln.unshard())

    vec = Layout((shape.batch,), (registry.dp_entry(dp),), torch.int32)
    io = {"in_place": (1,), "outputs": [vec, vec], "mesh": mesh}
    return Cell(run, (params, cache, inp["tokens_or_embeds"], inp["lengths"]), io, {})


def build_cell(arch_id: str, shape_name: str, mesh: Mesh, opts: CellOpts = CellOpts(),
               *, spec: Optional[ArchSpec] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """Dispatch on the shape kind.  ``spec`` / ``shape`` stand in for the
    registry's (a cut depth, a smoke config, a cut batch)."""
    spec = spec or registry.get_arch(arch_id)
    shape = shape or SHAPES[shape_name]
    skip = spec.skip_reason(shape)
    if skip:
        return Cell(None, None, None, {"skip": skip})
    if shape.kind == "train":
        return build_train_cell(spec, shape, mesh, opts)
    if shape.kind == "prefill":
        return build_prefill_cell(spec, shape, mesh, opts)
    return build_decode_cell(spec, shape, mesh, opts)


# ---------------------------------------------------------------------------
# ALS cells (the paper's own workload)
# ---------------------------------------------------------------------------

def als_col_axes(mesh: Mesh) -> tuple[str, ...]:
    """cuMF's p axes, fast -> slow."""
    return tuple(a for a in ("model", "pod") if a in mesh.axis_names)


def build_als_cell(shape_name: str, mesh: Mesh, *, scheme: str = "two_phase",
                   row_block: int = 2048, f_pad: Optional[int] = None,
                   m_wave: Optional[int] = None) -> Cell:
    """One SU-ALS update-X wave at a Table-5 data set's scale
    (``distributed.su_als.make_su_als_fns``): args theta [n_pad, f], idx /
    val [m_wave, p K_loc], cnt [m_wave, p] (global arrays, each cell's
    block per ``io["arg_specs"]``, the reference's shardings); returns X
    [m_wave, f].  On meta cells the plain versions run (``mode="ref"``: no
    kernel runs without storage), on CUDA cells the kernels.  f stays the
    data set's (the reference pads it to 128 for its MXU).  ``m_wave``
    overrides the wave's rows (one data shard of a production wave on a
    mesh with the data axis cut)."""
    from repro_torch.configs.cumf_als import ALS_SHAPES
    from repro_torch.distributed import su_als

    als = ALS_SHAPES[shape_name]
    spec = als.spec
    col_axes = als_col_axes(mesh)
    p_total = math.prod(mesh.shape[a] for a in col_axes)
    q = mesh.shape["data"]
    f = f_pad or spec.f
    if m_wave is None:
        granule = q * p_total * row_block
        m_wave = max(granule, (als.rows_per_wave // granule) * granule)
    n_pad = -(-spec.n // p_total) * p_total
    k_loc = als.k_pad
    mode = "ref" if mesh.home.type == "meta" else None
    update_x, _, _ = su_als.make_su_als_fns(mesh, spec.lam, scheme=scheme, mode=mode,
                                            row_block=row_block)
    col = col_axes[::-1] if len(col_axes) > 1 else col_axes[0]
    dev = mesh.home
    args = (torch.zeros((n_pad, f), dtype=torch.float32, device=dev),
            torch.zeros((m_wave, p_total * k_loc), dtype=torch.int32, device=dev),
            torch.zeros((m_wave, p_total * k_loc), dtype=torch.float32, device=dev),
            torch.zeros((m_wave, p_total), dtype=torch.int32, device=dev))
    io = {"in_place": (), "mesh": mesh,
          "arg_specs": [(col, None), ("data", col), ("data", col), ("data", col)],
          "outputs": [Layout((m_wave, f), ("data", None), torch.float32)]}
    meta = {"m_wave": m_wave, "k_loc": k_loc, "p": p_total, "q": q, "f": f,
            "scheme": scheme, "row_block": row_block,
            "waves_total": max(1, -(-spec.m // m_wave))}
    return Cell(update_x, args, io, meta)


# ---------------------------------------------------------------------------
# per-cell bytes
# ---------------------------------------------------------------------------

def _block_bytes(shape, spec, dtype, mesh) -> int:
    local = [n // shd.n_blocks(e, mesh) for e, n in zip(spec, shape)]
    return math.prod(local) * torch.empty((), dtype=dtype).element_size()


def leaf_layouts(cell: Cell) -> list[tuple[int, Layout]]:
    """Every argument leaf of ``cell`` as (argument position, Layout):
    ``Sharded`` leaves by their own specs, plain tensors by
    ``io["arg_specs"]`` (replicated where none is given: the step
    counters)."""
    out = []
    specs = cell.io.get("arg_specs")
    for i, a in enumerate(cell.args):
        for leaf in T.tree_leaves(a):
            if isinstance(leaf, shd.Sharded):
                out.append((i, Layout(tuple(leaf.shape), tuple(leaf.spec), leaf.dtype)))
            else:
                spec = specs[i] if specs is not None else (None,) * leaf.dim()
                out.append((i, Layout(tuple(leaf.shape), tuple(spec), leaf.dtype)))
    return out


def cell_bytes(layouts, mesh: Mesh) -> int:
    """The bytes one cell holds of ``layouts`` (each its block; one card a
    cell)."""
    return sum(_block_bytes(lay.shape, lay.spec, lay.dtype, mesh) for lay in layouts)


def global_bytes(layouts) -> int:
    """The bytes of ``layouts``' global tensors: what one device holds of
    them when every cell of the mesh shares it (the blocks once each)."""
    return sum(math.prod(lay.shape) * torch.empty((), dtype=lay.dtype).element_size()
               for lay in layouts)


def io_bytes(cell: Cell, mesh: Optional[Mesh] = None) -> dict:
    """{"argument", "output", "alias"} bytes of ``cell``, per cell
    (``"cell"``) and on one device that holds every cell (``"device"``).
    ``output`` counts the in-place arguments too, as the reference's
    ``output_size_in_bytes`` counts its donated outputs; ``alias`` is
    their bytes."""
    mesh = mesh or cell.io["mesh"]
    leaves = leaf_layouts(cell)
    inplace = [lay for i, lay in leaves if i in cell.io["in_place"]]
    args = [lay for _, lay in leaves]
    outs = list(cell.io["outputs"])
    res = {}
    for key, count in (("cell", lambda ls: cell_bytes(ls, mesh)), ("device", global_bytes)):
        alias = count(inplace)
        res[key] = {"argument": count(args), "output": count(outs) + alias, "alias": alias}
    return res

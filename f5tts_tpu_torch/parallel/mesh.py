"""Process mesh and parameter sharding (counterpart of
f5tts_tpu/parallel/mesh.py, its names kept).

One global mesh with two axes over `torch.distributed` processes, rank r at
(r // model, r % model) as the JAX package's `devices.reshape(data, model)`:
- "data": data parallelism. Each rank computes its rows of the global batch
  (`batch_sharding`); gradients are all-reduced over the data group once an
  update, or reduce-scattered under ZeRO-1.
- "model": tensor parallelism of the backbones, the head split the
  reference implements with TRT-LLM ColumnLinear / RowLinear: q / k / v and
  FF-in column-parallel (this rank's heads and FF columns), attn-out and
  FF-out row-parallel (this rank's input rows, the partial products summed
  by `collectives.reduce_from_tp`, the bias added once after).

`dit_param_specs` gives each leaf a `Spec`: the axis sharded over "model",
or none. The JAX package stacks blocks on a depth axis, the port keeps them
in a list, so a port spec is the JAX spec without that axis; `w_i8` lies
[n, k] here ([k, n] in JAX), so its axis is the other one. Known
difference: JAX shards the flat [q|k|v] concat of a fused `to_qkv` across
the block boundaries and lets GSPMD reshard; `shard_params` gives rank r the
same head group of q, of k and of v (an already-fused tree is split into
thirds first), so the attention kernels run on whole local heads. Under the
outlier hedge a column leaf's `w_out` follows its output axis (JAX keeps it
replicated and lets GSPMD slice it).

ZeRO-1 (Rajbhandari et al., 2019): the AdamW moments and the EMA are
sharded over "data". JAX gives each leaf a "data" axis on its largest free
dimension; the port uses a flat even split, since the update is
elementwise: the TP-local parameters are laid end to end in one f32 buffer
(TP-sharded leaves first, zero padding to a multiple of the data size), the
leaves become views into it, and rank r keeps elements [r S, (r + 1) S) of
mu, nu and the EMA (`FlatLayout`). An update reduce-scatters the flat
gradient, runs AdamW + EMA on the shard and all-gathers the buffer
(`ShardInfo`). A rank's state is then (1 + 3 / data) x the parameters' f32
bytes (f32 moments and EMA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from f5tts_tpu_torch.models import modules as m
from f5tts_tpu_torch.parallel import collectives as c


@dataclasses.dataclass
class Mesh:
    """The (data, model) mesh as this rank sees it. Without groups (a mesh
    made by hand, not by `make_mesh`) it describes the layout only:
    `shard_params` can slice with it, nothing can communicate."""

    data: int
    model: int
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def tp(self) -> Optional[c.TP]:
        """The tensor-parallel group the backbones take, None at model 1."""
        return c.TP(self.model_group, self.model, self.model_rank) if self.model > 1 else None


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The data x model mesh over the initialised default process group:
    every rank creates every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group, or torchrun and train_cli)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"mesh {data} x {model} != {world} processes")
    mesh = Mesh(data, model, rank)
    for i in range(data):
        g = dist.new_group([i * model + j for j in range(model)])
        if mesh.data_rank == i:
            mesh.model_group = g
    for j in range(model):
        g = dist.new_group([i * model + j for i in range(data)])
        if mesh.model_rank == j:
            mesh.data_group = g
    return mesh


# ---------------------------------------------------------------------------
# tensor-parallel specs
# ---------------------------------------------------------------------------

# column-parallel projections: output channels over "model" (the reference's
# ColumnLinear set, extended to the fused to_qkv and the MMDiT's context
# stream), as the JAX package's _COL
_COL = {
    ("attn", "to_q"), ("attn", "to_k"), ("attn", "to_v"), ("attn", "to_qkv"),
    ("attn", "to_q_c"), ("attn", "to_k_c"), ("attn", "to_v_c"),
    ("attn", "to_qkv_c"),
    ("ff", "in"), ("ff_x", "in"), ("ff_c", "in"),
}
# row-parallel projections: the contraction axis over "model" (_ROW)
_ROW = {
    ("attn", "to_out"), ("attn", "to_out_c"),
    ("ff", "out"), ("ff_x", "out"), ("ff_c", "out"),
}
_FUSED = {("attn", "to_qkv"), ("attn", "to_qkv_c")}


@dataclasses.dataclass(frozen=True)
class Spec:
    """A leaf's layout over "model": `axes` one entry a dimension ("model"
    where sharded, else None); `fused` for a [q|k|v] concat, sharded a
    third at a time."""

    axes: tuple
    fused: bool = False

    @property
    def axis(self) -> Optional[int]:
        return self.axes.index("model") if "model" in self.axes else None


def _map_named(tree, fn, names=()):
    """tree_map with each leaf's dict-key path (list indices skipped)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, names) for v in tree)
    return fn(names, tree)


def _spec_for_path(names: tuple, t: torch.Tensor) -> Spec:
    axes = [None] * t.dim()
    if len(names) < 3:
        return Spec(tuple(axes))
    mod, leaf = tuple(names[-3:-1]), names[-1]
    if mod in _COL:
        if leaf in ("w", "b", "w_scale", "w_out"):
            axes[-1] = "model"
        elif leaf == "w_i8":  # [n, k]: the output axis first
            axes[0] = "model"
    elif mod in _ROW:
        if leaf == "w" and t.dim() >= 2:
            axes[-2] = "model"
        elif leaf == "w_i8":  # [n, k]: the input axis last
            axes[-1] = "model"
    # a row-parallel b and w_scale stay whole: they act on the output
    # channels after the reduce
    return Spec(tuple(axes), fused=mod in _FUSED and "model" in axes)


def dit_param_specs(params) -> dict:
    """A `Spec` tree matching any backbone's params (plain {w, b} and int8
    {w_i8, w_scale, b} leaves; TP on "model")."""
    return _map_named(params, _spec_for_path)


def _slice(t: torch.Tensor, spec: Spec, size: int, rank: int) -> torch.Tensor:
    axis = spec.axis
    if axis is None or size == 1:
        return t
    parts = t.chunk(3, axis) if spec.fused else (t,)
    for p in parts:
        if p.shape[axis] % size:
            raise ValueError(f"a leaf of shape {tuple(t.shape)} does not split over a model "
                             f"axis of {size}")
    out = [p.chunk(size, axis)[rank] for p in parts]
    return torch.cat(out, axis) if len(out) > 1 else out[0].clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's slice of every leaf of `tree` along its spec's axis."""
    return m.tree_unflatten(tree, [_slice(t, s, mesh.model, mesh.model_rank) for t, s in zip(
        m.tree_leaves(tree), _spec_leaves(specs))])


def shard_params(params, mesh: Mesh, specs=None):
    """This rank's tensor-parallel slice of `params` (`dit_param_specs`)."""
    return shard_tree(params, dit_param_specs(params) if specs is None else specs, mesh)


def _gather_leaf(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    axis = spec.axis
    if axis is None or mesh.model == 1:
        return t
    parts = t.chunk(3, axis) if spec.fused else (t,)
    return torch.cat([c.all_gather_cat(p, axis, mesh.model_group, mesh.model) for p in parts],
                     axis)


def gather_tree(tree, specs, mesh: Mesh):
    """The whole leaves from every model rank's slice (a collective over the
    model group; `shard_tree`'s inverse)."""
    return m.tree_unflatten(tree, [_gather_leaf(t, s, mesh) for t, s in zip(
        m.tree_leaves(tree), _spec_leaves(specs))])


def _spec_leaves(specs) -> list:
    out = []
    _map_named(specs, lambda _, s: out.append(s))
    return out


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a global batch of `n_rows` (its data index's
    contiguous block; every model rank of it takes the same rows)."""
    if n_rows % mesh.data:
        raise ValueError(f"{n_rows} rows do not split over a data axis of {mesh.data}")
    per = n_rows // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlatLayout:
    """Leaves laid end to end in one 1-D buffer: `order` the tree indices
    of the TP-sharded leaves then the replicated ones, zero padding to
    `total` (a multiple of `data`); rank `data_rank` owns [start, start +
    shard)."""

    order: list
    shapes: list     # tree order
    offsets: list    # tree order: a leaf's first element in the buffer
    n_sharded: int   # elements of TP-sharded leaves (the buffer's head)
    total: int
    data: int
    data_rank: int

    @property
    def shard(self) -> int:
        return self.total // self.data

    @property
    def start(self) -> int:
        return self.data_rank * self.shard

    def flatten(self, leaves: list, dtype=None) -> torch.Tensor:
        """The buffer of `leaves` (tree order), zero padded."""
        dtype = dtype or leaves[0].dtype
        flat = torch.zeros(self.total, dtype=dtype, device=leaves[0].device)
        for i in self.order:
            n = math.prod(self.shapes[i])
            flat[self.offsets[i]:self.offsets[i] + n].copy_(leaves[i].reshape(-1))
        return flat

    def views(self, flat: torch.Tensor) -> list:
        """Views of `flat` shaped as the leaves, tree order."""
        return [flat[o:o + math.prod(s)].view(s) for o, s in zip(self.offsets, self.shapes)]


def _tp_sharded(specs, mesh: Mesh) -> list:
    """Per leaf: whether its spec splits it over a model axis above 1."""
    return [mesh.model > 1 and s.axis is not None for s in _spec_leaves(specs)]


def zero1_param_specs(params, mesh: Mesh, param_specs=None) -> FlatLayout:
    """The ZeRO-1 layout of the moment / EMA mirror of `params` (the whole
    tree): this rank's TP slices end to end, split evenly over "data"
    (module docstring)."""
    specs = dit_param_specs(params) if param_specs is None else param_specs
    sharded = _tp_sharded(specs, mesh)
    shapes = []
    for t, spec, cut in zip(m.tree_leaves(params), _spec_leaves(specs), sharded):
        shape = list(t.shape)
        if cut:
            shape[spec.axis] //= mesh.model
        shapes.append(tuple(shape))
    order = [i for i, cut in enumerate(sharded) if cut] + [
        i for i, cut in enumerate(sharded) if not cut]
    offsets = [0] * len(shapes)
    pos = n_sharded = 0
    for i in order:
        offsets[i] = pos
        pos += math.prod(shapes[i])
        if sharded[i]:
            n_sharded = pos
    total = -(-pos // mesh.data) * mesh.data
    return FlatLayout(order, shapes, offsets, n_sharded, total, mesh.data, mesh.data_rank)


# a reduced-dtype shard is updated in f32 copies of this many elements
_CHUNK = 1 << 25


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) of a 1-D f32 tensor as one BLAS dot (`vector_norm` over
    millions of elements drifts by ~1e-5 relative on the CPU)."""
    return torch.dot(x, x)


@dataclasses.dataclass
class ShardInfo:
    """How a train state lies over the mesh: the params' `specs`, which
    leaves are TP-sharded, the flat `layout`, and under ZeRO-1 the f32
    parameter buffer `flat` whose views are the param leaves."""

    mesh: Mesh
    specs: object
    sharded: list
    layout: FlatLayout
    zero1: bool = False
    flat: Optional[torch.Tensor] = None

    def reduce(self, grads, params, mu, nu, ema):
        """(p, g, mu, nu, ema, gnorm) for the update: the data-reduced f32
        gradient (all-reduced, or this rank's reduce-scattered shard under
        ZeRO-1) beside the tensors it updates, as lists; the global gradient
        norm (TP-sharded leaves summed over the model group, replicated ones
        once). `ema` may be None."""
        mesh, lay = self.mesh, self.layout
        flat_g = lay.flatten(m.tree_leaves(grads), torch.float32)
        split = lay.n_sharded
        if self.zero1:
            g_all = c.reduce_scatter_flat(flat_g, lay.shard, mesh.data_group)
            del flat_g
            split = min(max(lay.n_sharded - lay.start, 0), lay.shard)
        else:
            g_all = c.all_reduce_flat(flat_g, mesh.data_group)
        sq = torch.stack([_sq_norm(g_all[:split]), _sq_norm(g_all[split:])])
        if self.zero1:
            sq = c.all_reduce_sum(sq, mesh.data_group)
        if mesh.model > 1:
            sq = torch.stack([c.all_reduce_sum(sq[0], mesh.model_group), sq[1]])
        gnorm = torch.sqrt(sq.sum())
        if not self.zero1:
            views = lay.views(g_all)
            return (m.tree_leaves(params), views, m.tree_leaves(mu), m.tree_leaves(nu),
                    None if ema is None else m.tree_leaves(ema), gnorm)
        p = self.flat[lay.start:lay.start + lay.shard]
        chunks = [list(t.split(_CHUNK)) for t in (p, g_all, mu, nu)]
        return (*chunks, None if ema is None else list(ema.split(_CHUNK)), gnorm)

    def finish(self) -> None:
        """Under ZeRO-1, all-gather the updated parameter shards into every
        rank's buffer (the param leaves are its views)."""
        if self.zero1:
            lay = self.layout
            shard = self.flat[lay.start:lay.start + lay.shard].clone()
            c.all_gather_flat(self.flat, shard, self.mesh.data_group)

    def full_flat(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's ZeRO-1 shard gathered into one buffer."""
        flat = torch.empty(self.layout.total, dtype=shard.dtype, device=shard.device)
        return c.all_gather_flat(flat, shard, self.mesh.data_group)

    def full_tree(self, tree_or_shard, like):
        """The whole tree (every rank's ZeRO-1 shard and TP slice gathered;
        collectives over both groups) of a params-shaped tree, or of a ZeRO-1
        shard laid out as `like`."""
        if self.zero1 and isinstance(tree_or_shard, torch.Tensor):
            views = self.layout.views(self.full_flat(tree_or_shard))
            tree = m.tree_unflatten(like, [v.clone() for v in views])
        elif self.zero1:  # the params: views of `flat`
            tree = m.tree_map(lambda t: t.clone(), tree_or_shard)
        else:
            tree = tree_or_shard
        return gather_tree(tree, self.specs, self.mesh) if self.mesh.model > 1 else tree


def _shardings(params, specs, mesh: Mesh, zero1: bool) -> ShardInfo:
    return ShardInfo(mesh, specs, _tp_sharded(specs, mesh),
                     zero1_param_specs(params, mesh, specs), zero1)


def train_state_shardings(state, mesh: Mesh, zero1: bool = True) -> ShardInfo:
    """How `shard_train_state` lays out `state` (params TP-sharded, the
    moments and EMA also ZeRO-1-sharded over "data" with `zero1`); state's
    params are the whole (unsharded) tree."""
    return _shardings(state.params, dit_param_specs(state.params), mesh, zero1)


def shard_state_trees(params, mu, nu, ema, specs, mesh: Mesh, zero1: bool):
    """(params, mu, nu, ema, ShardInfo) of whole trees: this rank's TP
    slices of the four (`ema` may be None), under ZeRO-1 the params as views
    into one f32 buffer and mu / nu / ema as this rank's 1-D flat shards."""
    info = _shardings(params, specs, mesh, zero1)
    lay = info.layout
    if mesh.model > 1:
        params, mu, nu, ema = (None if t is None else shard_tree(t, specs, mesh)
                               for t in (params, mu, nu, ema))
    if zero1:
        info.flat = lay.flatten(m.tree_leaves(params), torch.float32)
        params = m.tree_unflatten(params, lay.views(info.flat))
        mu, nu, ema = (None if t is None else
                       lay.flatten(m.tree_leaves(t))[lay.start:lay.start + lay.shard].clone()
                       for t in (mu, nu, ema))
    return params, mu, nu, ema, info


def shard_train_state(state, mesh: Mesh, zero1: bool = True):
    """A `train.step.TrainState` over the mesh: params this rank's TP slice
    (under ZeRO-1 views into one f32 buffer), mu / nu / EMA the same slice,
    and under ZeRO-1 only this rank's flat shard of each (1-D)."""
    from f5tts_tpu_torch.train.step import TrainState

    info = train_state_shardings(state, mesh, zero1)
    params, mu, nu, ema, info = shard_state_trees(state.params, state.mu, state.nu, state.ema,
                                                  info.specs, mesh, zero1)
    return TrainState(params=params, mu=mu, nu=nu, count=state.count, ema=ema, step=state.step,
                      shard=info)


def gather_train_state(state):
    """The whole `TrainState` of a sharded one, on every rank (collectives
    over both groups): what the single-device trainer holds and saves."""
    from f5tts_tpu_torch.train.step import TrainState

    info = state.shard
    if info is None:
        return state
    full = [info.full_tree(getattr(state, k), state.params) for k in ("params", "mu", "nu", "ema")]
    return TrainState(params=full[0], mu=full[1], nu=full[2], count=state.count, ema=full[3],
                      step=state.step)


def gather_ema(state) -> dict:
    """The whole EMA tree of a (possibly sharded) state."""
    if state.shard is None:
        return state.ema
    return state.shard.full_tree(state.ema, state.params)

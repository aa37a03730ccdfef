"""The (data, model) mesh (port of ``jodalrob_twotower_tpu/parallel/mesh.py``).

The reference's mesh is one controller driving N devices under GSPMD: the
batch dim shards over the ``data`` axis and XLA inserts the collectives. The
port's mesh is a ``torch.distributed`` process group with one process per
device, PyTorch's idiom and the way the reference itself runs multi-host
(``parallel/distributed.py``). Rank r holds the contiguous block
``[r B/n, (r+1) B/n)`` of every global batch, the block the reference's
``batch_sharding`` (``P("data")``) gives device r, and the code calls the
collectives itself: an all-reduce SUM of the replicated gradients, an
all-gather of the company side for the global in-batch negatives, a
reduce-scatter of its gradient, the BatchNorm sums, and for row-sharded
tables and stores (the reference's ``P("data", None)``: rank r holds rows
``[r R/n, (r+1) R/n)``) the row exchange of ``sharded_embedding.py`` and
``sharded_store.py``.

A :class:`Mesh` is one rank's view: its group, rank, world size, device and
collectives. The reference's mesh is a (data, model) grid of the devices,
reshaped row-major (``make_mesh``): rank r of the group sits at data index
r // model and model index r % model. Nothing is placed on the model axis
(the towers are too small for tensor parallelism), so the ranks of one data
index hold the same batch block and the same state: a :class:`Mesh` keeps
two groups, the data group (the ranks of its model index, one per data
index: every collective of the steps) and the world group (every rank:
``put_replicated``'s broadcast and ``barrier``).

Both backends take the same tensor collectives: NCCL on the card, and gloo
(the CPU tests, the CLIs' ``--force-cpu`` and two ranks sharing one card,
which NCCL refuses as a duplicate GPU) carries
all-reduce, broadcast, ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` for CUDA tensors too, staged through the host
(torch 2.11 on the H100 machine). The row exchange moves int32 and int64
ids, float32 rows and bfloat16 store rows; gloo sums all four exactly
(x + 0 = x) on the CPU. Their names are taken once, at import:
torch 2.13 renames the last two ``*_single`` and deprecates the old names,
which 2.11 has alone. No collective is chosen by catching an exception.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from jodalrob_twotower_torch.config import MeshConfig
from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class Mesh:
    """One rank of a (data, model) mesh. ``group`` is the data group (None:
    the default group), over which every collective of the steps runs;
    ``rank`` and ``size`` are the rank's data index and the data axis, so a
    rank's block of a batch or of a table's rows is its data index's.
    ``world_group`` holds every rank of the mesh, the ``model_size`` ranks
    of each data index among them (None: the default group; without a
    model axis it is ``group``): the broadcast that makes a replicated
    value rank 0's everywhere and the barrier run over it, and ``is_main``
    is its rank 0. A group of one rank still runs its
    collectives (NCCL's launch on the card and leave the values as they
    are); with no process group at all the mesh has one rank and its
    collectives leave their tensors as they are. ``shape`` maps the
    reference's axis names to their sizes, so ``mesh.shape[DATA_AXIS]``
    reads as there."""

    def __init__(self, device: str | torch.device, group=None, *, world_group=None, model_index: int = 0,
                 model_size: int = 1) -> None:
        self.device = torch.device(device)
        self.group = group
        self.world_group = world_group if model_size > 1 else group
        self.model_index, self.model_size = model_index, model_size
        self.live = dist.is_initialized()  # a process group carries the collectives
        if self.live:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
            self.world_rank = dist.get_rank(self.world_group)
        else:
            self.rank, self.size, self.backend, self.world_rank = 0, 1, "none", 0
        self.shape = {DATA_AXIS: self.size, MODEL_AXIS: model_size}

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, model_index={self.model_index}, "
                f"model_size={self.model_size}, device={self.device}, backend={self.backend})")

    @property
    def is_main(self) -> bool:
        """Whether this rank writes the run's files and logs: rank 0 of the
        world group (under a model axis, data index 0 holds ``model_size``
        ranks, and only the first of them writes)."""
        return self.world_rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows (``n`` a multiple of
        the mesh size)."""
        if n % self.size:
            raise ValueError(f"{n} rows must divide the data axis ({self.size}) to shard the batch dim")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    # -- collectives (in place where the name ends in "_") ------------------------

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max) ``t`` over the ranks, in place; returns ``t``."""
        if self.live:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """World rank ``src``'s ``t`` on every rank of the mesh, both axes, in
        place; returns ``t``."""
        if self.live:
            g = self.world_group
            dist.broadcast(t, dist.get_global_rank(g, src) if g is not None else src, group=g)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[rows, ...] on every rank -> [size * rows, ...], rank r's rows at block r."""
        if not self.live:
            return t
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        _ALL_GATHER(out, t.contiguous(), group=self.group)
        return out

    def reduce_scatter_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[size * rows, ...] partials -> this rank's block of their sum, [rows, ...]."""
        if not self.live:
            return t
        out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
        _REDUCE_SCATTER(out, t.contiguous(), group=self.group)
        return out

    def barrier(self) -> None:
        """Every rank of the mesh, both axes, waits for the others."""
        if self.live:
            if self.backend == "nccl":
                dist.barrier(group=self.world_group, device_ids=[self.device.index or 0])
            else:
                dist.barrier(group=self.world_group)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank; the gradient of each rank's x
    is the sum over ranks of y's gradients (every rank's loss term depends
    on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-reduce SUM (the mesh BatchNorm's statistics)."""
    return _AllReduceSum.apply(x, mesh) if mesh.size > 1 else x


class _GatherReplicated(torch.autograd.Function):
    """The global batch from every rank's block, for a loss that every rank
    then computes whole and alike: each rank's cotangent of the gathered
    rows is the full one, so the gradient of its block is its slice."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.block(g.shape[0])], None


def gather_replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-gather of the rank blocks into the global batch,
    for a replicated loss (the materialized loss and metrics on a mesh)."""
    return _GatherReplicated.apply(x, mesh) if mesh.size > 1 else x


def sync_grads(grads: dict[str, torch.Tensor], mesh: Mesh, *, sharded=frozenset()) -> dict[str, torch.Tensor]:
    """Every rank's gradients of the replicated leaves summed over the
    ranks, in one all-reduce of one flat buffer. A SUM, not a mean: each
    rank's backward of the global loss holds only its own rows' share of
    every gradient (replicated tables' [R, D] partials included), and the
    shares add up to the gradient of one device's step on the whole batch.
    The leaves named in ``sharded`` (row-sharded tables) pass as they are:
    the row exchange's backward already left each rank the whole gradient
    of its own block, and a sum would count the other ranks' zeros and
    move 2 x 1.28 GB a step at BASELINE config 3."""
    names = [k for k in grads if k not in sharded]
    out = dict(grads)
    if not names:
        return out
    flat = mesh.all_reduce_(torch.cat([grads[k].reshape(-1).float() for k in names]))
    start = 0
    for k in names:
        g = grads[k]
        out[k] = flat[start : start + g.numel()].view(g.shape).to(g.dtype)
        start += g.numel()
    return out


def global_sq_norm(tensors: dict[str, torch.Tensor], mesh: Mesh, *, sharded=frozenset()) -> torch.Tensor:
    """The sum of squares of every entry of ``tensors`` as one device would
    count it: the replicated leaves once (each rank holds them whole), the
    row-sharded leaves named in ``sharded`` summed over the ranks (each rank
    holds its block). A 0-dim float32 tensor, equal on every rank."""
    zero = torch.zeros((), device=mesh.device)
    own = sum(((t.float() * t.float()).sum() for k, t in tensors.items() if k in sharded), zero)
    rep = sum(((t.float() * t.float()).sum() for k, t in tensors.items() if k not in sharded), zero)
    return mesh.all_reduce_(own.reshape(1)).reshape(()) + rep


def make_mesh(devices: Sequence | None = None, cfg: MeshConfig | None = None, *, group=None) -> Mesh:
    """This rank's mesh over ``devices``, one per rank of ``group`` (the
    default group): rank r runs on ``devices[r]``. ``devices=None`` puts
    each rank on the card of its local index. The reference's axis checks
    hold: the device count must divide ``model_axis`` and equal data x
    model. The devices form the reference's grid, reshaped row-major into
    (data, model): rank r has data index r // model and model index
    r % model. With a model axis above 1 the mesh creates one data group
    per model index (``dist.new_group``, which every rank of the default
    group must call alike: so every rank of it calls ``make_mesh``)."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    if devices is None:
        devices = [torch.device("cuda", i % max(torch.cuda.device_count(), 1)) for i in range(world)]
    devices = list(devices)
    n = len(devices)
    model = max(cfg.model_axis, 1)
    if n % model:
        raise ValueError(f"{n} devices not divisible by model_axis={model}")
    data = cfg.data_axis if cfg.data_axis > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if n != world:
        raise ValueError(f"make_mesh: {n} devices but the process group has {world} ranks (one device each)")
    if model == 1:
        return Mesh(devices[rank], group)
    global_ranks = [dist.get_global_rank(group, r) if group is not None else r for r in range(world)]
    data_group = None
    for m in range(model):  # the ranks of model index m, in data order
        g = dist.new_group([global_ranks[d * model + m] for d in range(data)])
        if rank % model == m:
            data_group = g
    return Mesh(devices[rank], data_group, world_group=group, model_index=rank % model, model_size=model)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rank's rows of a global batch. The reference returns a
    ``NamedSharding`` over ``P("data")`` that ``device_put`` applies; here
    each rank slices its block (``Mesh.block``), which the mesh steps,
    ``data/pipeline.py``'s ``sharding`` argument and :func:`shard_batch` do."""
    return mesh.block(batch_size)


def shard_batch(batch: PairBatch, mesh: Mesh) -> PairBatch:
    """The rank's block of a global batch (numpy or tensors), on the rank's
    device: what the reference's ``device_put`` with :func:`batch_sharding`
    leaves on device r."""
    rows = mesh.block(batch.batch_size)
    return PairBatch(*(TowerBatch(torch.as_tensor(side.dense)[rows], torch.as_tensor(side.cat_ids)[rows])
                       .to(mesh.device) for side in batch))


def replicated(mesh: Mesh) -> torch.device:
    """Where a replicated array lives on this rank: its device. The
    reference's ``NamedSharding(mesh, P())``; every rank holds its own copy
    (:func:`put_replicated` makes them equal)."""
    return mesh.device


def put_replicated(x, mesh: Mesh) -> torch.Tensor:
    """``x`` on this rank's device, rank 0's value on every rank of both
    axes: a broadcast from world rank 0 (the reference places one host
    value on every device)."""
    t = torch.as_tensor(x).to(mesh.device).contiguous()
    return mesh.broadcast_(t)


def row_sharding(mesh: Mesh, rows: int) -> slice:
    """The rank's block of a row-sharded array of ``rows`` rows padded to a
    multiple of the mesh size (the reference's ``P("data", None)``): the
    rows a row-sharded embedding table (``sharded_embedding.py``), its
    optimizer leaves, a row-sharded feature store (``sharded_store.py``),
    the sharded corpus eval and ``serving/index.ShardedIndex`` keep on
    this rank."""
    return mesh.block(-(-rows // mesh.size) * mesh.size)


def shard_state(state_dict: dict[str, torch.Tensor], mesh: Mesh, keys) -> dict[str, torch.Tensor]:
    """``state_dict`` with each leaf named in ``keys`` (row-sharded tables)
    cut to this rank's block of rows; the rest as they are. A one-device
    state cut so equals a mesh state leaf for leaf."""
    return {k: (v[mesh.block(v.shape[0])] if k in keys else v) for k, v in state_dict.items()}


def join_state(state_dict: dict[str, torch.Tensor], mesh: Mesh, keys) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state`: each leaf named in ``keys``
    gathered whole from every rank's block (a collective: every rank calls
    it alike); the rest as they are."""
    return {k: (mesh.all_gather_rows(v) if k in keys else v) for k, v in state_dict.items()}


# dense table gradients (cost ~ rows x batch) lose to the scatter above this
# unified-table height; below it replicating the (few-MB) table is cheaper
# than exchanging rows every step and keeps the dense-gradient kernel
# (models/embedding.py DENSE_GRAD_MAX_ROWS, the same crossover)
AUTO_REPLICATE_MAX_ROWS = 1 << 16


def resolve_embedding_sharding(mesh_cfg: MeshConfig, schema) -> str:
    """The concrete embedding-sharding mode: "auto" -> "replicated" when
    every tower's unified table is at most ``AUTO_REPLICATE_MAX_ROWS``
    rows, else "gspmd_rows"; explicit modes pass through."""
    mode = mesh_cfg.embedding_sharding
    if mode != "auto":
        return mode
    from jodalrob_twotower_torch.models.embedding import table_layout

    total = max(
        table_layout(side.vocab_sizes)[1] if side.vocab_sizes else 0
        for side in (schema.notice, schema.company)
    )
    return "replicated" if total <= AUTO_REPLICATE_MAX_ROWS else "gspmd_rows"

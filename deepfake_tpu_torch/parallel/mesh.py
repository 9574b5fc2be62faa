"""The port's device mesh: data and tensor parallelism over a
torch.distributed group (deepfake_tpu/parallel/mesh.py).

The JAX package's mesh is single-controller: one process sees every device
and XLA inserts the collectives. The port follows torch's own idiom: one
process per device, joined in a ``torch.distributed`` group (NCCL on the
card, gloo on the CPU), its ranks laid out as a (data, model) grid, rank =
d * model + m:

    mesh = join_group(cfg, device)      # the group torchrun launched, as a Mesh; None without one
    mesh = make_mesh(data=-1, model=1)  # over an initialised group
    inputs, labels = shard_batch(inputs, labels, mesh, accum)   # this data rank's rows
    shard_model(model, mesh)            # tensor parallelism over 'model', by parameter name

Batches shard over ``data``: a data rank takes its slice of every
micro-batch (``shard_batch``); where the data axis does not divide a
micro-batch, every data rank takes the whole batch (warned once). BatchNorm
takes its statistics over the global batch (``models/layers.py``), the
fused model's InfoNCE loss gathers the global batch (``models/fusion.py``),
and the Trainer all-reduces the summed gradients over ``data`` once a step.

Tensor parallelism over ``model`` splits the projections whose JAX names
``_spec_for`` selects (``_COL_KERNELS`` column-parallel, ``_ROW_KERNELS``
row-parallel), by module (``shard_model``): a column-parallel layer keeps
the rows of its output features, a row-parallel one the columns of its
input features and adds its bias once, after the all-reduce of its partial
products. Attention projections split by heads (q, k and v of heads H_m;
qkv's columns are q | k | v, each head-major), so a layer whose heads the
model axis does not divide is replicated (``head_exceptions`` lists them).
Only the 2-D weights are split, as the JAX rules split only kernels; biases,
SwinV2's logit_scale and the relative-position bias stay replicated and are
sliced where they are used (``_Copy``: the identity forward, a gradient
all-reduce over ``model``). A split weight's momentum buffer follows it,
since ``schedule.SGD`` keeps one a local parameter.

Nothing falls back: a mesh that does not divide the world, a group that
cannot be formed and a failed collective raise.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# the JAX rules (deepfake_tpu/parallel/mesh.py:104-122): kernels under these
# names column-shard, and their consumers row-shard
_COL_KERNELS = ("fc1", "intermediate_dense", "qkv", "qkv_kernel", "q_proj",
                "k_proj", "v_proj", "queries", "keys", "values")
_ROW_KERNELS = ("fc2", "output_dense", "proj", "out_proj")


def _spec_for(name: str, out_features: int, in_features: int, model_size: int) -> Optional[str]:
    """"col", "row" or None for a dense kernel under ``name`` (the module's
    last name) of ``out_features`` x ``in_features``: the JAX rule on the
    JAX kernel [in, out]."""
    if model_size <= 1:
        return None
    if name in _COL_KERNELS and out_features % model_size == 0:
        return "col"
    if name in _ROW_KERNELS and in_features % model_size == 0:
        return "row"
    return None


class Mesh:
    """The (data, model) grid over the initialised group: sizes ``data`` and
    ``model``, this rank's coordinates ``d`` and ``m``, and the subgroups of
    its data axis (the ranks of its model index) and model axis (the ranks
    of its data index). ``sharded``: the parameters that ``shard_model``
    split, by name, as (dim, index of the full tensor's rows along dim,
    full size along dim). ``batch_sharded``: whether the batch at hand is
    split over ``data`` (the default) or replicated on every data rank, when
    no statistic is all-reduced over ``data``; it is set for one batch at a
    time (``batch_state``)."""

    def __init__(self, data: int, model: int):
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        if data * model != self.world:
            raise ValueError(f"mesh {data} x {model} does not cover {self.world} ranks")
        self.data, self.model = data, model
        self.d, self.m = divmod(self.rank, model)
        # every rank forms every subgroup, in one order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == self.d:
                self.model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == self.m:
                self.data_group = g
        self.sharded: Dict[str, Tuple[int, torch.Tensor, int]] = {}
        self.batch_sharded = True

    def __repr__(self):
        return f"Mesh({self.data} data x {self.model} model; rank {self.rank} = ({self.d}, {self.m}))"

    @property
    def stats_group(self):
        """The group BatchNorm's statistics and the InfoNCE batch reduce
        over: the data axis, None while the batch is replicated."""
        return self.data_group if self.batch_sharded else None


@contextlib.contextmanager
def batch_state(mesh: Optional[Mesh], sharded: bool):
    """While it runs, ``mesh``'s batch is split over the data axis
    (``sharded``) or replicated on every data rank; nothing without a mesh."""
    if mesh is None:
        yield
        return
    before, mesh.batch_sharded = mesh.batch_sharded, sharded
    try:
        yield
    finally:
        mesh.batch_sharded = before


def splits_train_batch(cfg, mesh: Optional[Mesh]) -> bool:
    """Whether a training micro-batch (``optim.batch_size`` rows) splits over
    the data axis; where it does not, every data rank takes the whole batch
    (``data_rows``). Evaluation and serving batches are padded to a multiple
    of the data axis and always split."""
    return mesh is not None and cfg.optim.batch_size % mesh.data == 0


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the initialised group; ``data = -1``
    takes every rank the model axis leaves."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed group "
                           "(join_group, or init_process_group)")
    world = dist.get_world_size()
    if data == -1:
        if world % model:
            raise ValueError(f"model axis {model} does not divide {world} ranks")
        data = world // model
    return Mesh(data, model)


def join_group(cfg, device: torch.device) -> Optional[Mesh]:
    """The CLIs' group (train.py:29-32): where torchrun launched the process
    (WORLD_SIZE > 1) or ``parallel.multihost`` is set, join the group its
    environment names (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), NCCL on
    the card and gloo on the CPU, and return the mesh of
    ``parallel.data_axis`` x ``parallel.model_axis``; else None (one device,
    no group). ``device`` must be this rank's card (cuda:LOCAL_RANK)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and not cfg.parallel.multihost:
        return None
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_mesh(cfg.parallel.data_axis, cfg.parallel.model_axis)


def local_device(cfg) -> Optional[str]:
    """The device a CLI's rank runs on: ``cuda:LOCAL_RANK`` under torchrun,
    the CPU where ``-cuda False`` asks for it, else None (the card)."""
    if not cfg.parallel.use_cuda:
        return "cpu"
    if "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return None


# ----------------------------------------------------------------- batches

_warned_replicate = False


def _rows(x, pick):
    if isinstance(x, (tuple, list)):
        return tuple(_rows(e, pick) for e in x)
    return pick(x)


def data_rows(n: int, mesh: Mesh, accum: int = 1) -> Optional[List[int]]:
    """This data rank's rows of a global batch of ``n`` rows in ``accum``
    micro-batches: its slice of each micro-batch (micro-batch i is rows
    [i n / accum, (i + 1) n / accum)); None where the data axis does not
    divide a micro-batch (every data rank then takes the whole batch)."""
    if n % accum:
        raise ValueError(f"a batch of {n} rows does not split into {accum} micro-batches")
    bs = n // accum
    if bs % mesh.data:
        return None
    k = bs // mesh.data
    return [i * bs + mesh.d * k + j for i in range(accum) for j in range(k)]


def shard_batch(inputs: Any, labels: Any, mesh: Mesh, accum: int = 1):
    """(inputs, labels) -> this data rank's rows (``data_rows``), every leaf
    cut along its first axis; the whole batch, warned once, where the data
    axis does not divide a micro-batch (mesh.py:49-73)."""
    n = len(labels)
    rows = data_rows(n, mesh, accum)
    if rows is None:
        global _warned_replicate
        if not _warned_replicate:
            _warned_replicate = True
            warnings.warn(f"a micro-batch of {n // accum} rows does not divide over the data "
                          f"axis {mesh.data}: every data rank computes the whole batch")
        return inputs, labels

    def pick(x):
        if torch.is_tensor(x):
            return x[torch.as_tensor(rows, device=x.device)]
        return x[rows]

    return _rows(inputs, pick), _rows(labels, pick)


def pad_batch_to_multiple(inputs: Any, labels: Any, n: int):
    """Every leaf's first axis padded to a multiple of ``n`` by repeating its
    last row (mesh.py:76-101); returns (inputs, labels, rows before the
    padding)."""
    b = len(labels)
    pad = (-b) % n
    if pad == 0:
        return inputs, labels, b

    def grow(x):
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

    return _rows(inputs, grow), _rows(labels, grow), b


def shard_eval_batch(inputs: Any, labels: Any, mesh: Mesh):
    """An evaluation batch as ``Trainer.eval`` takes it under a mesh (and the
    val loader yields it): padded to a multiple of the data axis by
    repeating its last row, the padding rows' labels NaN, then this data
    rank's contiguous block of rows."""
    inputs, labels, n = pad_batch_to_multiple(inputs, labels, mesh.data)
    labels = np.array(labels.cpu() if torch.is_tensor(labels) else labels, np.float32)
    labels[n:] = np.nan
    return shard_batch(inputs, labels, mesh)


# ------------------------------------------------------------- collectives

class _Copy(torch.autograd.Function):
    """The identity forward; the gradient all-reduced (summed) over ``group``:
    where a replicated tensor feeds work split over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Partial sums all-reduced over ``group``; the gradient as it is (every
    rank holds the same)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Each rank's piece concatenated along ``dim`` in rank order. The
    gradient: ``summed`` (the pieces feed a different loss on every rank)
    all-reduces it over the group before taking this rank's piece; else
    (every rank holds the same gradient) the piece alone."""

    @staticmethod
    def forward(ctx, x, group, dim: int, summed: bool):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        size = dist.get_world_size(group)
        ctx.rank, ctx.size = dist.get_rank(group), size
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous(), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1, summed: bool = False) -> torch.Tensor:
    return _Gather.apply(x, group, dim % x.dim(), summed)


def global_max(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The largest of a statistic over the data ranks' rows (a batch's
    longest valid wave); as it is without a mesh or on a replicated batch."""
    if mesh is None or mesh.stats_group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.stats_group)
    return t


def attach(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The data axis on the modules whose statistics span the batch:
    BatchNorm, the fusion head's alignment loss, wav2vec2's batch-longest
    length, the int8 convs' per-tensor max (the Predictor's data-parallel
    serving; ``shard_model`` calls it too)."""
    from deepfake_tpu_torch.models.audio2d import Audio2D
    from deepfake_tpu_torch.models.fusion import FusionModel
    from deepfake_tpu_torch.models.layers import BatchNorm, Int8Owner
    from deepfake_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    for mod in model.modules():
        if isinstance(mod, (BatchNorm, FusionModel, Wav2Vec2Model, Audio2D, Int8Owner)):
            mod.mesh = mesh
    return model


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of a per-row tensor, with autograd: each data
    rank's rows in rank order. The gradient of a data rank's rows sums the
    data ranks' gradients (every rank's loss reads every row); the
    Trainer's gradient mean over ``data`` divides by the W it adds. The
    rows as they are without a mesh or on a replicated batch."""
    if mesh is None or mesh.stats_group is None:
        return x
    return gather_from(x, mesh.stats_group, dim=0, summed=True)


# ------------------------------------------------------ tensor parallelism

class Split:
    """One layer's share of the model axis: ``index``, the rows of the full
    layer's output features this rank keeps (a column split) or the
    columns of its input features (a row split)."""

    def __init__(self, mesh: Mesh, index: torch.Tensor):
        self.mesh = mesh
        self.group = mesh.model_group
        self.index = index

    def take(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice of a replicated tensor, the gradient summed over
        ``model`` (each rank adds the gradient of its slice)."""
        return copy_to(t, self.group).index_select(dim, self.index)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        return copy_to(t, self.group)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return reduce_from(t, self.group)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return gather_from(t, self.group, dim)


class ColumnParallel(Split):
    """A column-parallel Linear: the replicated input, this rank's output
    features (``gather``: all of them, gathered over ``model``)."""

    def __init__(self, mesh, index, gather: bool = False):
        super().__init__(mesh, index)
        self.gather_out = gather

    def __call__(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        b = None if lin.bias is None else self.take(lin.bias).to(x.dtype)
        y = torch.nn.functional.linear(self.copy(x), lin.weight.to(x.dtype), b)
        return self.gather(y) if self.gather_out else y


class RowParallel(Split):
    """A row-parallel Linear: this rank's input features (already split
    where ``split_input``, else sliced from the replicated input), the
    partial products all-reduced over ``model``, the bias added once."""

    def __init__(self, mesh, index, split_input: bool = True):
        super().__init__(mesh, index)
        self.split_input = split_input

    def __call__(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if not self.split_input:
            x = self.take(x, dim=x.dim() - 1)
        y = self.reduce(torch.nn.functional.linear(x, lin.weight.to(x.dtype)))
        return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _block(total: int, mesh: Mesh, dev) -> torch.Tensor:
    """This model rank's contiguous block of ``total`` (a head-major layout's
    channels of its heads), on ``dev``: a capture refuses host copies."""
    k = total // mesh.model
    return torch.arange(mesh.m * k, (mesh.m + 1) * k, device=dev)


def _qkv_index(heads: int, head_dim: int, mesh: Mesh, dev) -> torch.Tensor:
    """This rank's rows of a q | k | v projection: its heads of each."""
    c = heads * head_dim
    own = _block(c, mesh, dev)
    return torch.cat([own, c + own, 2 * c + own])


def _split_param(module: nn.Module, attr: str, dim: int, index: torch.Tensor, mesh: Mesh,
                 names: Dict[int, str]) -> None:
    """``module.attr`` cut in place to ``index`` along ``dim`` (the Parameter
    object kept, so an optimizer built later steps the local slice)."""
    p = getattr(module, attr)
    full = p.shape[dim]
    with torch.no_grad():
        p.data = p.data.index_select(dim, index).contiguous()
    mesh.sharded[names[id(p)]] = (dim, index, full)


def _set_col(lin, mesh, index, names, gather=False):
    _split_param(lin, "weight", 0, index, mesh, names)
    lin.tp = ColumnParallel(mesh, index, gather)


def _set_row(lin, mesh, index, names, split_input=True):
    _split_param(lin, "weight", 1, index, mesh, names)
    lin.tp = RowParallel(mesh, index, split_input)


def head_exceptions(model: nn.Module, model_size: int) -> List[str]:
    """The attention layers that stay replicated under a model axis of
    ``model_size``: their heads do not divide over it (the JAX package
    splits their projections' columns all the same, which changes no
    number)."""
    from deepfake_tpu_torch.models.swin2d import WindowAttention
    from deepfake_tpu_torch.models.swin3d import WindowAttention3D
    from deepfake_tpu_torch.models.wav2vec2 import SelfAttention

    out = []
    for name, mod in model.named_modules():
        heads = (mod.num_heads if isinstance(mod, (WindowAttention, WindowAttention3D)) else
                 mod.H if isinstance(mod, SelfAttention) else None)
        if heads is not None and model_size > 1 and heads % model_size:
            out.append(name)
    return out


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Tensor parallelism over ``mesh``'s model axis, in place, before an
    optimizer is built; and the data-axis statistics (BatchNorm, the InfoNCE
    batch) attached to the modules that take them. See the module's note."""
    from deepfake_tpu_torch.models.fusion import FusionModel
    from deepfake_tpu_torch.models.layers import Mlp
    from deepfake_tpu_torch.models.nextvlad import InceptionVideoClassifier
    from deepfake_tpu_torch.models.swin2d import WindowAttention
    from deepfake_tpu_torch.models.swin3d import TransformerEncoderLayer, WindowAttention3D
    from deepfake_tpu_torch.models.wav2vec2 import FeedForward, SelfAttention

    names = {id(p): n for n, p in model.named_parameters()}
    M = mesh.model
    dev = next(model.parameters()).device
    attach(model, mesh)
    if M == 1:
        return model
    for mod in model.modules():
        if isinstance(mod, Mlp):
            hidden, cin = mod.fc1.weight.shape
            if _spec_for("fc1", hidden, cin, M) == "col":  # fc2 then splits too
                idx = _block(hidden, mesh, dev)
                _set_col(mod.fc1, mesh, idx, names)
                _set_row(mod.fc2, mesh, idx, names)
        elif isinstance(mod, (WindowAttention, WindowAttention3D)):
            H = mod.num_heads
            C = mod.proj.weight.shape[1]
            if H % M:
                continue  # head_exceptions
            mod.tp = Split(mesh, _block(H, mesh, dev))  # the local heads
            qkv_idx = _qkv_index(H, C // H, mesh, dev)
            if isinstance(mod, WindowAttention):
                _split_param(mod, "qkv_weight", 0, qkv_idx, mesh, names)
                mod.qkv_tp = Split(mesh, qkv_idx)
            else:
                _set_col(mod.qkv, mesh, qkv_idx, names)
            _set_row(mod.proj, mesh, _block(C, mesh, dev), names)
        elif isinstance(mod, SelfAttention):
            C = mod.out_proj.weight.shape[1]
            if mod.H % M:
                continue  # head_exceptions
            idx = _block(C, mesh, dev)
            for lin in (mod.q_proj, mod.k_proj, mod.v_proj):
                _set_col(lin, mesh, idx, names)
            _set_row(mod.out_proj, mesh, idx, names)
            mod.local_heads = mod.H // M
        elif isinstance(mod, TransformerEncoderLayer):
            # the attention-pooling head: the JAX rules row-split out_proj
            # and leave in_proj whole, so out_proj slices its replicated input
            C = mod.out_proj.weight.shape[1]
            if _spec_for("out_proj", C, C, M) == "row":
                _set_row(mod.out_proj, mesh, _block(C, mesh, dev), names, split_input=False)
        elif isinstance(mod, FeedForward):
            inter = mod.intermediate_dense.weight.shape[0]
            if inter % M == 0:
                idx = _block(inter, mesh, dev)
                _set_col(mod.intermediate_dense, mesh, idx, names)
                _set_row(mod.output_dense, mesh, idx, names)
        elif isinstance(mod, FusionModel):
            C = mod.common_dim
            if C % M == 0:  # one 3-token head: its channels split the dot products
                idx = _block(C, mesh, dev)
                for lin in (mod.queries, mod.keys, mod.values):
                    _set_col(lin, mesh, idx, names)
                mod.tp = Split(mesh, idx)
        elif isinstance(mod, InceptionVideoClassifier):
            # the gating: fc1's output feeds a BatchNorm with one statistic
            # over all its columns, so it is gathered before it, and fc2
            # slices its replicated input
            hidden = mod.fc1.weight.shape[0]
            if hidden % M == 0:
                idx = _block(hidden, mesh, dev)
                _set_col(mod.fc1, mesh, idx, names, gather=True)
                _set_row(mod.fc2, mesh, idx, names, split_input=False)
    return model


# ------------------------------------------------------- gradients, checkpoints

def sharded_flags(model: nn.Module, params: List[nn.Parameter], mesh: Optional[Mesh]) -> List[bool]:
    """For each of ``params``: whether it is split over ``model``."""
    if mesh is None:
        return [False] * len(params)
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] in mesh.sharded for p in params]


def all_reduce_mean(grads: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean of ``grads`` over the data axis, through one flat buffer and
    one all-reduce (XLA's psum of the JAX step); returns views of it."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


def full_tensor(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole of a parameter (or its momentum), gathered over ``model``
    where ``shard_model`` split it; collective: every model rank calls it."""
    if mesh is None or name not in mesh.sharded:
        return t
    dim, index, full = mesh.sharded[name]
    pieces = gather_from(t.detach(), mesh.model_group, dim)
    # each rank's rows land where its index says (qkv's are q, k and v of
    # its heads, not one block)
    where = gather_from(index, mesh.model_group, 0).to(t.device)
    shape = list(t.shape)
    shape[dim] = full
    return t.new_empty(shape).index_copy_(dim, where, pieces)


def local_slice(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's slice of a whole tensor saved under ``name``."""
    if mesh is None or name not in mesh.sharded:
        return t
    dim, index, _ = mesh.sharded[name]
    return t.index_select(dim, index.to(t.device))

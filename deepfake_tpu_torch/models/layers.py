"""Building blocks shared by the port's models (deepfake_tpu/models/layers.py).

Images run NCHW in ``torch.channels_last`` memory, so a [N, C, H, W] tensor
is NHWC in memory: the IRv2 block kernel reads it as flat frame-major rows
without a copy, and cuDNN takes it as is. Norm layers compute in f32 and
return the input's type, as flax's do. Modules whose training differs
(BatchNorm, the Dropout family, and the models built of them) are built in
eval mode, the mode serving runs them in; ``model.train()`` selects
training.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch nn.GELU's exact erf form in f32; the tanh form in bf16, as the
    JAX package does for speed (layers.py:75-87)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics. flax's default eps
    is 1e-6 (torch's is 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class _BatchStats(torch.autograd.Function):
    """Training BatchNorm of x [rows, C] with the statistics over the rows
    of every data rank: one routine with or without a group (``group``:
    the data axis, or None), so that a group of one computes the bits of no
    group. On the card, PyTorch's SyncBatchNorm kernels
    (``batch_norm_stats``: this rank's mean and inverse std in one pass;
    the ranks' [mean, invstd, rows] all-gathered, ``batch_norm_gather_stats
    _with_counts`` combines them; ``batch_norm_elemt`` normalises;
    ``batch_norm_backward_reduce``, one all-reduce of its two sums,
    ``batch_norm_backward_elemt``). On the CPU, where those kernels do not
    exist, sums: the local sum all-reduced, the mean, the local sum of
    squared deviations all-reduced, the biased variance (flax's two-pass
    form), accumulated in f64 as PyTorch's CPU BatchNorm accumulates; the
    backward's two sums likewise. dw and db are this rank's (the Trainer's
    gradient mean over ``data`` adds the ranks'). Returns y in x's type and
    the batch mean and biased variance (f32) for the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
            C = mean.numel()
            local = torch.cat([mean, invstd, mean.new_full((1,), x.shape[0])])
            every = local[None]
            if group is not None:
                parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, local, group=group)
                every = torch.stack(parts)
            counts = every[:, 2 * C]
            # scratch f32 running buffers at momentum 0: the kernel takes
            # their type (the counts' too) and leaves them as they are
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, every[:, :C].contiguous(), every[:, C:2 * C].contiguous(),
                torch.zeros_like(mean), torch.ones_like(mean), 0.0, eps, counts)
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
            var = 1.0 / (invstd * invstd) - eps
            ctx.counts = counts.to(torch.int32)
        else:
            count = x.shape[0] * (1 if group is None else dist.get_world_size(group))
            xf = x.float()
            s = xf.sum(0, dtype=torch.float64)
            if group is not None:
                dist.all_reduce(s, group=group)
            mean = (s / count).float()
            xmu = xf - mean
            sq = (xmu * xmu).sum(0, dtype=torch.float64)
            if group is not None:
                dist.all_reduce(sq, group=group)
            var = (sq / count).float()
            invstd = torch.rsqrt(var + eps)
            y = (xmu * (invstd * weight.float()) + bias.float()).to(x.dtype)
            ctx.count = count
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, mean, invstd, weight = ctx.saved_tensors
        dy = dy.contiguous()
        if x.is_cuda:
            s_dy, s_dyx, dw, db = torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                                   True, True, True)
            if ctx.group is not None:
                sums = torch.cat([s_dy, s_dyx])
                dist.all_reduce(sums, group=ctx.group)
                s_dy, s_dyx = sums.chunk(2)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, s_dy, s_dyx,
                                                 ctx.counts)
            return dx, dw, db, None, None
        dyf = dy.float()
        xmu = x.float() - mean
        sums = torch.stack([dyf.sum(0, dtype=torch.float64),
                            (dyf * xmu).sum(0, dtype=torch.float64)])
        dw, db = (sums[1] * invstd).float(), sums[0].to(torch.float32, copy=True)
        if ctx.group is not None:
            dist.all_reduce(sums, group=ctx.group)
        s_dy, s_dyx = (sums[0] / ctx.count).float(), (sums[1] / ctx.count).float()
        dx = (dyf - s_dy - xmu * (invstd * invstd * s_dyx)) * (invstd * weight.float())
        return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype), None, None


class BatchNorm(nn.Module):
    """BatchNorm over ``axis`` with torch momentum semantics, in f32, the
    output in the input's type (layers.py:129-146, flax ``nn.BatchNorm``).

    Eval mode normalises with the running statistics. Training normalises
    with the batch's statistics over every axis but ``axis`` (``_BatchStats``)
    and moves the running ones as ``ra = (1 - m) ra + m batch``, where the
    batch variance is the biased one, as flax feeds it (torch's own
    BatchNorm and SyncBatchNorm feed the unbiased variance, n / (n - 1) of
    it). Under a mesh (``mesh``, set by ``parallel.mesh.shard_model``) the
    batch is the global one: the statistics are all-reduced over the data
    axis, as XLA all-reduces them under the JAX mesh, except while the
    batch is replicated on every data rank. ``torch_batchnorm``'s default
    eps is 1e-5."""

    mesh = None

    def __init__(self, features: int, eps: float = 1e-5, axis: int = 1, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.axis = axis
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eval()

    def forward(self, x):
        if self.training:
            return self._train(x)
        shape = [1] * x.dim()
        shape[self.axis] = -1
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        t = self.bias.float() - self.running_mean.float() * s
        return (x.float() * s.view(shape) + t.view(shape)).to(x.dtype)

    def _train(self, x):
        # channels last: a view for NCHW tensors in channels_last memory
        xc = x.movedim(self.axis, -1)
        rows = xc.reshape(-1, xc.shape[-1]).contiguous()
        group = None if self.mesh is None else self.mesh.stats_group
        y, mean, var = _BatchStats.apply(rows, self.weight, self.bias, self.eps, group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.view(xc.shape).movedim(-1, self.axis)


class Linear(nn.Linear):
    """nn.Linear that casts its parameters to the input's type at use, as
    the JAX package's dense layers do (swin3d.py:369-375): f32 masters train
    in bf16 and their gradients reach the f32 leaves; weights stored in the
    compute type (serving) cast to nothing. ``tp``: its split over a mesh's
    model axis (``parallel.mesh.ColumnParallel`` / ``RowParallel``)."""

    tp = None

    def forward(self, x):
        if self.tp is not None:
            return self.tp(self, x)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv1d(nn.Conv1d):
    """nn.Conv1d that casts its parameters to the input's type at use (as
    ``Linear``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts its parameters to the input's type at use (as
    ``Linear``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Dropout(nn.Module):
    """flax nn.Dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), in training only, or also in eval mode where
    ``at_inference`` is set (``model.parity_inference_dropout``: the
    reference's ungated F.dropout). The mask comes from ``generator``
    (set_dropout_generator), never from a global stream."""

    at_inference = False

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator
        self.eval()

    @property
    def active(self) -> bool:
        return (self.training or self.at_inference) and self.rate != 0.0

    def _keep(self, x, shape):
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}({self.rate}) in training needs a "
                               "generator (set_dropout_generator)")
        keep = 1.0 - self.rate
        mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x):
        if not self.active:
            return x
        return self._keep(x, x.shape)


class DropPath(Dropout):
    """Per-sample stochastic depth (layers.py:112-126): one keep draw per
    sample (the leading axis), x / keep where kept, in training only."""

    def forward(self, x):
        if not self.active:
            return x
        return self._keep(x, (x.shape[0],) + (1,) * (x.dim() - 1))


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Give every Dropout of ``model`` and every module built on it (DropPath,
    wav2vec2's LayerDrop and SpecAugment) the stream they draw from."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
    return model


# ------------------------------------------------------ activation checkpoints

def stage_policy(remat: bool, policy: str, stage: int) -> Tuple[bool, str]:
    """One backbone stage's remat setting from a spec that may name one
    policy a stage (layers.py:34-53): "dots,dots,off,off" checkpoints stages
    0-1 with "dots" and runs stages 2-3 without remat; "off" disables remat
    for its stage; a spec shorter than the stages extends with its last
    entry; a spec without a comma applies unchanged to every stage."""
    if "," not in policy:
        return remat, policy
    parts = [p.strip() for p in policy.split(",")]
    p = parts[stage] if stage < len(parts) else parts[-1]
    if p == "off":
        return False, ""
    return remat, p


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# the products each policy keeps from the forward (layers.py:56-72: jax's
# dots_with_no_batch_dims_saveable and dots_saveable); "" and "nothing"
# recompute everything
REMAT_SAVES = {
    "": (), "nothing": (), "dots": _MM,
    "dots_all": _MM + (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
}


def block_remat(remat: bool, policy: str, stage: int) -> Optional[str]:
    """The policy a stage's blocks are checkpointed with (``remat_block``),
    or None where remat is off for the stage; an unknown policy raises."""
    on, p = stage_policy(remat, policy, stage)
    if not on:
        return None
    if p not in REMAT_SAVES:
        raise ValueError(f"remat policy {p!r}: expected one of {sorted(REMAT_SAVES)}")
    return p


def _capturing(gen: torch.Generator) -> bool:
    return gen.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


class RecomputeStreams:
    """Where the checkpointed blocks of a captured training step draw their
    masks again. Inside a CUDA graph capture a generator's offset can be
    neither read nor set, so each block run of a step (the k-th, counted
    from ``begin_step``) recomputes from a generator of its own,
    ``twins[k]``, registered with the step's graph (``generators``); the
    step's eager warm-up runs record where ``generator`` stood when each
    block ran (``offsets``, from the step's start), and ``sync``, before
    each replay, puts every twin at the generator's seed and offset plus
    its block's. A replayed recompute then draws the masks that its block's
    forward drew in the same replay, and ``generator`` moves only by what
    the step without remat draws. The offsets hold for one step signature
    (a wave's length sets what its dropouts draw), so each step graph has
    one of its own. PyTorch's graph-safe state calls do not replace it:
    ``clone_state`` raises in a capture, and ``graphsafe_get_state`` shares
    the live state instead of copying it (tools/rng_capture_probe.py)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.twins: List[torch.Generator] = []
        self.offsets: List[int] = []
        self.k = 0
        self.start = 0

    @property
    def generators(self) -> List[torch.Generator]:
        return [self.generator, *self.twins]

    def begin_step(self) -> None:
        self.k = 0
        if not _capturing(self.generator):
            self.start = self.generator.get_offset()

    def block(self) -> Optional[torch.Generator]:
        """At a checkpointed block's forward: its twin during a capture, else
        None after noting the generator's offset."""
        k, self.k = self.k, self.k + 1
        if _capturing(self.generator):
            if k >= len(self.twins):
                raise RuntimeError("a captured step ran more checkpointed blocks than its "
                                   "warm-up")
            return self.twins[k]
        if k == len(self.twins):
            self.twins.append(torch.Generator(self.generator.device))
            self.offsets.append(0)
        self.offsets[k] = self.generator.get_offset() - self.start
        return None

    def sync(self) -> None:
        state, base = self.generator.get_state(), self.generator.get_offset()
        for twin, off in zip(self.twins, self.offsets):
            twin.set_state(state)
            twin.set_offset(base + off)


class _Recompute:
    """A checkpointed block's call: the forward draws its masks from the
    block's generator as without remat, the recompute draws the same masks
    again from a copy of the generator's state at the forward (or the
    captured step's twin, ``RecomputeStreams``), so the generator is left
    where the step without remat leaves it. No mask is saved."""

    def __init__(self, block: nn.Module):
        self.block = block
        self.drops = [m for m in block.modules() if isinstance(m, Dropout) and m.active]
        gens = {id(m.generator): m.generator for m in self.drops}
        if None in gens.values():
            raise RuntimeError("a Dropout in training needs a generator (set_dropout_generator)")
        if len(gens) > 1:
            raise RuntimeError("a checkpointed block draws from one dropout generator")
        self.gen = next(iter(gens.values()), None)
        self.replay, self.calls = None, 0
        if self.gen is not None:
            streams = getattr(block, "recompute_streams", None)
            twin = None if streams is None else streams.block()
            if twin is None and _capturing(self.gen):
                raise RuntimeError("a checkpointed block with dropout in a CUDA graph capture "
                                   "needs RecomputeStreams (the Trainer's compiled route)")
            self.replay = twin if twin is not None else self.gen.get_state()

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1 or self.gen is None:
            return self.block(*args)
        gen = self.replay
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(self.gen.device)
            gen.set_state(self.replay)
        try:
            for m in self.drops:
                m.generator = gen
            return self.block(*args)
        finally:
            for m in self.drops:
                m.generator = self.gen


def remat_block(block: nn.Module, *args):
    """``block(*args)``, checkpointed where the block's ``remat`` names a
    policy (``block_remat``) and autograd records (layers.py:56-72,
    ``nn.remat``): its activations are dropped after the forward and the
    forward runs again in the backward (``torch.utils.checkpoint``, not
    reentrant; "dots" and "dots_all" keep their products through
    selective-checkpoint contexts). Under ``no_grad`` (serving, CUDA graphs
    of requests) it is the plain call. A BatchNorm in a block would move
    its running statistics twice: no checkpointed block holds one."""
    policy = getattr(block, "remat", None)
    if policy is None or not torch.is_grad_enabled():
        return block(*args)
    saves = REMAT_SAVES[policy]
    kw = {"context_fn": _saving(saves)} if saves else {}
    return checkpoint(_Recompute(block), *args, use_reentrant=False, preserve_rng_state=False,
                      **kw)


class Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout (reference:
    src/utils.py:242-260)."""

    def __init__(self, in_features: int, hidden: int, out_features: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden)
        self.fc2 = Linear(hidden, out_features)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(gelu_exact(self.fc1(x)))))


Padding = Union[int, Sequence[int], str]


class Int8Owner(nn.Module):
    """A module that owns int8 convs at serving (``model.irv2_quant``): the
    activation max-abs of each, one f32 scalar on the device named as its
    JAX ``quant_cache`` leaf (``add_act_scale``; a buffer outside the
    state_dict, so checkpoints do not change), its int8 weights
    (``int8_packed``, made once by ``registry.pack_int8_weights`` from the
    f32 weights through the subclass's ``pack_int8``; without them each call
    packs the current weights), and the mode. ``quant``: None, ``"int8"``
    (each batch's max, layers.py:224-247's dynamic branch) or
    ``"int8_static"`` (the calibrated scalar; before any calibration the
    dynamic computation, as JAX falls back). While ``calibrating``
    (``registry.calibrate_act_scales``) an int8_static conv runs on the
    batch's max and folds it into its scalar (``torch.maximum``, in place: a
    captured graph holds the address). ``mesh`` (``parallel.mesh.attach``):
    the batch's max is taken over the data axis. Training always takes the
    float path. In dynamic mode a conv takes what its caller knows of its
    input (``x_q``, ops/int8_conv.py::QInput: the max its producer's K7
    epilogue reduced, or the max and int8 copy of a tensor several convs
    read, ``quantize_shared``) and may hand its own output's max on
    (``out_amax``), so that each distinct activation is reduced and
    quantised once a forward."""

    quant: Optional[str] = None
    calibrating = False
    mesh = None
    int8_packed = None

    def add_act_scale(self, name: str) -> None:
        self.register_buffer(name, torch.zeros((), dtype=torch.float32), persistent=False)
        self.calibrated = set()  # the scalars calibrated since the weights were loaded

    def reset_act_scales(self) -> None:
        for name in self.calibrated:
            getattr(self, name).zero_()
        self.calibrated = set()

    def load_act_scale(self, name: str, value) -> None:
        """A calibrated scalar carried in (a JAX ``quant_cache`` leaf)."""
        if name not in dict(self.named_buffers(recurse=False)):
            raise KeyError(f"{type(self).__name__} has no activation scale {name!r}")
        getattr(self, name).fill_(float(value))
        self.calibrated.add(name)

    def int8_active(self, kernel: Sequence[int], stride: int, cin: int) -> bool:
        """Whether a conv of this shape runs int8 now: a quant mode, eval
        mode, and the scope gate (ops/int8_conv.py::int8_shape_allowed)."""
        if self.quant is None or self.training:
            return False
        from deepfake_tpu_torch.ops.int8_conv import int8_shape_allowed

        return int8_shape_allowed(kernel, stride, cin)

    def int8_dynamic(self, name: str) -> bool:
        """Whether the conv of scalar ``name`` takes this batch's max: int8,
        or int8_static while calibrating or before its scalar is."""
        return not (self.quant == "int8_static" and not self.calibrating
                    and name in self.calibrated)

    @property
    def int8_group(self):
        """The process group the batch's max is taken over (the mesh's data
        axis while the batch is split over it), or None."""
        return None if self.mesh is None else self.mesh.stats_group

    def int8_forward(self, name: str, x: torch.Tensor, relu: bool, x_q=None,
                     out_amax: bool = False):
        """The int8 conv (ops/int8_conv.py) of NCHW ``x`` (channels_last)
        with the scalar ``name``: (the output NCHW in x's type, the output's
        QInput or None). In dynamic mode it takes ``x_q`` (what is known of
        x) and, with ``out_amax``, has K7 reduce the output's max."""
        from deepfake_tpu_torch.ops.int8_conv import quantized_conv

        w = self.int8_packed
        if w is None or w.wq.device != x.device:
            w = self.pack_int8()
        amax = getattr(self, name)
        dynamic = self.int8_dynamic(name)
        out, used, out_q = quantized_conv(as_nhwc(x), w, None if dynamic else amax, relu,
                                          self.int8_group, x_q if dynamic else None,
                                          out_amax and dynamic)
        if self.quant == "int8_static" and self.calibrating:
            amax.copy_(torch.maximum(amax, used.reshape(())))
            self.calibrated.add(name)
        return as_nchw(out), out_q


class ConvBnRelu(Int8Owner):
    """Conv2d + BatchNorm(eps 1e-3, momentum ``bn_momentum``) + ReLU
    (reference: src/models/InceptionResV2.py:6-16). ``padding`` is an int,
    an (h, w) pair, or "VALID".

    With ``quant`` (set by InceptionResNetV2) in eval mode, where the scope
    gate allows the shape, it runs int8 (layers.py:273-330): the BatchNorm
    folded into the conv weight in f32 (g = scale rsqrt(var + eps), shift =
    bias - mean g, w g), the folded weight quantised per output channel,
    the input per tensor, and relu(acc (xs ws) + shift) in the input's
    type. ``forward(x, x_q=None, out_amax=False)``: ``x_q`` what is known of
    x's int8 form (``Int8Owner``); with ``out_amax`` it returns (y, y's
    QInput or None), for a consumer that is an int8 conv."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], stride: int = 1,
                 padding: Padding = 0, bn_eps: float = 1e-3, bn_momentum: float = 0.1):
        super().__init__()
        if padding == "VALID":
            padding = 0
        self.conv = Conv2d(cin, cout, tuple(kernel), stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout, eps=bn_eps, momentum=bn_momentum)
        self.add_act_scale("act_amax")
        self.eval()

    def pack_int8(self):
        from deepfake_tpu_torch.ops.int8_conv import Int8Weights

        bn = self.bn
        g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        shift = bn.bias.float() - bn.running_mean.float() * g
        ph, pw = self.conv.padding
        return Int8Weights.from_folded(self.conv.weight.float() * g.view(-1, 1, 1, 1), shift,
                                       self.conv.stride[0], (ph, ph, pw, pw))

    def int8_now(self) -> bool:
        c = self.conv
        return self.int8_active(c.kernel_size, c.stride[0], c.in_channels)

    def forward(self, x, x_q=None, out_amax: bool = False):
        if self.int8_now():
            y, y_q = self.int8_forward("act_amax", x, relu=True, x_q=x_q, out_amax=out_amax)
        else:
            y, y_q = torch.relu(self.bn(self.conv(x))), None
        return (y, y_q) if out_amax else y


def quantize_shared(x: torch.Tensor, consumers: Sequence[ConvBnRelu]):
    """NCHW ``x``'s max and int8 copy (ops/int8_conv.py::quantize_input),
    made once for the ConvBnRelus that read it, where one of them runs int8
    in dynamic mode now; else None (each consumer then takes its float path
    or its own calibrated scalar)."""
    live = [m for m in consumers if m.int8_now() and m.int8_dynamic("act_amax")]
    if not live:
        return None
    from deepfake_tpu_torch.ops.int8_conv import quantize_input

    return quantize_input(as_nhwc(x), live[0].int8_group)


def max_pool_torch(x, window: int, stride: int, padding: int = 0):
    """torch.nn.MaxPool2d (layers.py:340)."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_torch(x, window: int, stride: int, padding: int = 0,
                   count_include_pad: bool = True):
    """torch.nn.AvgPool2d; count_include_pad=False divides by the valid
    elements of each window (layers.py:351-364, the IRv2 stem)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in the spirit of the JAX package's init: conv
    and dense kernels lecun-normal (std 1/sqrt(fan_in)), biases zero, norm
    scales one, running mean 0 / var 1. Swin's res-post-norm scales start
    at one here, not zero as in training init, so that random weights push
    every attention block's output into the result."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, BatchNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if hasattr(mod, "init_extra"):
                mod.init_extra(generator)
    return model


def as_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory (no copy when x is
    contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def as_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (free for channels_last memory)."""
    return x.permute(0, 2, 3, 1).contiguous()

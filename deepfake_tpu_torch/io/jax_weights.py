"""Carry the JAX package's weights into the port.

``load_jax_variables(model, variables)`` takes the JAX model's variables as
nested dicts of numpy arrays, ``{"params": ..., "batch_stats": ...}``, and
fills the port's module. The port's submodules carry the JAX tree's names,
so a leaf at ``params/a/b/kernel`` lands on module ``a.b``; only the leaf
name and layout change:

  flax Conv kernel [kh, kw, cin, cout] -> Conv2d weight [cout, cin, kh, kw]
  flax Conv kernel [k, cin/g, cout]    -> Conv1d weight [cout, cin/g, k]
  Dense kernel [in, out]               -> Linear weight [out, in]
  flax Conv kernel [*k, cin, cout] on a Linear (a stride == kernel conv
    run as space-to-depth + GEMM, Swin3D's patch embedding)
                                       -> Linear weight [cout, prod(k) * cin]
  Swin qkv_kernel [C, 3C]              -> qkv_weight [3C, C]
  LayerNorm / BatchNorm / GroupNorm scale -> weight
  batch_stats mean / var               -> running_mean / running_var

It is strict: every JAX leaf is consumed, every port parameter and
persistent buffer is set, and any mismatch raises with the path.

A ``quant_cache`` collection (int8_static's calibrated activation scales,
``deepfake_tpu/models/registry.py::calibrate_act_scales``) lands leaf by
leaf, by the same module paths, in each int8 conv's scalar (``act_amax`` of
a ConvBnRelu, ``res_act_amax`` of a residual block), which then counts as
calibrated; without one, every scale is forgotten (weights loaded since).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from deepfake_tpu_torch.models.registry import drop_inference_caches, reset_calibration

_RENAME = {
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _convert(owner: nn.Module, leaf: str, arr: np.ndarray, where: str) -> Tuple[str, torch.Tensor]:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if leaf == "kernel":
        if isinstance(owner, nn.Linear):
            t = t.reshape(-1, t.shape[-1]).t()
        elif isinstance(owner, nn.Conv2d):
            t = t.permute(3, 2, 0, 1)
        elif isinstance(owner, nn.Conv1d):
            t = t.permute(2, 1, 0)
        else:
            raise ValueError(f"{where}: a kernel for a {type(owner).__name__}")
        return "weight", t
    if leaf == "qkv_kernel":
        return "qkv_weight", t.t()
    return leaf, t


def load_jax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Fill ``model`` from the JAX variables tree; see the module docstring."""
    extra = set(variables) - {"params", "batch_stats", "quant_cache"}
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    targets = dict(model.state_dict(keep_vars=True))
    done = set()
    with torch.no_grad():
        for collection in ("params", "batch_stats"):
            for path, arr in _leaves(variables.get(collection, {})):
                where = "/".join((collection,) + path)
                mod_path, leaf = ".".join(path[:-1]), path[-1]
                try:
                    owner = model.get_submodule(mod_path)
                except AttributeError as e:
                    raise KeyError(f"{where}: no module {mod_path!r} in the port") from e
                name, t = _convert(owner, _RENAME.get((collection, leaf), leaf), arr, where)
                key = f"{mod_path}.{name}" if mod_path else name
                dst = targets.get(key)
                if dst is None:
                    raise KeyError(f"{where}: no parameter or buffer {key!r} in the port")
                if tuple(dst.shape) != tuple(t.shape):
                    raise ValueError(
                        f"{where}: shape {tuple(t.shape)} does not match {key} {tuple(dst.shape)}")
                dst.copy_(t.to(dst.device, dst.dtype))
                done.add(key)
    missing = sorted(set(targets) - done)
    if missing:
        raise KeyError(f"port parameters not set by the JAX variables: {missing[:10]}"
                       + (f" (+{len(missing) - 10} more)" if len(missing) > 10 else ""))
    reset_calibration(model)
    with torch.no_grad():
        for path, arr in _leaves(variables.get("quant_cache", {})):
            where = "/".join(("quant_cache",) + path)
            try:
                owner = model.get_submodule(".".join(path[:-1]))
                owner.load_act_scale(path[-1], np.asarray(arr, dtype=np.float32))
            except (AttributeError, KeyError) as e:
                raise KeyError(f"{where}: no int8 activation scale there in the port") from e
    return drop_inference_caches(model)

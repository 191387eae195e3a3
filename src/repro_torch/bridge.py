"""``repro`` parameters → the port's parameters, and back.

``repro.models.init_model`` returns a tree whose per-layer weights are
stacked along a leading L axis under ``"blocks"`` (and, for audio, under
``"encoder"/"blocks"``, with ``encoder_layers`` entries).
``params_from_repro`` takes that tree with numpy arrays for leaves (the
caller converts; this module imports no JAX), unstacks each L axis into
the port's list of per-layer dicts, keeps every weight's (in, out) layout
and casts each leaf to the dtype of the port's parameter template: the
Mamba2 leaves ``A_log``, ``D`` and ``dt_bias`` stay f32 as in ``repro``.
Leaves outside a ``"blocks"`` stack (the hybrid's one ``shared_attn``
block, ``vis_proj``, the encoder's ``pos`` and ``final_norm``) are not
stacked and map leaf to leaf.  It raises if any ``repro`` leaf is left
unconsumed, if any port parameter is left unset, or if a shape disagrees.
``params_to_repro`` is its inverse: any tree of the port's layout
(parameters, gradients, AdamW moments) as ``repro``'s stacked tree of
numpy arrays, for comparing the two packages leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_model


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def params_from_repro(tree: dict, cfg: ModelConfig, *,
                      device="cuda") -> dict:
    """The port's params for ``cfg`` from ``repro``'s ``init_model`` tree
    (numpy leaves), on ``device``."""
    dev = resolve_device(device)
    template = init_model(cfg, device="meta")
    src = _flatten(tree)
    used = set()

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, path + (i,)) for i, v in enumerate(node)]
        rpath, stack, layer = _tree.repro_path(path)
        if rpath not in src:
            raise KeyError(f"port parameter {'/'.join(map(str, path))} has "
                           f"no repro leaf {'/'.join(rpath)}")
        arr = np.asarray(src[rpath], np.float32)
        if stack is not None:
            n = cfg.encoder_layers if stack == ("encoder", "blocks") \
                else cfg.num_layers
            if arr.shape[0] != n:
                raise ValueError(f"repro leaf {'/'.join(rpath)} stacks "
                                 f"{arr.shape[0]} layers, config has {n}")
            arr = arr[layer]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: repro shape "
                             f"{arr.shape}, port shape {tuple(node.shape)}")
        used.add(rpath)
        return torch.tensor(arr, dtype=node.dtype, device=dev)

    params = fill(template, ())
    left = sorted("/".join(p) for p in set(src) - used)
    if left:
        raise ValueError(f"repro leaves not consumed by the port: {left}")
    return params


def params_to_repro(params: dict, cfg: ModelConfig) -> dict:
    """A tree of the port's layout (its parameters, or gradients or AdamW
    moments that mirror them) in ``repro``'s layout: each list of layers
    stacked leaf by leaf along a new leading L axis.  Leaves become numpy
    arrays, floats as float32.  Raises if a stack's length disagrees with
    the config."""
    def leaf(t):         # a copy: training updates the parameters in place
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy().copy()

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            n = cfg.encoder_layers if path == ("encoder", "blocks") \
                else cfg.num_layers
            if len(node) != n:
                raise ValueError(f"{'/'.join(path)} holds {len(node)} "
                                 f"layers, config has {n}")
            layers = [convert(v, path) for v in node]
            return _stack(layers)
        return leaf(node)

    return convert(params, ())


def _stack(layers: list):
    """Per-layer trees of numpy leaves → one tree of stacked leaves."""
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return np.stack(layers)

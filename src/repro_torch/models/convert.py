"""Weight conversion from the JAX reference's parameter tree.

torch cannot reproduce jax's PRNG, so parity runs carry the reference's
weights over instead of re-drawing them. The input is the reference's
params as a nested dict of numpy arrays (each layer stack — ``layers``,
or an encoder-decoder's ``enc_layers`` and ``dec_layers`` — carries a
leading L axis, as ``lax.scan`` consumes it); the output is the port's
layout (a list of per-layer dicts for each stack). bf16 arrays (numpy dtype name ``bfloat16``) go
through f32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import common as cm


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, i):
    return _map(tree, lambda a: np.asarray(a)[i])


def _is_stack(key: str, value) -> bool:
    return key.endswith("layers") and isinstance(value, dict)


def _n_layers(stack) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return np.asarray(stack).shape[0]


def params_from_reference(tree, *, device="cpu") -> dict:
    """Reference params (nested dict of numpy arrays) -> the port's params."""
    cm.set_matmul_precision()
    to = lambda a: _tensor(a, device)
    return {k: ([_map(_layer(v, i), to) for i in range(_n_layers(v))]
                if _is_stack(k, v) else _map(v, to))
            for k, v in tree.items()}

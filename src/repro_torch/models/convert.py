"""Weight conversion from the JAX reference's parameter tree.

torch cannot reproduce jax's PRNG, so parity runs carry the reference's
weights over instead of re-drawing them. The input is the reference's
params as a nested dict of numpy arrays (each layer stack — ``layers``,
or an encoder-decoder's ``enc_layers`` and ``dec_layers`` — carries a
leading L axis, as ``lax.scan`` consumes it); the output is the port's
layout (a list of per-layer dicts for each stack). bf16 arrays (numpy
dtype name ``bfloat16``) go through f32, which is exact.

:func:`pools_from_reference` carries the reference's decode pools over the
same way; fp8 codes (numpy dtype name ``float8_e4m3fn``) go through their
``uint8`` bits, which ``torch.from_numpy`` takes where it refuses the fp8
array itself.
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
    if a.dtype.name == "float8_e4m3fn":
        bits = np.ascontiguousarray(a).view(np.uint8)
        return torch.from_numpy(bits.copy()).view(torch.float8_e4m3fn).to(
            device)
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


def pools_from_reference(pools, *, device="cpu") -> dict:
    """The reference's decode pools (dict of numpy arrays: bf16, fp8_e4m3
    or int8 K/V codes, f32 scales, int32) -> the port's, bit for bit."""
    return {k: _tensor(a, device) for k, a in pools.items()}

"""The flat parameter vector and flat updater state, in the JAX package's
layout.

Reference: the ONE contiguous params vector of ``MultiLayerNetwork`` /
``ComputationGraph`` (``#params()``), the layout ModelSerializer's
coefficients depend on; counterpart of the JAX package's
``util/params.py``. The vector is the JAX package's, so a zip written by
either package restores in the other:

- params: the conf's key order (a MultiLayerNetwork's layers ascending, a
  graph's vertices in topological order), the layer's ``param_order()``
  inside a key, each tensor raveled in C order in the JAX package's layout
  (conv weights HWIO, dense weights ``[nIn, nOut]``; ``util.convert``);
- updater state: keys ascending (layer indices numerically, then names
  lexicographically), a key's params by name, a param's state keys by
  name. The JAX package's updater state holds its params in that sorted
  order after any training step, which is when it holds anything but
  zeros.

Everything here is host numpy at the boundary; ``unflatten_params`` and
``unflatten_state_like`` write a vector back into the port's tensors in
place.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.convert import (
    _layer_of,
    layer_params_to_jax,
    layout_perm,
)


def _key_sort(k: str):
    """Numeric keys (layer indices) ascending first, then names."""
    return (0, int(k), "") if k.isdigit() else (1, 0, k)


def _conf_keys(conf, params: Dict[str, dict]) -> List[str]:
    """The conf's params key order: a graph's topological order, else the
    layer indices ascending."""
    if hasattr(conf, "topo_order"):
        return [k for k in conf.topo_order() if k in params]
    return sorted(params, key=_key_sort)


def _param_owner(conf, key: str):
    """(the object whose ``param_order`` lists the key's params, the conf
    whose layout rules apply: the layer, or a vertex with params of its
    own)."""
    if hasattr(conf, "vertex_map"):
        return conf.vertex_map()[key].vertex, _layer_of(conf, key)
    layer = conf.layers[int(key)]
    return layer, layer


def _chunks(conf, params):
    """(port tensor, layer, name) in the flat vector's order."""
    for k in _conf_keys(conf, params):
        owner, layer = _param_owner(conf, k)
        for name in owner.param_order():
            if name in params[k]:
                yield params[k][name], layer, name


def flatten_params(conf, params: Dict[str, dict]) -> np.ndarray:
    """The port's params as the JAX package's 1-D vector."""
    chunks = [layer_params_to_jax(layer, {name: t})[name].ravel()
              for t, layer, name in _chunks(conf, params)]
    if not chunks:
        return np.zeros((0,), np.float32)
    return np.concatenate(chunks)


def _copy_chunk(t: torch.Tensor, layer, name, values: np.ndarray) -> None:
    """Write ``values`` (the JAX layout, raveled) into the port tensor
    ``t`` in place."""
    perm = layout_perm(layer, name, t.ndim)
    shape = tuple(t.shape) if perm is None else tuple(t.shape[i]
                                                      for i in perm)
    a = values.reshape(shape)
    if perm is not None:
        a = np.transpose(a, np.argsort(perm))
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def unflatten_params(conf, flat, params: Dict[str, dict]) -> Dict[str, dict]:
    """Copy the JAX-layout vector ``flat`` into ``params``' tensors in
    place (the reference's ``setParams`` length check first); returns
    ``params``."""
    flat = np.asarray(flat)
    if flat.ndim != 1:
        raise ValueError(
            f"flat params vector must be 1-D, got shape {flat.shape}")
    chunks = list(_chunks(conf, params))
    expected = sum(t.numel() for t, _, _ in chunks)
    if flat.shape[0] != expected:
        raise ValueError(
            f"flat params vector has {flat.shape[0]} values but the model "
            f"expects {expected} (reference: setParams length check)")
    pos = 0
    for t, layer, name in chunks:
        n = t.numel()
        _copy_chunk(t, layer, name, flat[pos:pos + n])
        pos += n
    return params


def _state_chunks(conf, opt_state):
    """(port tensor, layer, param name) per updater-state tensor in the
    flat state's order."""
    for k in sorted(opt_state, key=_key_sort):
        _, layer = _param_owner(conf, k)
        for pname in sorted(opt_state[k]):
            st = opt_state[k][pname]
            for sk in sorted(st):
                yield st[sk], layer, pname


def flatten_state_like(conf, opt_state: Dict[str, dict]) -> np.ndarray:
    """The port's updater state (``{key: {param: {name: tensor}}}``) as the
    JAX package's 1-D vector."""
    chunks = [layer_params_to_jax(layer, {pname: t})[pname].ravel()
              for t, layer, pname in _state_chunks(conf, opt_state)]
    if not chunks:
        return np.zeros((0,), np.float32)
    return np.concatenate(chunks)


def unflatten_state_like(conf, flat, opt_state: Dict[str, dict]
                         ) -> Dict[str, dict]:
    """Copy the JAX-layout updater-state vector ``flat`` into
    ``opt_state``'s tensors in place (the inverse of
    :func:`flatten_state_like`); returns ``opt_state``."""
    flat = np.asarray(flat)
    chunks = list(_state_chunks(conf, opt_state))
    expected = sum(t.numel() for t, _, _ in chunks)
    if flat.ndim != 1 or flat.size != expected:
        raise ValueError(f"flat state length {flat.size} != expected "
                         f"{expected}")
    pos = 0
    for t, layer, pname in chunks:
        n = t.numel()
        _copy_chunk(t, layer, pname, flat[pos:pos + n])
        pos += n
    return opt_state

"""Regex partition rules: param-path -> ``PartitionSpec``.

Counterpart of the JAX package's ``sharding/rules.py``: a rule table is an
ordered list of ``(regex, PartitionSpec)`` pairs matched against each
parameter's ``"layer/param"`` path (``"0/W"``, ``"res2a_branch2a/W"``, ...).
First match wins; scalars are never partitioned; a parameter no rule
covers raises with the nearest rule as a suggestion, and a rule wider than
the parameter's rank raises.

Specs are written in the reference's layouts (the JAX package's): dense
``[nIn, nOut]``, conv HWIO, attention projections ``[in, out]``, so one rule
table means the same split in both packages. :func:`reference_view` shows a
port network's params in those layouts (shapes only) for the rules to
match against, and :func:`storage_spec` maps a resolved spec onto the
port's storage (``util.convert.layout_perm``): ``P(None, "model")`` on a
``DenseLayer.W`` (``[nOut, nIn]`` here) shards its dim 0.

``create_opt_spec`` clones each parameter's spec onto its updater moment
buffers (Adam m/v, Nesterovs momentum, ...) while replicating scalar state,
so optimizer state always shards exactly like the parameters it tracks.

A spec is this module's :class:`PartitionSpec`, a tuple of mesh axis names
(or tuples of them, or None) printed as the JAX package prints its own.
"""

from __future__ import annotations

import dataclasses
import difflib
import re
from typing import List, Tuple

import numpy as np


class PartitionSpec(tuple):
    """One entry a dimension: a mesh axis name, a tuple of names, or None
    (replicated); fewer entries than dimensions replicate the rest."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickles as its entries
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A leaf's shape and dtype name, standing in for the tensor when a
    tree is viewed in another layout."""

    shape: tuple
    dtype: str = "float32"


def _dtype_name(leaf) -> str:
    """numpy's name of a leaf's dtype (``"float32"``, ``"bfloat16"``)."""
    return str(getattr(leaf, "dtype", "?")).replace("torch.", "")


def _items(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), v) for i, v in enumerate(node)]


def _is_container(node) -> bool:
    return isinstance(node, (dict, list)) or (
        isinstance(node, tuple) and not isinstance(node, PartitionSpec))


def _flatten(tree, prefix=()):
    """``[(key path, leaf)]`` in the JAX package's leaf order (dict keys
    sorted)."""
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _items(tree):
        out.extend(_flatten(v, prefix + (k,)))
    return out


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, flatten order)."""
    if not _is_container(tree):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return type(tree)(_rebuild(v, leaves) for v in tree)


def named_paths(tree, sep: str = "/") -> List[Tuple[str, object]]:
    """Flatten ``tree`` to ``[(path, leaf), ...]`` with ``sep``-joined key
    paths: the string the rule regexes are matched against."""
    return [(sep.join(path), leaf) for path, leaf in _flatten(tree)]


def named_paths_specs(specs, sep: str = "/"):
    """:func:`named_paths` over a spec tree (specs are leaves)."""
    return named_paths(specs, sep)


def normalize_rules(rules) -> List[Tuple[str, PartitionSpec]]:
    """Accept ``[(regex, spec), ...]`` with specs given as ``PartitionSpec``
    (this module's or any tuple) or plain strings / None; returns the
    canonical ``(str, PartitionSpec)`` list."""
    out = []
    for rule, spec in rules:
        if spec is None:
            spec = P()
        elif isinstance(spec, str):
            spec = P(spec)
        elif not isinstance(spec, PartitionSpec):
            spec = P(*spec)
        out.append((str(rule), spec))
    return out


def is_scalar(leaf) -> bool:
    """Scalars (and 1-element tensors) are never partitioned."""
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return True
    return len(shape) == 0 or int(np.prod(tuple(shape))) == 1


def _nearest_rule(path: str, rules) -> str:
    """The rule pattern most similar to ``path``: the error message's
    suggestion when nothing matched (a typo'd rule is the common case)."""
    if not rules:
        return ""
    scored = [(difflib.SequenceMatcher(None, path, pat).ratio(), pat)
              for pat, _ in rules]
    return max(scored)[1]


def match_partition_rules(rules, params, sep: str = "/"):
    """Resolve a rule table over a parameter tree.

    Returns a tree of ``PartitionSpec`` matching ``params``' structure.
    Scalar leaves get ``P()`` without consulting the table; every other
    leaf takes the FIRST rule whose regex ``re.search``-es its path. An
    unmatched parameter raises ``ValueError`` naming the path and the
    nearest rule (add a trailing ``(".*", P())`` catch-all for
    replicate-by-default behavior). A matched spec wider than the leaf's
    rank also raises: that placement could never be applied."""
    rules = normalize_rules(rules)
    specs = []
    for name, leaf in named_paths(params, sep):
        if is_scalar(leaf):
            specs.append(P())
            continue
        for pat, spec in rules:
            if re.search(pat, name) is not None:
                ndim = len(getattr(leaf, "shape", ()))
                if len(spec) > ndim:
                    raise ValueError(
                        f"partition rule {pat!r} -> {spec} has "
                        f"{len(spec)} axes but param '{name}' has rank "
                        f"{ndim}")
                specs.append(spec)
                break
        else:
            near = _nearest_rule(name, rules)
            hint = f"; nearest rule: {near!r}" if near else ""
            raise ValueError(
                f"no partition rule matches param '{name}'{hint} — add "
                f"a rule for it or a ('.*', PartitionSpec()) catch-all")
    return _rebuild(params, iter(specs))


def create_opt_spec(param_specs, opt_state):
    """Clone parameter specs onto updater state.

    ``param_specs``: the tree :func:`match_partition_rules` returned.
    ``opt_state``: the updater-state tree, which nests one level DEEPER
    than params (each param maps to a dict of moment buffers, or ``{}``
    for stateless updaters like SGD). Moment buffers (non-scalar leaves)
    inherit their parameter's spec; scalar state (step counters,
    accumulators) replicates."""
    def clone(spec, sub):
        return _rebuild(sub, iter(P() if is_scalar(leaf) else spec
                                  for _, leaf in _flatten(sub)))

    def rec(spec, st):
        if isinstance(spec, PartitionSpec):
            return clone(spec, st)
        return {k: rec(spec[k], v) for k, v in st.items()}

    return rec(param_specs, opt_state)


def spec_table(params, specs, sep: str = "/") -> List[dict]:
    """Side-by-side ``[{path, shape, dtype, spec}, ...]`` rows: the
    ``ShardingPlan.explain()`` payload."""
    rows = []
    for (path, leaf), (_, spec) in zip(named_paths(params, sep),
                                       named_paths_specs(specs, sep)):
        rows.append({
            "path": path,
            "shape": [int(d) for d in getattr(leaf, "shape", ())],
            "dtype": _dtype_name(leaf),
            "spec": str(spec),
        })
    return rows


def shard_factor(spec, mesh) -> int:
    """How many ways ``spec`` divides a tensor on ``mesh`` (the product of
    the named axes' sizes): the per-rank byte divisor."""
    n = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        for ax in axes:
            n *= int(mesh.shape[ax])
    return n


def _itemsize(leaf) -> int:
    dt = getattr(leaf, "dtype", np.float32)
    if hasattr(dt, "itemsize"):
        return int(dt.itemsize)
    name = _dtype_name(leaf)
    return 2 if name == "bfloat16" else int(np.dtype(name).itemsize)


def bytes_per_device(tree, specs, mesh) -> int:
    """Per-rank bytes of ``tree`` placed under ``specs`` (replicated leaves
    count full size on every rank; sharded leaves divide by the spec's
    shard factor, padding to the ceiling)."""
    total = 0
    for (_, leaf), (_, spec) in zip(named_paths(tree),
                                    named_paths_specs(specs)):
        shape = tuple(getattr(leaf, "shape", ()))
        size = int(np.prod(shape)) if shape else 1
        total += -(-size // shard_factor(spec, mesh)) * _itemsize(leaf)
    return total


# --------------------------------------------------------------------------
# the port's layouts
# --------------------------------------------------------------------------

def layer_confs(conf) -> dict:
    """{params key: the conf whose layout rules apply to it} of a
    ``MultiLayerConfiguration`` or ``ComputationGraphConfiguration``."""
    if hasattr(conf, "vertex_map"):
        out = {}
        for name, spec in conf.vertex_map().items():
            layer = getattr(spec.vertex, "layer", None)
            out[name] = spec.vertex if layer is None else layer
        return out
    return {str(i): layer for i, layer in enumerate(conf.layers)}


def _perm(layer, key: str, ndim: int):
    from deeplearning4j_tpu_torch.util.convert import layout_perm

    return None if layer is None else layout_perm(layer, key, ndim)


def reference_view(tree, conf, depth: int = 0):
    """``tree`` (params, or updater state one level deeper) with every
    leaf a :class:`Leaf` of its shape in the reference's layout."""
    layers = layer_confs(conf)

    def view(layer, key, sub):
        if isinstance(sub, dict):
            return {k: view(layer, key, v) for k, v in sub.items()}
        shape = tuple(int(d) for d in sub.shape)
        perm = _perm(layer, key, len(shape))
        if perm is not None:
            shape = tuple(shape[p] for p in perm)
        return Leaf(shape, _dtype_name(sub))

    return {k: {pk: view(layers.get(k), pk, v) for pk, v in vp.items()}
            for k, vp in tree.items()}


def storage_spec(spec, layer, key: str, ndim: int) -> PartitionSpec:
    """A reference-layout spec of ``layer``'s param ``key`` (rank
    ``ndim``) on the port's storage: reference dim ``i`` is storage dim
    ``perm[i]``."""
    perm = _perm(layer, key, ndim)
    entries = list(spec) + [None] * (ndim - len(spec))
    if perm is None:
        out = entries
    else:
        out = [None] * ndim
        for i, e in enumerate(entries):
            out[perm[i]] = e
    while out and out[-1] is None:
        out.pop()
    return P(*out)


__all__ = [
    "PartitionSpec",
    "match_partition_rules",
    "create_opt_spec",
    "named_paths",
    "normalize_rules",
    "is_scalar",
    "spec_table",
    "shard_factor",
    "bytes_per_device",
    "reference_view",
    "storage_spec",
]

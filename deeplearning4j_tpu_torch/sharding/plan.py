"""``ShardingPlan``: a resolved placement for one model on one mesh.

Counterpart of the JAX package's ``sharding/plan.py``. Composes a DPxTP
mesh (``data`` x ``model`` ranks, :mod:`parallel.mesh`) with a regex rule
table (:mod:`sharding.rules`) into what a training path needs:

- ``param_specs`` / ``opt_specs``: resolved ``PartitionSpec`` trees in the
  reference's layouts (moment buffers cloned from their parameter's spec);
  a port network (or its params with its ``conf``) is viewed in those
  layouts first, so the same table resolves the same way in both
  packages;
- ``storage_specs`` / ``opt_storage_specs``: the same specs on the port's
  storage, and ``place(...)`` to keep on this rank only its slice of each
  sharded leaf;
- ``cache_tag()``: a digest of (mesh shape, resolved spec tables) that keys
  the envelope cache (``optimize.aot_cache``) of the wrapper's plan step as
  ``pw_rules:<tag>``, as the JAX package keys its step executable; at one
  process it equals the JAX package's tag for the same mesh shape, rules
  and params;
- ``explain()``: the param-path -> spec table (and opt-state specs) as text
  or JSON, for the UI's ``/sharding`` endpoint and System tab;
- per-rank byte accounting (``param_bytes_per_device`` /
  ``opt_bytes_per_device``) published as the ``dl4j_shard_param_bytes`` /
  ``dl4j_shard_opt_bytes`` gauges.

Plans register themselves in a process-wide weak set on resolve;
``active_plans()`` / ``plans_summary()`` feed the UI server's ``/sharding``
endpoint and the System tab.
"""

from __future__ import annotations

import hashlib
import json
import threading
import weakref

import numpy as np

from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.sharding import rules as rules_mod
from deeplearning4j_tpu_torch.sharding.rules import P

_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()
_ACTIVE_LOCK = threading.Lock()


def active_plans():
    """Live (resolved) plans, oldest-registered first."""
    with _ACTIVE_LOCK:
        return sorted(_ACTIVE, key=lambda p: p._seq)


def plans_summary() -> list:
    """JSON-ready summaries of every live resolved plan (the UI System tab
    / ``/sharding`` payload)."""
    return [p.explain(fmt="json") for p in active_plans()]


_SEQ = [0]


def _net_parts(obj, conf):
    """``(params, opt_state or None, conf or None)`` of a network or a
    tree (with its ``conf``, if any)."""
    if hasattr(obj, "params") and hasattr(obj, "conf"):
        return obj.params, obj.opt_state, obj.conf
    return obj, None, conf


def _view(tree, conf):
    return tree if conf is None else rules_mod.reference_view(tree, conf)


class ShardingPlan:
    """A rule table bound to a DPxTP mesh.

    Usage::

        mesh = single_host_mesh(data=2, model=2)   # on 4 ranks
        plan = ShardingPlan(rules=[(r"W$", P(None, "model")),
                                   (r".*", P())], mesh=mesh)
        specs = plan.param_specs(net)            # the reference's layouts
        local = plan.place(net.params, plan.storage_specs(net))

    ``mesh=`` defaults to ``single_host_mesh(data=data, model=model)`` over
    the process group; any :class:`parallel.mesh.Mesh` works (one built
    as ``Mesh(data=2, data_rank=0, model=2)`` without ranks resolves, explains
    and keys a plan, but places nothing)."""

    def __init__(self, rules, mesh=None, data: int = -1, model: int = 1,
                 sep: str = "/", demote_indivisible: bool = False):
        self.rules = rules_mod.normalize_rules(rules)
        self.mesh = mesh if mesh is not None else mesh_mod.single_host_mesh(
            data=data, model=model)
        self.sep = sep
        # a matched dim whose size a mesh axis does not divide: strict plans
        # raise; demoting plans replicate THAT DIM and flag it in explain()
        self.demote_indivisible = bool(demote_indivisible)
        self._resolved = None       # (param_specs, opt_specs or None)
        self._tables = None         # explain() rows
        self._params_key = None     # resolution-cache keys
        self._opt_key = None
        with _ACTIVE_LOCK:
            _SEQ[0] += 1
            self._seq = _SEQ[0]

    # --- resolution ---------------------------------------------------------
    def _check_divisible(self, params, specs):
        """Every sharded dim must be divisible by its mesh axes' product;
        raise (strict) or demote the offending dim to replicated."""
        demoted = []
        fixed = []
        for (path, leaf), (_, spec) in zip(
                rules_mod.named_paths(params, self.sep),
                rules_mod.named_paths_specs(specs, self.sep)):
            shape = tuple(getattr(leaf, "shape", ()))
            out, changed = [], False
            for d, entry in enumerate(spec):
                if entry is None:
                    out.append(None)
                    continue
                factor = rules_mod.shard_factor(
                    P(tuple(entry) if isinstance(entry, (tuple, list))
                      else entry), self.mesh)
                if shape[d] % factor:
                    if not self.demote_indivisible:
                        raise ValueError(
                            f"param '{path}' dim {d} (size {shape[d]}) is "
                            f"not divisible by mesh axis {entry!r} (size "
                            f"{factor}); fix the rule or build the plan "
                            f"with demote_indivisible=True")
                    demoted.append(path)
                    out.append(None)
                    changed = True
                else:
                    out.append(entry)
            fixed.append(P(*out) if changed else spec)
        return rules_mod._rebuild(specs, iter(fixed)), demoted

    def _tree_key(self, tree):
        """Cheap resolution-cache key: per-leaf (path, shape, dtype)."""
        return tuple((p, tuple(getattr(leaf, "shape", ())),
                      rules_mod._dtype_name(leaf))
                     for p, leaf in rules_mod.named_paths(tree, self.sep))

    def param_specs(self, params, conf=None):
        """Rule table -> ``PartitionSpec`` tree in the reference's layouts.
        ``params``: a port network, its params with ``conf``, or any tree
        already in the reference's layouts. Cached per plan (keyed on the
        leaves' path / shape / dtype); a different structure
        re-resolves."""
        params, _, conf = _net_parts(params, conf)
        view = _view(params, conf)
        key = self._tree_key(view)
        if self._resolved is not None and self._params_key == key:
            return self._resolved[0]
        specs = rules_mod.match_partition_rules(self.rules, view,
                                                sep=self.sep)
        specs, demoted = self._check_divisible(view, specs)
        table = rules_mod.spec_table(view, specs, sep=self.sep)
        for row in table:
            if row["path"] in demoted:
                row["demoted"] = True
        self._tables = {"params": table, "opt": []}
        self._resolved = (specs, None)
        self._params_key = key
        self._opt_key = None
        with _ACTIVE_LOCK:
            _ACTIVE.add(self)
        return specs

    def opt_specs(self, params, opt_state=None, conf=None):
        """Parameter specs cloned onto updater state (scalar state
        replicated): ``rules.create_opt_spec``; cached like
        ``param_specs``. With a network, its own updater state."""
        params, own_opt, conf = _net_parts(params, conf)
        opt_state = own_opt if opt_state is None else opt_state
        pspecs = self.param_specs(params, conf)
        view = _view(opt_state, conf)
        key = self._tree_key(view)
        if self._resolved[1] is not None and self._opt_key == key:
            return self._resolved[1]
        ospecs = rules_mod.create_opt_spec(pspecs, view)
        self._tables["opt"] = rules_mod.spec_table(view, ospecs,
                                                   sep=self.sep)
        self._resolved = (pspecs, ospecs)
        self._opt_key = key
        return ospecs

    # --- the port's storage ----------------------------------------------------
    def storage_specs(self, net):
        """:meth:`param_specs` of ``net`` on the port's storage layouts
        (``net``: a network, or anything with ``params``, ``opt_state``
        and ``conf`` whose leaves have the whole storage shapes)."""
        pspecs = self.param_specs(net)
        layers = rules_mod.layer_confs(net.conf)
        return {k: {pk: rules_mod.storage_spec(
                    pspecs[k][pk], layers.get(k), pk, len(v.shape))
                    for pk, v in vp.items()}
                for k, vp in net.params.items()}

    def opt_storage_specs(self, net, opt_state=None):
        """:meth:`opt_specs` of ``net`` on the port's storage layouts."""
        opt_state = net.opt_state if opt_state is None else opt_state
        ospecs = self.opt_specs(net.params, opt_state, net.conf)
        layers = rules_mod.layer_confs(net.conf)

        def rec(layer, key, spec, sub):
            if isinstance(sub, dict):
                return {n: rec(layer, key, spec[n], v)
                        for n, v in sub.items()}
            return rules_mod.storage_spec(spec, layer, key, len(sub.shape))

        return {k: {pk: rec(layers.get(k), pk, ospecs[k][pk], st)
                    for pk, st in vp.items()}
                for k, vp in opt_state.items()}

    def slice_of(self, shape, spec, coords=None):
        """This rank's (or the rank at ``coords``') index box of a tensor of
        ``shape`` under a storage ``spec``: a tuple of slices."""
        coords = coords or {a: self.mesh.index(a)
                            for a in self.mesh.axis_names}
        box = []
        for d, n in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            if entry is None:
                box.append(slice(0, n))
                continue
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            parts, idx = 1, 0
            for ax in axes:
                size = int(self.mesh.shape[ax])
                idx, parts = idx * size + coords.get(ax, 0), parts * size
            step = n // parts
            box.append(slice(idx * step, (idx + 1) * step))
        return tuple(box)

    def place(self, tree, specs):
        """This rank's slice of every leaf of ``tree`` under storage
        ``specs`` (a replicated leaf is returned as it is; a slice is a
        contiguous copy)."""
        def cut(t, spec):
            if not any(e is not None for e in spec):
                return t
            return t[self.slice_of(t.shape, spec)].contiguous()

        if isinstance(specs, P):
            return cut(tree, specs)
        return {k: self.place(tree[k], specs[k]) for k in tree}

    # --- cache keys ---------------------------------------------------------
    def cache_tag(self) -> str:
        """Digest of (mesh axis sizes, resolved spec tables): the envelope
        cache's sharding key component. Requires a prior ``param_specs``
        resolve. On ranks, the process count joins the digest (as the JAX
        package keys a multi-process plan), so one process's tag equals
        the JAX package's for the same mesh shape, rules and params."""
        if self._tables is None:
            raise ValueError("cache_tag() before param_specs() — the tag "
                             "keys the RESOLVED table")
        from deeplearning4j_tpu_torch.comms import scheduler

        mesh_sig = tuple((a, int(self.mesh.shape[a]))
                         for a in self.mesh.axis_names)
        procs = scheduler.world_of()
        sig = [mesh_sig, self._tables["params"], self._tables["opt"]]
        if procs > 1:
            sig.append(["processes", procs])
        payload = json.dumps(sig, sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    # --- accounting ---------------------------------------------------------
    def param_bytes_per_device(self, params, conf=None) -> int:
        params, _, conf = _net_parts(params, conf)
        return rules_mod.bytes_per_device(
            _view(params, conf), self.param_specs(params, conf), self.mesh)

    def opt_bytes_per_device(self, params, opt_state=None, conf=None) -> int:
        params, own_opt, conf = _net_parts(params, conf)
        opt_state = own_opt if opt_state is None else opt_state
        return rules_mod.bytes_per_device(
            _view(opt_state, conf),
            self.opt_specs(params, opt_state, conf), self.mesh)

    def publish_metrics(self, params, opt_state=None, conf=None,
                        device=None) -> dict:
        """Set the per-rank shard-byte gauges from this plan's resolved
        placement; returns ``{param_bytes, opt_bytes}``."""
        from deeplearning4j_tpu_torch import telemetry

        params, own_opt, conf = _net_parts(params, conf)
        opt_state = own_opt if opt_state is None else opt_state
        pb = self.param_bytes_per_device(params, conf)
        ob = (self.opt_bytes_per_device(params, opt_state, conf)
              if opt_state is not None else 0)
        telemetry.record_shard_bytes(pb, ob, device)
        return {"param_bytes": pb, "opt_bytes": ob}

    # --- debugging surface --------------------------------------------------
    def explain(self, fmt: str = "text"):
        """The resolved param-path -> PartitionSpec table (+ opt-state spec
        rows) as ``"text"`` or ``"json"``. An unresolved plan explains its
        rule table only."""
        mesh_shape = {a: int(self.mesh.shape[a])
                      for a in self.mesh.axis_names
                      if int(self.mesh.shape[a]) > 1}
        data = {
            "mesh": mesh_shape,
            "devices": int(np.prod([int(self.mesh.shape[a])
                                    for a in self.mesh.axis_names])),
            "rules": [[pat, str(spec)] for pat, spec in self.rules],
            "params": (self._tables or {}).get("params", []),
            "opt_state": (self._tables or {}).get("opt", []),
        }
        if fmt == "json":
            return data
        lines = [f"ShardingPlan mesh={mesh_shape or '{1 device}'} "
                 f"rules={len(self.rules)}"]
        if data["params"]:
            w = max(5, max(len(r["path"]) for r in data["params"]))
            lines.append(f"  {'param'.ljust(w)}  shape           spec")
            for r in data["params"]:
                shp = "x".join(map(str, r["shape"])) or "scalar"
                lines.append(
                    f"  {r['path'].ljust(w)}  {shp.ljust(14)}  {r['spec']}")
        else:
            for pat, spec in self.rules:
                lines.append(f"  rule {pat!r} -> {spec}")
        if data["opt_state"]:
            lines.append(f"  opt-state: {len(data['opt_state'])} buffers "
                         f"(specs cloned from params; scalars replicated)")
        return "\n".join(lines)

    def __repr__(self):
        shape = {a: int(self.mesh.shape[a]) for a in self.mesh.axis_names
                 if int(self.mesh.shape[a]) > 1}
        return (f"ShardingPlan(rules={len(self.rules)}, mesh={shape}, "
                f"resolved={self._tables is not None})")

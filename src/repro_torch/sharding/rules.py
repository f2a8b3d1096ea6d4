"""Sharding rules: param specs, activation constraints, cache specs (the
port of ``repro.sharding.rules``), on DTensor.

Scheme, as in the reference (MaxText-style FSDP x TP x SP):
  * weights: TP over "model" on the head/ffn/vocab dim, FSDP over the data
    axes (+"pod") on the other dim;
  * activations at layer boundaries: batch over (pod, data), sequence over
    "model" (sequence parallelism);
  * decode: batch over data axes, KV-cache sequence over "model";
    uneven dims automatically drop axes.

A spec (:class:`Spec`) has one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of names that split the dim major to minor.
:func:`placements` turns it into DTensor placements over a
``DeviceMesh`` whose dims carry the reference's axis names in the
reference's order (("pod",) "data", "model"): DTensor splits a dim sharded
over several mesh dims in mesh-dim order, which is then the tuple's order.

The rules need only the mesh's axis names and sizes (:class:`MeshShape`
stands in for a ``DeviceMesh`` where no ranks exist); placing a tensor
needs a ``DeviceMesh``. ``constrain`` is the identity unless a sharding
scope is active, so single-device runs execute the exact same model code.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

_ACTIVE: Dict[str, Any] = {"rules": None}


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis is
    that axis, an empty tuple ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class Spec(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name or
    a tuple of axis names). Equal, entry for entry, to the tuple of the
    reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices (the reference's
    ``AbstractMesh``): enough to compute specs."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def placements(spec: Sequence, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim of more than one rank named in entry d, ``Replicate()`` on the
    others (a split over one rank is no split, and DTensor's views refuse
    some ops on it). A tuple entry must list its axes in the mesh's order
    (DTensor's split order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = tuple(mesh.shape)
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: Sequence):
    """``t`` as a DTensor laid out by ``spec``: a plain tensor is the global
    value every rank holds (each rank keeps its block, no communication),
    a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements(spec, mesh))
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements(spec, mesh))


def place(tree, mesh, specs):
    """Every leaf of ``tree`` distributed by the matching leaf of
    ``specs`` (nested dicts, as the rules' ``*_shardings`` give)."""
    if isinstance(tree, dict):
        return {k: place(v, mesh, specs[k]) for k, v in tree.items()}
    return distribute(tree, mesh, specs)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full(t):
    """The global value of a DTensor (gathered on every rank), or ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def _map_paths(fn, tree, prefix=()):
    return {k: (_map_paths(fn, v, prefix + (str(k),)) if isinstance(v, dict)
                else fn(prefix + (str(k),), v)) for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                    # DeviceMesh or MeshShape
    dp: Tuple[str, ...]          # data-parallel axes, e.g. ("pod", "data")
    tp: Optional[str] = "model"  # None => DP-only strategy (tp axis folded
    fsdp: bool = True            #          into dp by make_rules)
    seq_shard: bool = True

    # ---- helpers -----------------------------------------------------------
    def _fit(self, spec_entries, shape) -> Spec:
        """Drop axes that do not divide their dim; tuples fall back to the
        longest prefix that divides; pad leading None."""
        entries = list(spec_entries)
        pad = len(shape) - len(entries)
        entries = [None] * pad + entries
        out = []
        for dim, ax in zip(shape, entries):
            if ax is None:
                out.append(None)
            elif isinstance(ax, str):
                out.append(ax if dim % _axsize(self.mesh, ax) == 0 else None)
            else:  # tuple of axes: longest divisible prefix
                axes = list(ax)
                while axes and dim % _axsize(self.mesh, tuple(axes)) != 0:
                    axes.pop()
                out.append(tuple(axes) if axes else None)
        return Spec(*out)

    def placements(self, spec: Sequence) -> Tuple:
        return placements(spec, self.mesh)

    @property
    def fsdp_ax(self):
        return self.dp if self.fsdp else None

    # ---- activations -------------------------------------------------------
    def act_spec(self, name: str, shape) -> Optional[Spec]:
        dp = self.dp
        if name == "act":          # (B, S, D)
            seq = self.tp if self.seq_shard else None
            return self._fit([dp, seq, None], shape)
        if name == "act_full":     # (B, S, D) replicated over tp (pre-AG)
            return self._fit([dp, None, None], shape)
        if name == "act_decode":   # (B, 1, D)
            return self._fit([dp, None, None], shape)
        if name == "qkv":          # (B, S, H, hd) -- heads model-sharded
            return self._fit([dp, None, self.tp, None], shape)
        if name == "kv_small":     # (B, S, K, hd) -- replicated over tp
            return self._fit([dp, None, None, None], shape)
        if name == "moe_buf":      # (E, C, D)
            return self._fit([self.tp, dp, None], shape)
        if name == "moe_flat":     # (N*K, D) dispatch/combine intermediates
            return self._fit([dp, None], shape)
        if name == "moe_1d":       # (N*K,) routing metadata
            return self._fit([dp], shape)
        if name == "moe_group":    # (G, n_loc, D) -- G aligned to dp shards
            return self._fit([dp, None, None], shape)
        if name == "moe_g1":       # (G, n) routing metadata per group
            return self._fit([dp] + [None] * (len(shape) - 1), shape)
        if name == "moe_gbuf":     # (G, E, C_loc, D)
            return self._fit([dp, self.tp, None, None], shape)
        if name in ("moe_w_in", "moe_w_out"):
            # compute layout for expert weights: never contracted-dim-sharded
            E = shape[0]
            if E % _axsize(self.mesh, self.tp or ()) == 0 and self.tp:
                return self._fit([self.tp, None, None], shape)
            if name == "moe_w_in":   # (E, D, F): F over tp
                return self._fit([None, None, self.tp], shape)
            return self._fit([None, self.tp, None], shape)
        if name == "ssm_inner":    # (B, S, H, P) -- ssd heads model-sharded
            return self._fit([dp, None, self.tp, None], shape)
        if name == "ssm_conv":     # (B, S, C) -- conv channels model-sharded
            return self._fit([dp, None, self.tp], shape)
        if name == "ssm_dt":       # (B, S, H)
            return self._fit([dp, None, self.tp], shape)
        if name == "ssm_bc":       # (B, S, N) -- shared across heads
            return self._fit([dp, None, None], shape)
        if name == "rec_inner":    # (B, S, W) -- lru width model-sharded
            return self._fit([dp, None, self.tp], shape)
        if name == "logits":       # (B, V) or (B, S, V)
            return self._fit([dp] + [None] * (len(shape) - 2) + [self.tp],
                             shape)
        return None

    # ---- parameters ----------------------------------------------------------
    def param_spec(self, path_names: Sequence[str], shape) -> Spec:
        tp, fs = self.tp, self.fsdp_ax
        last = path_names[-1]
        parent = path_names[-2] if len(path_names) > 1 else ""
        if last == "embed":
            return self._fit([tp, fs], shape)
        if last == "lm_head":
            return self._fit([fs, tp], shape)
        if last in ("norm", "norm2", "final_norm", "norm_scale", "conv_b",
                    "A_log", "D", "dt_bias", "lam", "conv_xb", "conv_Bb",
                    "conv_Cb"):
            return self._fit([None] * len(shape), shape)
        if parent == "attn":
            if last in ("wq", "wk", "wv"):
                return self._fit([fs, tp], shape)
            if last == "wo":
                return self._fit([tp, fs], shape)
        if parent == "moe":
            if last == "router":
                return self._fit([fs, None], shape)
            # (E, D, F) / (E, F, D): experts over tp when divisible, else
            # inner ffn dim over tp.
            E = shape[-3]
            if E % _axsize(self.mesh, tp) == 0:
                if last in ("w_in", "w_gate"):
                    return self._fit([tp, fs, None], shape)
                return self._fit([tp, None, fs], shape)
            if last in ("w_in", "w_gate"):
                return self._fit([None, fs, tp], shape)
            return self._fit([None, tp, fs], shape)
        if parent == "mlp":
            if last in ("w_in", "w_gate"):
                return self._fit([fs, tp], shape)
            return self._fit([tp, fs], shape)
        if parent == "ssm":
            if last in ("w_z", "w_x"):
                return self._fit([fs, tp], shape)
            if last in ("w_B", "w_C", "w_dt"):
                return self._fit([fs, None], shape)
            if last == "w_out":
                return self._fit([tp, fs], shape)
            if last == "conv_xw":
                return self._fit([None, tp], shape)
            if last in ("conv_Bw", "conv_Cw"):
                return self._fit([None, None], shape)
        if parent == "rec":
            if last in ("w_x", "w_gate", "w_rg", "w_ig"):
                return self._fit([fs, tp], shape)
            if last == "w_out":
                return self._fit([tp, fs], shape)
            if last == "conv_w":
                return self._fit([None, tp], shape)
        return self._fit([None] * len(shape), shape)

    def param_shardings(self, params_tree):
        """The tree of param specs (leaves: tensors or anything with
        ``.shape``)."""
        return _map_paths(lambda names, leaf: self.param_spec(
            names, tuple(leaf.shape)), params_tree)

    def opt_shardings(self, params_tree):
        """ZeRO-1: optimizer moments additionally sharded over the data axes
        on the first dim not already sharded (no-op when fsdp already shards
        params)."""
        def one(names, leaf):
            shape = tuple(leaf.shape)
            spec = list(self.param_spec(names, shape))
            spec += [None] * (len(shape) - len(spec))
            if not self.fsdp:
                used = {a for e in spec if e
                        for a in ((e,) if isinstance(e, str) else e)}
                free = tuple(a for a in self.dp if a not in used)
                if free:
                    for i, (dim, e) in enumerate(zip(shape, spec)):
                        if e is None and dim % _axsize(self.mesh, free) == 0:
                            spec[i] = free
                            break
            return Spec(*spec)
        return _map_paths(one, params_tree)

    # ---- caches --------------------------------------------------------------
    def cache_spec(self, path_names: Sequence[str], shape) -> Spec:
        last = path_names[-1]
        dp = self.dp
        if (last in ("k", "v", "k_scale", "v_scale")
                or last.endswith(("_k", "_v"))):
            # (U, B, S, K, hd) or (B, S, K, hd)
            return self._fit([dp, self.tp, None, None], shape)
        if last == "state":
            # ssm (U,B,H,N,P) / rec (U,B,W)
            if len(shape) >= 4:
                return self._fit([dp, self.tp, None, None], shape)
            return self._fit([dp, self.tp], shape)
        if last.startswith("conv"):
            return self._fit([dp, None, self.tp], shape)
        return self._fit([None] * len(shape), shape)

    def cache_shardings(self, cache_tree):
        return _map_paths(lambda names, leaf: self.cache_spec(
            names, tuple(leaf.shape)), cache_tree)

    # ---- batch inputs ----------------------------------------------------------
    def input_sharding(self, shape, kind: str = "tokens") -> Spec:
        if kind in ("tokens", "labels"):
            return self._fit([self.dp, None], shape)
        if kind in ("prefix", "frames"):
            return self._fit([self.dp, None, None], shape)
        if kind == "token":
            return self._fit([self.dp, None], shape)
        return Spec()

    # ---- placing trees ---------------------------------------------------------
    def place_params(self, params, specs=None):
        return place(params, self.mesh,
                     specs if specs is not None
                     else self.param_shardings(params))

    def place_cache(self, cache):
        return place(cache, self.mesh, self.cache_shardings(cache))

    def place_batch(self, batch: Dict[str, torch.Tensor]):
        """Each input of a batch (the same global batch on every rank)
        distributed by :meth:`input_sharding`; "pos" and other scalars
        replicated."""
        return {k: distribute(v, self.mesh,
                              self.input_sharding(tuple(v.shape), k)
                              if v.dim() else Spec())
                for k, v in batch.items()}


def make_rules(mesh, *, fsdp: bool = True, seq_shard: bool = True,
               tp_enabled: bool = True) -> ShardingRules:
    """tp_enabled=False gives the DP-only strategy: the "model" axis joins
    the data axes (right choice for small models where TP is pure overhead)."""
    names = axis_names(mesh)
    if tp_enabled:
        dp = tuple(a for a in names if a != "model")
        return ShardingRules(mesh=mesh, dp=dp, tp="model", fsdp=fsdp,
                             seq_shard=seq_shard)
    return ShardingRules(mesh=mesh, dp=names, tp=None, fsdp=fsdp,
                         seq_shard=False)


_STRATEGIES: Dict[str, bool] = {"registered": False}


def _register_strategies() -> None:
    """Give DTensor a sharding strategy for ``aten.flip``, which a backward
    decomposition reaches: some torch versions have none and refuse the op
    on any DTensor. The strategy is the whole tensor only, which is right
    whatever dims a call flips (the model itself never flips)."""
    if _STRATEGIES["registered"]:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.flip.default)
    def _flip(x, dims):
        return [([Replicate()], [Replicate(), None])]
    _STRATEGIES["registered"] = True


@contextlib.contextmanager
def sharding_scope(rules: Optional[ShardingRules]):
    """Activate ``rules`` for :func:`constrain` / :func:`dp_world`. Inside a
    scope with rules, a plain tensor that meets a DTensor in an op is taken
    as the replicated global value every rank holds (DTensor's implicit
    replication): the model's own tables, masks and ``arange``s."""
    prev = _ACTIVE["rules"]
    _ACTIVE["rules"] = rules
    try:
        if rules is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            _register_strategies()
            with implicit_replication():
                yield
    finally:
        _ACTIVE["rules"] = prev


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Outside a scope: ``x``. Inside: ``x`` redistributed to the act spec
    ``name`` gives its shape. A plain tensor there is the replicated global
    value every rank holds, and is distributed as such (no communication:
    each rank keeps its block)."""
    rules: Optional[ShardingRules] = _ACTIVE["rules"]
    if rules is None:
        return x
    s = rules.act_spec(name, tuple(x.shape))
    if s is None:
        return x
    return distribute(x, rules.mesh, s)


def dp_world() -> int:
    """Size of the data axes of the active sharding scope (1 outside)."""
    rules: Optional[ShardingRules] = _ACTIVE["rules"]
    if rules is None:
        return 1
    return _axsize(rules.mesh, rules.dp)


def _resolve(numel: int, shape) -> Tuple[int, ...]:
    shape = list(shape)
    if -1 in shape:
        known = 1
        for n in shape:
            if n != -1:
                known *= n
        shape[shape.index(-1)] = numel // known
    return tuple(shape)


def _reshape_dt(x, shape: Tuple[int, ...]):
    """A DTensor's view: DTensor's own where its sharding propagation takes
    it, else on each rank's block after the dims the view changes are made
    whole (the leading dims it keeps stay split)."""
    try:
        return x.reshape(*shape)
    except RuntimeError:
        pass
    from torch.distributed.tensor import DTensor, Replicate
    keep = 0
    for a, b in zip(x.shape, shape):
        if a != b:
            break
        keep += 1
    pl = [p if not p.is_shard() or p.dim < keep else Replicate()
          for p in x.placements]
    xl = _local_of(x.redistribute(x.device_mesh, pl))
    lshape = tuple(xl.shape[:keep]) + tuple(shape[keep:])
    return DTensor.from_local(xl.reshape(*lshape).contiguous(),
                              x.device_mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


class _Reshape(torch.autograd.Function):
    """:func:`_reshape_dt` whose backward first lays the gradient out as
    the forward's output was, so the inverse view is one that works
    (DTensor refuses to unflatten a gradient split on a dim the forward
    merged)."""

    @staticmethod
    def forward(ctx, x, shape):
        y = _reshape_dt(x, shape)
        ctx.in_shape, ctx.out_pl = tuple(x.shape), tuple(y.placements)
        return y

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            from torch.distributed.tensor import Replicate
            # a pending sum's gradient is whole on every rank
            pl = [Replicate() if p.is_partial() else p for p in ctx.out_pl]
            g = g.redistribute(g.device_mesh, pl)
            return _reshape_dt(g, ctx.in_shape), None
        return g.reshape(ctx.in_shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``, also for a DTensor whose layout the view
    cannot keep (DTensor refuses to split or merge a sharded dim unevenly,
    where GSPMD would move data): such a DTensor first gives up its shards
    on the dims the view changes, keeping those on the leading dims it
    leaves alone, and so does its gradient."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, _resolve(x.numel(), shape))


def one_split_a_dim(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with each tensor dim split over one mesh dim at most (the
    minor one of a tuple entry; the others made whole), a plain tensor as
    it is. For index lookups, which some torch versions refuse on a dim
    split over two mesh dims (the batch over ("pod", "data"))."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl, seen = list(x.placements), set()
    for i in reversed(range(len(pl))):
        if pl[i].is_shard():
            if pl[i].dim in seen:
                pl[i] = Replicate()
            seen.add(pl[i].dim if pl[i].is_shard() else None)
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A DTensor with no shard left on ``dims`` and no pending sum (each
    gathered or reduced), its other shards kept; a plain tensor as it is.
    For ops whose sharded form DTensor gets wrong or refuses (a gather
    along a sharded dim, an in-place write into one)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    nd = x.dim()
    dims = {d % nd for d in dims}
    pl = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims)
          else p for p in x.placements]
    if list(pl) == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def local(fn, args: Sequence, outs: Sequence):
    """``fn`` on each rank's own blocks of ``args``: the reference's
    ``vmap`` over the groups a data shard holds. Outside a scope it is
    ``fn(*args)``. Inside, each DTensor argument is given to ``fn`` as its
    local tensor (placed as the caller constrained it), and each output
    of ``fn`` comes back by its entry of ``outs``: ``None`` leaves it local
    (metadata a later ``local`` reads), ``(name, global shape)`` makes it a
    DTensor laid out by that act spec, ``("sum", global shape)`` a DTensor
    whose local values sum over the mesh dims that shard the first DTensor
    argument. Autograd runs through both ends. Returns a tuple."""
    rules: Optional[ShardingRules] = _ACTIVE["rules"]
    if rules is None:
        res = fn(*args)
        return tuple(res) if isinstance(res, (tuple, list)) else (res,)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    first = next(a for a in args if is_dtensor(a))
    res = fn(*[_local_of(a) if is_dtensor(a) else a for a in args])
    res = tuple(res) if isinstance(res, (tuple, list)) else (res,)
    out = []
    for r, o in zip(res, outs):
        if o is None:
            out.append(r)
            continue
        name, shape = o
        if name == "sum":
            pl = [Partial() if p.is_shard() else Replicate()
                  for p in first.placements]
        else:
            pl = placements(rules.act_spec(name, tuple(shape)), rules.mesh)
        out.append(DTensor.from_local(r.contiguous(), rules.mesh, pl,
                                      run_check=False,
                                      shape=torch.Size(shape),
                                      stride=_contiguous_stride(shape)))
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    DTensor takes its local gradient's strides for its own, and the view
    ops of its backward refuse a permuted one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_of(x):
    """A DTensor's local tensor, differentiable, its gradient contiguous."""
    return _ContiguousGrad.apply(x.to_local())


def _contiguous_stride(shape) -> Tuple[int, ...]:
    st, acc = [], 1
    for n in reversed(tuple(shape)):
        st.append(acc)
        acc *= n
    return tuple(reversed(st))


def write_slot(t: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``t[:, slot] = value[:, 0]`` in place: one decode step's entry of a
    cache laid out (B, S, ...). On a DTensor (the cache's sequence dim may
    be split over the model axis) ``value`` is first laid out as ``t`` is
    on every other dim, and each rank writes its own rows if its block of
    the sequence holds ``slot``."""
    if not is_dtensor(t):
        t[:, slot] = value[:, 0].to(t.dtype)
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = [Replicate() if p.is_shard() and p.dim == 1 else p
          for p in t.placements]
    v = distribute(value, t.device_mesh, ()) if not is_dtensor(value) \
        else value
    v = v.redistribute(t.device_mesh, pl).to_local()
    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    lo = slot - off[1]
    if 0 <= lo < shape[1]:
        t.to_local()[:, lo] = v[:, 0].to(t.dtype)

"""Meshes and sharding specs on one controller.

The port of the reference's ``src/repro/distributed/sharding.py``.

**The specs** (``spec_for``, ``param_specs``, ``batch_specs``,
``cache_specs``, ``state_specs``, ``DP``) are the reference's rule table
and functions, leaf for leaf: FSDP over ``data`` (every weight also
sharded on a non-TP dim) x TP over ``model`` (heads, ffn, experts, vocab)
x DP over ``pod`` + ``data``; decode KV caches shard their sequence axis
over ``model`` (the split-KV decode).  An axis that does not divide its
dim is dropped (replication instead of an error), so one table serves
all ten architectures.  ``P`` is the reference's ``PartitionSpec`` (one
mesh axis, a tuple of them, or None per dim) and ``NamedSharding`` pairs
it with a ``Mesh``.

**The mesh** is the control plane's: one process and a set of
``torch.device``s, no process group (the reference is a single
controller).  ``Mesh`` is the reference's named N-D mesh (a numpy array
of devices and its ``axis_names``); a device may repeat, and repeated
devices are logical shards of one device.  ``place(tree, shardings)`` is the counterpart of
``jax.device_put(tree, shardings)``: each leaf becomes a
``ShardedTensor``, one shard per mesh position in separate storage on
that position's device (replicas too); ``gather`` assembles the whole
tensor again, bit for bit.

**The control plane's** 1-D ``ShardMesh`` and ``control_plane_mesh`` are
the reference's ``("shards",)`` mesh: a tuple of devices the sharded
window pipeline (``core.shard_pipeline``) issues each shard's work under,
moving the per-shard summaries to the first device itself.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch

from repro_torch.costs import moved
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map, tree_map_with_path

__all__ = ["DP", "Mesh", "NamedSharding", "P", "ShardMesh", "ShardedTensor",
           "batch_specs", "cache_specs", "control_plane_mesh",
           "device_bytes", "gather", "param_specs", "place", "shard_blocks",
           "shard_slices", "spec_for", "state_specs"]


class P(tuple):
    """A partition spec: per tensor dim a mesh axis name, a tuple of them
    (the dim split over their product, the first major) or None."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named N-D mesh: ``devices`` a numpy array of ``torch.device``s
    (repeats allowed: logical shards), one ``axis_names`` entry a dim."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        flat = np.empty(devs.size, dtype=object)
        flat[:] = [torch.device(d) for d in devs.reshape(-1)]
        devs = flat.reshape(devs.shape)
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or not devs.size:
            raise ValueError(f"mesh of shape {devs.shape} needs one axis "
                             f"name a dim, got {names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @classmethod
    def of(cls, device, shape: tuple[int, ...], axis_names) -> "Mesh":
        """``prod(shape)`` logical shards of one device."""
        devs = np.empty(int(np.prod(shape)), dtype=object)
        devs[:] = [torch.device(device)] * devs.size
        return cls(devs.reshape(shape), tuple(axis_names))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: P


def DP(mesh) -> tuple[str, ...] | str:
    names = mesh.axis_names
    axes = tuple(a for a in ("pod", "data") if a in names)
    return axes if len(axes) > 1 else axes[0]


# (path regex, per-dim mesh axes).  First match wins.  Paths look like
# "layers/attn/wq", "layers/mlp/w_gate", "embed", "shared_attn/attn/wo" ...
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",                   ("model", "data")),
    (r"lm_head$",                 (None, "model")),
    # attention (stacked layers get a leading None automatically)
    (r"attn/wq$",                 ("data", "model")),
    (r"attn/wk$",                 ("data", "model")),
    (r"attn/wv$",                 ("data", "model")),
    (r"attn/wo$",                 ("model", "data")),
    (r"cross/wq$",                ("data", "model")),
    (r"cross/wk$",                ("data", "model")),
    (r"cross/wv$",                ("data", "model")),
    (r"cross/wo$",                ("model", "data")),
    (r"attn/wq_a$",               ("data", "model")),
    (r"attn/wq_b$",               ("data", "model")),
    (r"attn/wkv_a$",              ("data", None)),
    (r"attn/wkv_b$",              ("data", "model")),
    (r"attn/(q_norm|k_norm|q_a_norm|kv_a_norm)$", (None,)),
    # dense / shared-expert FFN
    (r"mlp/w_gate$",              ("data", "model")),
    (r"mlp/w_up$",                ("data", "model")),
    (r"mlp/w_down$",              ("model", "data")),
    (r"mlp/shared_gate$",         ("data", "model")),
    (r"mlp/shared_up$",           ("data", "model")),
    (r"mlp/shared_down$",         ("model", "data")),
    # MoE experts: EP over model, FSDP over data
    (r"mlp/router$",              ("data", None)),
    (r"mlp/w_gate_e|experts",     ("model", "data", None)),
    # mamba2
    (r"mixer/in_proj$",           ("data", "model")),
    (r"mixer/conv_w$",            (None, "model")),
    (r"mixer/conv_b$",            ("model",)),
    (r"mixer/(A_log|D|dt_bias)$", ("model",)),
    (r"mixer/out_proj$",          ("model", "data")),
    (r"mixer/norm$",              ("model",)),
    # norms and everything small: replicate
    (r"(ln1|ln2|ln_x|final_norm|enc_norm|norm)$", None),
]

# MoE expert tensors are 3-D [E, d, ff] under stacked layers -> 4-D.
_MOE_EXPERT = re.compile(r"mlp/w_(gate|up|down)$")


def spec_for(path_str: str, shape: tuple[int, ...], mesh) -> P:
    """Resolve the rule table for one leaf, with divisibility fallback.
    Reads only ``mesh.axis_names`` and ``mesh.devices.shape``."""
    stacked = path_str.startswith(("layers/", "enc_layers/"))
    axes_by_name = dict(zip(mesh.axis_names, mesh.devices.shape))

    dims: tuple | None = None
    # distinguish expert tensors (rank 3 + stacking) from dense mlp (rank 2)
    rank = len(shape) - (1 if stacked else 0)
    if _MOE_EXPERT.search(path_str) and rank == 3:
        name = path_str.rsplit("/", 1)[-1]
        if name == "w_down":
            dims = ("model", None, "data")
        else:
            dims = ("model", "data", None)
    else:
        for pat, d in _PARAM_RULES:
            if re.search(pat, path_str):
                dims = d
                break
    if dims is None:
        return P()
    if stacked:
        dims = (None, *dims)
    dims = tuple(dims[:len(shape)]) + (None,) * (len(shape) - len(dims))
    # divisibility fallback: replicate dims the mesh axis cannot divide
    fixed = []
    for size, ax in zip(shape, dims):
        if ax is None:
            fixed.append(None)
        elif size % axes_by_name.get(ax, 1) == 0:
            fixed.append(ax)
        else:
            fixed.append(None)
    return P(*fixed)


def param_specs(params, mesh):
    """Tree of NamedShardings matching a param tree (or its shapes)."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_for(path,
                                                        tuple(leaf.shape),
                                                        mesh)), params)


def _div_ok(n: int, mesh, axes) -> bool:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = int(np.prod([sizes[a] for a in (axes if isinstance(axes, tuple)
                                            else (axes,))]))
    return n % total == 0


def batch_specs(batch, mesh):
    """tokens/labels [B,S] + optional enc_embeds [B,S,d]: DP over batch."""
    dp = DP(mesh)

    def one(path, leaf):
        b = leaf.shape[0]
        axes = dp if _div_ok(b, mesh, dp) else (
            "data" if _div_ok(b, mesh, "data") else None)
        if axes is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(axes, *([None] * (len(leaf.shape) - 1))))
    return tree_map_with_path(one, batch)


def cache_specs(cache, mesh):
    """Decode caches: batch -> DP when divisible; sequence axis -> model.

    Layouts: kv k/v [L,B,S,H,D]; MLA c_kv/k_rope [L,B,S,r]; ssm conv
    [L,B,K,C] / ssm [L,B,H,N,P]; cross_k/v [L,B,Se,H,D]; len [B].
    """
    dp = DP(mesh)

    def one(ps, leaf):
        shp = tuple(leaf.shape)
        if ps in ("len", "enc_len"):
            return NamedSharding(
                mesh, P(dp if _div_ok(shp[0], mesh, dp) else None))
        dims: list = [None] * len(shp)
        if len(shp) >= 2:
            # dim 1 is batch
            if _div_ok(shp[1], mesh, dp):
                dims[1] = dp
            elif _div_ok(shp[1], mesh, "data"):
                dims[1] = "data"
        if ps.startswith(("kv/", "cross_")):
            # [L, B, S, ...]: shard sequence over model (split-KV decode);
            # with batch unshardable (long-context B=1), also spread seq
            # over the data axis.
            seq_axes = ("model",) if dims[1] is not None else ("data", "model")
            cand = tuple(a for a in seq_axes if a in mesh.axis_names)
            if _div_ok(shp[2], mesh, cand):
                dims[2] = cand if len(cand) > 1 else cand[0]
        elif ps.startswith("ssm/"):
            # conv [L,B,K,C]: C -> model; ssm [L,B,H,N,P]: H -> model
            if ps.endswith("conv") and _div_ok(shp[3], mesh, "model"):
                dims[3] = "model"
            elif ps.endswith("ssm") and _div_ok(shp[2], mesh, "model"):
                dims[2] = "model"
        return NamedSharding(mesh, P(*dims))
    return tree_map_with_path(one, cache)


def state_specs(state, mesh):
    """Train state {params, opt{master,mu,nu,count}, step}."""
    pspecs = param_specs(state["params"], mesh)
    return {
        "params": pspecs,
        "opt": {
            "master": pspecs, "mu": pspecs, "nu": pspecs,
            "count": NamedSharding(mesh, P()),
        },
        "step": NamedSharding(mesh, P()),
    }


# ------------------------------------------------------------- placement
def shard_slices(shape, sharding: NamedSharding) -> list[tuple[slice, ...]]:
    """Each mesh position's block of a tensor of ``shape`` (positions in
    ``mesh.devices`` flat order): a dim split over axes (a, b) is cut into
    size(a) * size(b) blocks, position (i_a, i_b) taking block
    i_a * size(b) + i_b."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    sizes = mesh.shape
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    dims = []
    for size, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(sizes[a] for a in axes)
        if size % n:
            raise ValueError(f"dim {size} of {tuple(shape)} does not divide "
                             f"over {axes} ({n} shards)")
        dims.append((size // n, axes))
    out = []
    for coord in np.ndindex(*mesh.devices.shape):
        at = dict(zip(mesh.axis_names, coord))
        sl = []
        for block, axes in dims:
            k = 0
            for a in axes:
                k = k * sizes[a] + at[a]
            sl.append(slice(k * block, (k + 1) * block))
        out.append(tuple(sl))
    return out


def shard_blocks(shape, sharding: NamedSharding) -> dict[tuple, list[int]]:
    """Each distinct block (a tuple of (start, stop) a dim) -> the mesh
    positions holding it (replicas share a block), in position order."""
    groups: dict[tuple, list[int]] = {}
    for i, sl in enumerate(shard_slices(shape, sharding)):
        groups.setdefault(tuple((s.start, s.stop) for s in sl), []).append(i)
    return groups


@dataclasses.dataclass(eq=False)
class ShardedTensor:
    """A tensor placed on a mesh: ``shards[i]`` is the block
    ``shard_slices(shape, sharding)[i]`` on the i-th mesh device (flat
    order), each in its own storage."""

    sharding: NamedSharding
    shape: torch.Size
    dtype: torch.dtype
    shards: list

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def unique(self) -> dict[tuple, list[int]]:
        """Block -> the positions that hold it (``shard_blocks``)."""
        return shard_blocks(self.shape, self.sharding)


def _place_leaf(x, sharding: NamedSharding) -> ShardedTensor:
    x = torch.as_tensor(x)
    shards = []
    for sl, dev in zip(shard_slices(x.shape, sharding),
                       sharding.mesh.devices.reshape(-1)):
        block = x[sl]
        shards.append(torch.empty(block.shape, dtype=x.dtype,
                                  device=dev).copy_(block))
    return ShardedTensor(sharding, x.shape, x.dtype, shards)


def place(tree, shardings):
    """The counterpart of ``jax.device_put(tree, shardings)``:
    ``shardings`` is a matching tree of ``NamedSharding``s, or one for
    every leaf.  Each leaf (a tensor or an array, or a ``ShardedTensor``,
    gathered first) becomes a ``ShardedTensor``."""
    def one(x, sh):
        if isinstance(x, ShardedTensor):
            x = _gather_leaf(x, x.device)
        return _place_leaf(x, sh)
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: one(x, shardings), tree)
    return tree_map(one, tree, shardings)


def _gather_leaf(x: ShardedTensor, device) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    slices = shard_slices(x.shape, x.sharding)
    for positions in x.unique().values():
        i = positions[0]
        out[slices[i]] = x.shards[i]
    moved("all-gather", out.numel() * out.element_size())
    return out


def gather(tree, device: str | torch.device | None = None):
    """Every ``ShardedTensor`` leaf assembled whole on ``device`` (default:
    its first mesh device), bit for bit; other leaves as they are."""
    def one(x):
        if not isinstance(x, ShardedTensor):
            return x
        return _gather_leaf(x, x.device if device is None else device)
    return tree_map(one, tree)


def device_bytes(tree, shardings) -> list[int]:
    """Bytes each mesh position holds of ``tree`` (leaves with ``shape``
    and ``dtype``, e.g. meta tensors) placed by ``shardings``, computed
    from the specs (nothing is placed)."""
    total = None

    def one(leaf, sh):
        nonlocal total
        if total is None:
            total = [0] * sh.mesh.size
        elt = torch.empty((), dtype=leaf.dtype).element_size()
        for i, sl in enumerate(shard_slices(tuple(leaf.shape), sh)):
            total[i] += math.prod(s.stop - s.start for s in sl) * elt
    tree_map(one, tree, shardings)
    return total or []


# ---------------------------------------------------------- control plane
@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The shards of the control plane, one device each, in mesh order.

    A device may repeat: repeated devices are logical shards on one
    device, each with its own tape chunk, stages and kernel launches (the
    counterpart of the reference harness's forced host devices).  The
    first device gathers the summaries and runs the budget cut.
    """

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a shard mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def control_plane_mesh(n_shards: int | None = None,
                       device: str | torch.device | None = None
                       ) -> ShardMesh:
    """The 1-D mesh of the sharded control plane.

    On the card (``device`` None or CUDA) every visible card, capped at
    ``n_shards``: a one-card machine runs the sharded path as a 1-shard
    mesh, as the reference degrades to however many devices exist.  On
    another device (the CPU) ``n_shards`` logical shards of it (default
    1).  Raises when the card is asked for and none is visible.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        k = len(cards) if n_shards is None else max(1, min(int(n_shards),
                                                           len(cards)))
        return ShardMesh(tuple(cards[:k]))
    k = 1 if n_shards is None else max(1, int(n_shards))
    return ShardMesh((dev,) * k)

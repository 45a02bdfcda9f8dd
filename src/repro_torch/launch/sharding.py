"""Per-architecture sharding rules (DESIGN.md §3 mesh mapping): the port of
`repro/launch/sharding.py`.

Axes: `data` = ESP sequence parallelism between elastic instances;
`model` = intra-instance tensor parallelism; `pod` = replica axis.

Head-divisibility decides attention sharding (heads-mode vs batch-mode);
MoE experts shard over `model` (+ expert-hidden over `data` for arctic's
128 experts, which cannot replicate across `data`). Recurrent-layer weights
(mamba/xlstm) replicate — their compute parallelism is batch/sequence.

A spec is the port's `P`: a tuple with one entry per tensor dim — an axis
name, a tuple of axis names (the dim split over several mesh axes, in mesh
order) or None — as the reference's `PartitionSpec`; missing trailing
entries are None.  `placements(mesh, spec, ndim)` turns it into DTensor
placements.  The rules take anything with axis names and sizes: a
`torch.distributed.device_mesh.DeviceMesh`, or a `launch.mesh.MeshShape`
(production meshes without their ranks).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

# §Perf experiment C1 (arctic): shard the MoE grouped-capacity dim over `data`
# so expert-TP contraction psums shrink by the data-axis width.
MOE_GROUP_C_OVER_DATA = False


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(None, ("data", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


# ------------------------------------------------------------- mesh access


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a MeshShape."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def axes_of(mesh) -> Dict[str, Optional[str]]:
    names = axis_names(mesh)
    return {
        "pod": "pod" if "pod" in names else None,
        "data": "data" if "data" in names else None,
        "model": "model" if "model" in names else None,
    }


def tp_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def heads_mode(cfg, mesh) -> bool:
    tp = tp_size(mesh)
    return tp == 1 or cfg.n_heads % tp == 0


def kv_div(cfg, mesh) -> bool:
    tp = tp_size(mesh)
    return tp == 1 or cfg.n_kv_heads % tp == 0


def _div(n: int, mesh, axis: Optional[str]) -> bool:
    return axis is not None and n % axis_sizes(mesh)[axis] == 0


def batch_axes(mesh, b: int, extra_model: bool = False):
    """Largest divisible prefix of (pod, data[, model]) for a batch dim."""
    sizes = axis_sizes(mesh)
    axes = []
    rem = b
    for a in (["pod", "data", "model"] if extra_model else ["pod", "data"]):
        if a in sizes and rem % sizes[a] == 0:
            axes.append(a)
            rem //= sizes[a]
    return tuple(axes) if axes else None


# ------------------------------------------------------------- placements


def placements(mesh, spec, ndim: int) -> List[Any]:
    """DTensor placements (one per mesh dim) of ``spec`` on a tensor of
    ``ndim`` dims.  A dim split over several axes becomes ``Shard(d)`` on
    each of them; DTensor splits in mesh-dim order, so with the axes in
    mesh order rank (i, j) of a ("data", "model") mesh holds block
    ``i * n_model + j`` — the reference's ``P(("data", "model"))`` layout."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: List[Any] = [Replicate() for _ in names]
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    assert len(spec) == ndim, (spec, ndim)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), f"axes {axes} out of mesh order {names}"
        for i in idx:
            assert isinstance(out[i], Replicate), (spec, names)
            out[i] = Shard(d)
    return out


def _shape_of(leaf) -> tuple:
    """Shape of a tree leaf: a tensor / array, a ``(shape, kind)`` entry of
    `convert.param_shapes`, or a shape tuple."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and leaf and isinstance(leaf[0], tuple):
        return tuple(leaf[0])
    return tuple(leaf)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# ===================================================== parameter shardings


def param_specs(cfg, mesh, params_shape, train: bool = False) -> Any:
    """Spec tree matching `params_shape` (nested dicts whose leaves have a
    shape: tensors, or `convert.param_shapes` entries).

    train=True replicates the embedding table, as the reference does (its
    reason is the SPMD partitioner's take-grad), and the moments stay
    ZeRO-sharded over `data` anyway."""
    hm = heads_mode(cfg, mesh)
    kd = kv_div(cfg, mesh)
    tp = tp_size(mesh)
    arctic_ep = cfg.n_experts > 0 and _div(cfg.n_experts, mesh, "model")

    def rule(names, leaf) -> P:
        key = names[-1] if names else ""
        shape = _shape_of(leaf)
        nd = len(shape)

        def pad(spec_tail):
            return P(*([None] * (nd - len(spec_tail)) + list(spec_tail)))

        # ---- attention ----
        if key in ("wq",):  # [.., d, H, dh]
            return pad([None, "model", None]) if hm else P()
        if key in ("wk", "wv"):
            return pad([None, "model", None]) if (hm and kd) else P()
        if key in ("bq",):
            return pad(["model", None]) if hm else P()
        if key in ("bk", "bv"):
            return pad(["model", None]) if (hm and kd) else P()
        if key == "wo":  # [.., H, dh, d]
            return pad(["model", None, None]) if hm else P()
        # ---- ffn ----
        if key in ("w_gate", "w_up", "w_down") and "moe" in names:
            f_axis_ok = _div(cfg.d_ff, mesh, "data")
            if arctic_ep:
                if key == "w_down":  # [.., E, f, d]
                    return pad(["model", "data" if f_axis_ok else None, None])
                return pad(["model", None, "data" if f_axis_ok else None])
            # few experts: TP inside each expert
            if key == "w_down":  # [.., E, f, d]
                return pad([None, "model", None])
            return pad([None, None, "model"])  # [.., E, d, f]
        if key in ("w_gate", "w_up"):  # [.., d, f]
            f = shape[-1]
            return pad([None, "model"]) if f % tp == 0 else P()
        if key == "w_down":  # [.., f, d]
            f = shape[-2]
            return pad(["model", None]) if f % tp == 0 else P()
        if key == "router":
            return P()
        # ---- embeddings ----
        if key == "embed":
            if train:
                return P()
            big = int(np.prod(shape)) * 2 > 1_000_000_000
            return P(None, "model") if (big and shape[1] % tp == 0) else P()
        if key == "lm_head":
            return P(None, "model") if shape[1] % tp == 0 else P()
        if key == "pos_embed":
            return P()
        # recurrent cells / norms / everything else: replicated
        return P()

    return _map_with_path(rule, params_shape)


def param_shardings(cfg, mesh, params_shape, train: bool = False) -> Any:
    """Placements tree (one list of DTensor placements per leaf)."""
    specs = param_specs(cfg, mesh, params_shape, train=train)
    return _map_with_path(
        lambda path, leaf: placements(mesh, _get(specs, path),
                                      len(_shape_of(leaf))),
        params_shape)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def distribute(tree, mesh, specs):
    """Distribute a tree of (replicated, identical on every rank) tensors
    as DTensors by a spec tree of the same structure: each rank keeps its
    own block, nothing moves."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, t):
        spec = _get(specs, path)
        return distribute_tensor(t, mesh, placements(mesh, spec, t.ndim),
                                 src_data_rank=None)

    return _map_with_path(one, tree)


# ===================================================== activation constrain


def make_constrain(cfg, mesh, kind: str) -> Callable:
    """constrain(x, tag) for the model builders. kind: train|prefill|decode.
    The reference's `with_sharding_constraint` is a `DTensor.redistribute`
    to the spec's placements; a plain tensor passes through."""
    ax = axes_of(mesh)
    sizes = axis_sizes(mesh)
    pod, data, model = ax["pod"], ax["data"], ax["model"]
    hm = heads_mode(cfg, mesh)
    recurrent = cfg.family in ("hybrid", "ssm")
    arctic_ep = cfg.n_experts > 0 and _div(cfg.n_experts, mesh, "model")

    def bax(b: int, extra_model: bool = False):
        return batch_axes(mesh, b, extra_model)

    names = axis_names(mesh)

    def cspec(x, spec):
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(x, DTensor):
            return x
        pl = placements(mesh, spec, x.ndim)
        # a dim its axes do not divide (a [B, 1, d] decode activation under
        # the prefill rule) stays whole: GSPMD pads such a dim, DTensor
        # would hand some ranks an empty shard.  A size-1 axis splits
        # nothing and stays replicated too (some torch releases refuse to
        # flatten a dim "sharded" over it, e.g. a B 1 batch)
        ways: Dict[int, int] = {}
        for i, p in enumerate(pl):
            if p.is_shard():
                ways[p.dim] = ways.get(p.dim, 1) * sizes[names[i]]
        for i, p in enumerate(pl):
            if p.is_shard() and (x.shape[p.dim] % ways[p.dim]
                                 or sizes[names[i]] == 1):
                pl[i] = Replicate()
        if list(x.placements) == pl:
            return x
        return x.redistribute(x.device_mesh, pl)

    def constrain(x, tag: str):
        shp = x.shape
        if tag == "act":
            if kind == "train":
                return cspec(x, P(bax(shp[0]), None, None))
            if kind == "prefill":
                # recurrent archs keep batch over model (cells are batch-
                # parallel); attention archs keep acts seq-sharded only
                if recurrent:
                    ba = bax(shp[0], extra_model=True)
                    # batch gets pod(+model); seq over data
                    ba = tuple(a for a in (ba or ()) if a != data) or None
                    return cspec(x, P(ba, data, None))
                ba = bax(shp[0])
                ba = tuple(a for a in (ba or ()) if a != data) or None
                return cspec(x, P(ba, data, None))
            # decode acts [B, 1, d]: masters = batch over (pod, data)
            return cspec(x, P(bax(shp[0]), None, None))
        if tag in ("q", "kv", "attn_out") and kind in ("train",):
            if hm:
                hax = model if (tag != "kv" or kv_div(cfg, mesh)) else None
                return cspec(x, P(bax(shp[0]), None, hax, None))
            ba = bax(shp[0], extra_model=True)
            return cspec(x, P(ba, None, None, None))
        if tag in ("q", "kv", "attn_out") and kind == "prefill":
            # the ESP bodies' in_specs do the resharding; only pin the seq
            # axis so the whole sequence is never gathered
            if hm:
                ba = bax(shp[0])
                ba = tuple(a for a in (ba or ()) if a != data) or None
                hax = model if (tag != "kv" or kv_div(cfg, mesh)) else None
                return cspec(x, P(ba, data, hax, None))
            return x
        if tag == "moe_group":  # [E, C, d]
            if arctic_ep:
                c_ax = data if MOE_GROUP_C_OVER_DATA else None
                return cspec(x, P(model, c_ax, None))
            return cspec(x, P(None, bax(shp[1]) or data, None))
        if tag == "moe_hidden":  # [E, C, f]
            if arctic_ep:
                if MOE_GROUP_C_OVER_DATA:
                    return cspec(x, P(model, data, None))
                return cspec(x, P(model, None, "data" if _div(cfg.d_ff, mesh, "data") else None))
            return cspec(x, P(None, bax(shp[1]) or data,
                              model if cfg.d_ff % tp_size(mesh) == 0 else None))
        if tag == "logits":
            v = shp[-1]
            vs = model if v % tp_size(mesh) == 0 else None
            if kind == "train":
                return cspec(x, P(bax(shp[0]), None, vs))
            if x.ndim == 3:
                if recurrent:
                    ba = bax(shp[0], extra_model=True)
                    ba = tuple(a for a in (ba or ()) if a != data) or None
                    return cspec(x, P(ba, data, vs if not (ba and model in ba) else None))
                ba = bax(shp[0])
                ba = tuple(a for a in (ba or ()) if a != data) or None
                return cspec(x, P(ba, data, vs))
            return cspec(x, P(bax(shp[0]), vs))
        if tag == "enc_act":  # whisper encoder [B, 1500, d]
            return cspec(x, P(bax(shp[0]), None, None))
        if tag == "enc_out":
            # encoder output feeds seq-sharded decoder cross-attn: replicate
            # across `data` (37 MB — cheaper than per-layer resharding)
            ba = (pod,) if (pod and shp[0] % sizes[pod] == 0) else None
            return cspec(x, P(ba, None, None))
        return x

    return constrain

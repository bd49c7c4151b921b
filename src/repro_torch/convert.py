"""State carried across from the JAX package.

The mining apps have no weights: their state is the data and the seeded
draws.  GFM's is the packed transaction DB: the JAX package keeps each
site's words as ``(n_tx, W)`` uint32 (``repro.core.apriori.TransactionDB
.packed``); handed over as numpy arrays, they become the port's DBs with
the same bits, so both packages mine exactly the same data.  Clustering's
is the site points ``(S, n, D)`` and the per-site k-means++ centres
``(S, k, D)`` that ``jax.random`` drew, which torch cannot redraw.

The models' state is their parameters, decode caches and AdamW state.
The JAX package
stacks each pattern slot's parameters and cache leaves over the G groups
(``tree["groups"][str(slot)]`` with a leading G axis); the port keeps one
entry per layer in layer order, layer ``len(prefix) + g·P + slot`` for
group g.  The MoE leaves ((G, E, D, F) expert stacks, the router and the
shared experts) and the Mamba-2 leaves split by layer like any other.
zamba2's shared attention block is one set of parameters
(``params["shared_attn"]``) and one K/V cache for each group
(``cache["shared"]``, stacked on G), which the port keeps after the
layers' caches, entry ``n_layers + g``.  An encoder-decoder's encoder
stacks its layers on ``n_enc_layers`` (``params["encoder"]["blocks"]``),
which the port splits into one entry per encoder layer; the decoder
layers' cross-attention leaves and their caches' cross K/V (``ck``,
``cv``) split by layer with the rest.  The way back, ``params_to_reference``,
stacks the port's per-layer entries again, for parameters and for any tree
keyed by their names (gradients, AdamW's moments, which
``opt_state_from_reference`` brings over); ``state_to_reference`` and
``state_from_reference`` carry a whole train state, GridLocal's pods and
outer state too, so a checkpoint holds the same files whichever package
wrote it.  Arrays come and go as numpy; a bfloat16 array (numpy's
``bfloat16`` from ml_dtypes, as ``np.asarray`` of a jax array gives it)
keeps its bits.  A sharded state (DTensors) goes out through
``full_tensor()`` (``sharding.full``: every rank must make the same
calls) and comes back placed by the rules (``train.steps.shard_state``,
``shard_model``, ``shard_cache``, through ``distribute_tensor``).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core.apriori import TransactionDB, n_words
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import full


def transaction_dbs_from_reference(
    packed: Sequence[np.ndarray], n_items: int, device: str | torch.device
) -> list[TransactionDB]:
    """Per-site ``(n_tx, W)`` uint32 word arrays -> the port's
    TransactionDBs on ``device`` (int32 bit views of the same words)."""
    out = []
    for words in packed:
        words = np.array(words, dtype=np.uint32)  # an owned, writable copy
        if words.ndim != 2 or words.shape[1] != n_words(n_items):
            raise ValueError(
                f"want (n_tx, {n_words(n_items)}) words for {n_items} items, got {words.shape}"
            )
        out.append(
            TransactionDB(
                packed=torch.from_numpy(words.view(np.int32)).to(torch.device(device)),
                n_items=int(n_items),
                n_tx=int(words.shape[0]),
            )
        )
    return out


def _float_sites(a, name: str, device: str | torch.device) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)  # an owned, writable copy
    if a.ndim != 3:
        raise ValueError(f"want {name} as an (S, ·, D) array, got shape {a.shape}")
    return torch.from_numpy(a).to(torch.device(device))


def site_points_from_reference(xs: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """The JAX package's ``(S, n, D)`` site points -> the port's f32 tensor on ``device``."""
    return _float_sites(xs, "site points", device)


def init_centers_from_reference(centers: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """Per-site ``(S, k, D)`` initial centres drawn by the JAX package
    (``repro.core.kmeans.kmeans_plus_plus_init`` with each site's key) ->
    the port's f32 tensor on ``device``, for ``init_centers``."""
    return _float_sites(centers, "initial centres", device)


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor with the same dtype and bits on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a).view(np.int16)  # an owned copy of the raw bits
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn, *others):
    """``fn`` over the leaves of nested dicts and lists; with ``others``
    (trees of the same structure) ``fn`` takes the leaf of each."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, *(o[i] for o in others)) for i, v in enumerate(tree)]
    return fn(tree, *others)


def _per_layer(cfg: ModelConfig, tree: dict) -> list:
    """A JAX-layout tree (prefix list, groups stacked by slot, tail list)
    -> one subtree per layer, in layer order."""
    out = []
    for place in T.layer_places(cfg):
        if place[0] == "groups":
            _, g, slot = place
            out.append(_map(tree["groups"][str(slot)], lambda a, g=g: a[g]))
        else:
            out.append(tree[place[0]][place[1]])
    return out


def model_params_from_reference(cfg: ModelConfig, params: dict, device: str | torch.device) -> T.Model:
    """The JAX package's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, T.init_params(cfg, key))``) -> the port's
    model on ``device``, the same values in the same dtypes."""
    dev = torch.device(device)
    conv = lambda a: _tensor(a, dev)  # noqa: E731
    tree = {
        "embed": conv(params["embed"]),
        "final_norm": _map(params["final_norm"], conv),
        "layers": [_map(p, conv) for p in _per_layer(cfg, params)],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = conv(params["lm_head"])
    if cfg.shared_attn_every:
        tree["shared_attn"] = _map(params["shared_attn"], conv)
    if cfg.is_encdec:
        enc = params["encoder"]
        tree["encoder"] = {
            "layers": [_map(enc["blocks"], lambda a, i=i: conv(a[i])) for i in range(cfg.n_enc_layers)],
            "final_norm": _map(enc["final_norm"], conv),
        }
    return T.Model(cfg, tree, device=dev)


def cache_from_reference(cfg: ModelConfig, cache: dict, device: str | torch.device) -> list[dict[str, torch.Tensor]]:
    """The JAX package's decode cache as numpy arrays -> the port's cache
    (one dict per layer, then one for each group's shared block) on
    ``device``."""
    dev = torch.device(device)
    conv = lambda a: _tensor(a, dev)  # noqa: E731
    out = [_map(c, conv) for c in _per_layer(cfg, cache)]
    for g in range(T.n_shared_runs(cfg)):
        out.append(_map(cache["shared"], lambda a, g=g: conv(a[g])))
    return out


def cache_to_reference(cfg: ModelConfig, cache: list[dict[str, torch.Tensor]]) -> dict:
    """The port's cache -> the JAX package's layout as numpy arrays, each
    slot's leaves stacked over the groups.  bfloat16 leaves come back as
    float32 (exactly: every bfloat16 is a float32)."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = full(t.detach())
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def stacked(layers: list[dict]) -> dict:
        return {k: np.stack([layer[k] for layer in layers]) for k in layers[0]}

    out: dict = {}
    slots: dict[str, list] = {}
    places = T.layer_places(cfg)
    if len(cache) != len(places) + T.n_shared_runs(cfg):
        raise ValueError(
            f"want {len(places)} layer caches and {T.n_shared_runs(cfg)} shared ones, got {len(cache)}")
    for place, c in zip(places, cache):
        leaves = {k: host(v) for k, v in c.items()}
        if place[0] == "groups":
            slots.setdefault(str(place[2]), []).append(leaves)
        else:
            out.setdefault(place[0], []).append(leaves)
    if slots:
        out["groups"] = {slot: stacked(layers) for slot, layers in slots.items()}
    if T.n_shared_runs(cfg):
        out["shared"] = stacked([{k: host(v) for k, v in c.items()} for c in cache[len(places):]])
    return out


def reference_path(cfg: ModelConfig, name: str) -> tuple[tuple, int | None]:
    """Where the port's parameter ``name`` (as ``Model.named_parameters``
    names it) sits in the JAX package's parameter tree: (the leaf's path,
    with list indices as ints and dict keys as strings, and the index on
    the leaf's stacked leading axis, or None for an unstacked leaf).
    ``layers.i.*`` is the ``groups[str(slot)]`` leaf at group g (or a
    ``prefix``/``tail`` list entry), ``encoder.i.*`` the ``encoder.blocks``
    leaf at i, ``encoder_norm.*`` ``encoder.final_norm.*``."""
    parts = name.split(".")
    if parts[0] == "layers":
        place, rest = T.layer_places(cfg)[int(parts[1])], tuple(parts[2:])
        if place[0] == "groups":
            return ("groups", str(place[2]), *rest), place[1]
        return (place[0], place[1], *rest), None
    if parts[0] == "encoder":
        return ("encoder", "blocks", *parts[2:]), int(parts[1])
    if parts[0] == "encoder_norm":
        return ("encoder", "final_norm", *parts[1:]), None
    return tuple(parts), None


def reference_order(cfg: ModelConfig, names) -> list[str]:
    """``names`` in the JAX package's leaf order (``jax.tree.leaves``: dict
    keys sorted, list entries in order), the pieces of a stacked leaf
    together in the order of their index."""
    def key(name):
        path, idx = reference_path(cfg, name)
        return path, -1 if idx is None else idx
    return sorted(names, key=key)


def params_to_reference(cfg: ModelConfig, model_or_tree) -> dict:
    """The port's parameters (a ``Model``) or any tree keyed by its
    parameter names (``{name: tensor}``: gradients, AdamW's ``m`` and
    ``v``) -> the JAX package's layout as numpy arrays: each slot's layers
    stacked over the groups into ``groups[str(slot)]``, the encoder's
    layers into ``encoder.blocks``, ``prefix``/``tail`` as lists.  The
    inverse of :func:`model_params_from_reference`; bfloat16 leaves come
    back as float32 (exactly)."""
    items = (dict(model_or_tree.named_parameters()) if isinstance(model_or_tree, torch.nn.Module)
             else dict(model_or_tree))
    stacks: dict[tuple, dict[int, np.ndarray]] = {}
    out: dict = {}
    for name, t in items.items():
        t = full(t.detach())  # a DTensor's whole value (a collective: every rank calls this)
        a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        path, idx = reference_path(cfg, name)
        if idx is None:
            _put(out, path, a)
        else:
            stacks.setdefault(path, {})[idx] = a
    for path, pieces in stacks.items():
        if sorted(pieces) != list(range(len(pieces))):
            raise ValueError(f"{'.'.join(map(str, path))}: stacked pieces {sorted(pieces)} are not 0..n-1")
        _put(out, path, np.stack([pieces[i] for i in range(len(pieces))]))
    return _lists(out)


def _put(tree: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _lists(tree):
    """Dicts keyed by ints (the prefix and tail entries) -> lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        return [_lists(tree[i]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


def opt_state_from_reference(cfg: ModelConfig, opt: dict, device: str | torch.device) -> dict:
    """The JAX package's AdamW state as numpy arrays (``{"step", "m",
    "v"}``, m and v in its parameter layout) -> the port's: ``step`` an
    int32 0-d tensor and m and v keyed by the port's parameter names, in
    the JAX package's leaf order, f32 on ``device``."""
    dev = torch.device(device)
    return {"step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=dev),
            "m": _named_from_reference(cfg, opt["m"], dev), "v": _named_from_reference(cfg, opt["v"], dev)}


def _named_from_reference(cfg: ModelConfig, tree: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A tree in the JAX package's parameter layout -> ``{name: tensor}``
    keyed by the port's parameter names, in the JAX package's leaf order."""
    model = model_params_from_reference(cfg, tree, device)
    flat = {k: p.detach() for k, p in model.named_parameters()}
    return {k: flat[k] for k in reference_order(cfg, flat)}


def state_to_reference(cfg: ModelConfig, state: dict) -> dict:
    """The port's train state -> the JAX package's, as numpy arrays:
    ``{"params", "opt": {"step", "m", "v"}}`` from ``materialize_state``'s
    layout; from ``gridlocal_init``'s (pod lists and ``outer``) every
    params and opt leaf stacked on a leading pod axis, and ``outer``'s
    anchor and momentum in the parameter layout.  The inverse of
    :func:`state_from_reference`."""
    def one(model, opt) -> dict:
        return {"params": params_to_reference(cfg, model),
                "opt": {"step": opt["step"].detach().cpu().numpy(),
                        "m": params_to_reference(cfg, opt["m"]), "v": params_to_reference(cfg, opt["v"])}}

    if "outer" not in state:
        return one(state["params"], state["opt"])
    pods = [one(m, o) for m, o in zip(state["params"], state["opt"])]
    out = _map(pods[0], lambda *xs: np.stack(xs), *pods[1:])
    out["outer"] = {k: params_to_reference(cfg, state["outer"][k]) for k in ("anchor", "momentum")}
    return out


def state_from_reference(cfg: ModelConfig, tree: dict, device: str | torch.device) -> dict:
    """The JAX package's train state as numpy arrays (as
    ``repro.train.steps.materialize_state`` makes it, or with ``outer``
    as ``gridlocal_init`` does, every params and opt leaf stacked on the
    pods) -> the port's on ``device``: ``{"params": Model, "opt"}``, or
    ``{"params": [Model a pod], "opt": [a pod's], "outer": {"anchor",
    "momentum"}}``."""
    dev = torch.device(device)
    if "outer" not in tree:
        return {"params": model_params_from_reference(cfg, tree["params"], dev),
                "opt": opt_state_from_reference(cfg, tree["opt"], dev)}
    n_pods = np.asarray(tree["opt"]["step"]).shape[0]
    pods = [_map({"params": tree["params"], "opt": tree["opt"]}, lambda a, i=i: np.asarray(a)[i])
            for i in range(n_pods)]
    return {"params": [model_params_from_reference(cfg, p["params"], dev) for p in pods],
            "opt": [opt_state_from_reference(cfg, p["opt"], dev) for p in pods],
            "outer": {k: _named_from_reference(cfg, tree["outer"][k], dev) for k in ("anchor", "momentum")}}

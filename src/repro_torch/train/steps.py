"""Step builders: the synchronous train step, the GridLocal train step
(the paper's minimal-sync pattern over pods) and the serve steps (prefill
and decode), with the JAX package's signatures.

The train step (``make_train_step``) differentiates ``forward_train`` then
``train.losses.chunked_softmax_ce`` plus the MoE layers' aux and z losses
with autograd, accumulates microbatch gradients in f32 when asked, and
applies ``optim.adamw.adamw_update`` in place.  Its state is ``{"params":
Model, "opt": AdamW state}``, the moments keyed by the model's parameter
names in the JAX package's leaf order (``convert.reference_order``), the
order the global norm sums them in.  It runs the plain path: the CUDA
flash and sLSTM kernels have no backward (neither have the JAX package's
Pallas kernels), so it refuses a config that sets either flag.

The serve steps (``step(model, batch, cache) -> (logits, cache)``) run
under ``torch.inference_mode()`` and build no autograd graph; scoring is
``forward_train(..., return_hidden=True)`` then ``chunked_softmax_ce``
under the same guard.  The steps serve every arch of the port as they
are: the decode cache of zamba2 holds the shared attention block's K/V for
each group after the layers' caches (``transformer.init_cache``), and that
of seamless the cross K/V of the encoder's output in each decoder layer's.

Every step also runs sharded on DTensors inside ``sharding.activate(mesh,
rules)``: ``shard_state``, ``shard_model``, ``shard_cache`` and
``data.pipeline.place_batch`` place a state, a model, a cache and a batch
that every rank holds whole by the rules (the reference's ``in_shardings``),
and ``replicate_state`` places a state as the training entry's data-parallel
mesh keeps it, whole on every rank; ``grad_accum`` then splits the global
batch, as the reference does, and places each microbatch as the batch was
(``_microbatches``).  GridLocal on a mesh with a ``pod`` axis runs each pod
on its own sub-mesh at once (``shard_gridlocal_state``,
``make_gridlocal_train_step(..., device_mesh=)``) and merges by one
collective over ``pod`` a leaf (``gridlocal_merge_sharded``).
"""

from __future__ import annotations

import copy

import torch

from repro_torch.convert import reference_order, reference_path
from repro_torch.data.pipeline import place_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShapeAxes
from repro_torch.optim import outer as outer_opt
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.outer import OuterConfig, outer_init
from repro_torch.sharding import GRIDLOCAL, Rules, distribute, full, is_dtensor
from repro_torch.train.losses import chunked_softmax_ce

# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def _map_specs(fn, tree):
    if isinstance(tree, ShapeAxes):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def _f32(tree):
    return _map_specs(lambda s: ShapeAxes(shape=s.shape, dtype="float32", axes=s.axes), tree)


def train_state_specs(cfg: ModelConfig, n_pods: int = 0) -> dict:
    """ShapeAxes tree of the train state in the JAX package's layout
    (slots stacked over the groups): the parameters, and AdamW's step and
    f32 moments, as ``repro.train.steps.train_state_specs``.  With n_pods
    > 0 every leaf gains a leading ``grid`` axis of that size (one replica
    a pod), and the GridLocal ``outer`` anchor and momentum, one for all
    pods, are added."""
    p_specs = T.param_specs(cfg)
    state = {
        "params": p_specs,
        "opt": {
            "step": ShapeAxes(shape=(), dtype="int32", axes=()),
            "m": _f32(p_specs),
            "v": _f32(p_specs),
        },
    }
    if n_pods:
        state = _map_specs(
            lambda s: ShapeAxes(shape=(n_pods, *s.shape), dtype=s.dtype, axes=("grid", *s.axes)), state)
        state["outer"] = {"anchor": _f32(p_specs), "momentum": _f32(p_specs)}
    return state


def named_params(cfg: ModelConfig, model: T.Model) -> dict[str, torch.nn.Parameter]:
    """The model's parameters by name, in the JAX package's leaf order."""
    params = dict(model.named_parameters())
    return {k: params[k] for k in reference_order(cfg, params)}


def materialize_state(cfg: ModelConfig, generator: torch.Generator | None = None, device=None) -> dict:
    """``{"params": Model, "opt": adamw_init}`` on ``device`` (the card
    unless the CPU is asked for), the model drawn from ``generator``
    (seeded 0 on that device when None)."""
    model = T.Model(cfg, device=resolve_device(device), generator=generator)
    return {"params": model, "opt": adamw_init(named_params(cfg, model))}


# ---------------------------------------------------------------------------
# Placing a state, a model and a cache on a DeviceMesh
# ---------------------------------------------------------------------------


def param_axes(cfg: ModelConfig, names) -> dict[str, tuple]:
    """The logical axes of the port's parameters ``names``: each one's
    leaf's in ``param_specs``, less the stacked ``layers`` axis."""
    specs = T.param_specs(cfg)
    out = {}
    for name in names:
        path, idx = reference_path(cfg, name)
        leaf = specs
        for k in path:
            leaf = leaf[k]
        out[name] = leaf.axes[1:] if idx is not None else leaf.axes
    return out


def shard_model(cfg: ModelConfig, model: T.Model, device_mesh, rules: Rules) -> T.Model:
    """Replace every parameter of ``model`` (whole on every rank) by a
    DTensor parameter placed on ``device_mesh`` by ``rules``, in place;
    each rank keeps its shard."""
    axes = param_axes(cfg, dict(model.named_parameters()))
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, torch.nn.Parameter(distribute(p, axes[name], rules, device_mesh),
                                              requires_grad=p.requires_grad))
    return model


def shard_state(cfg: ModelConfig, state: dict, device_mesh, rules: Rules) -> dict:
    """A train state (``materialize_state``'s layout, whole on every rank)
    placed on ``device_mesh``: the parameters and AdamW's moments by the
    parameters' axes, in place, the step replicated (a plain tensor)."""
    axes = param_axes(cfg, dict(state["params"].named_parameters()))
    shard_model(cfg, state["params"], device_mesh, rules)
    opt = state["opt"]
    for k in ("m", "v"):
        opt[k] = {n: distribute(t, axes[n], rules, device_mesh) for n, t in opt[k].items()}
    return state


def replicate_state(cfg: ModelConfig, state: dict, device_mesh) -> dict:
    """A train state (whole on every rank) placed on ``device_mesh``
    replicated, in place: every parameter and AdamW moment a DTensor with
    ``Replicate()`` on each mesh dim, the step a plain tensor.  This is
    the placement the JAX entry's jitted step keeps its state in on its
    ``(n, 1)`` mesh (``materialize_state`` places nothing): only the batch
    splits over ``data``, each gradient comes back Partial over it and
    ``_placed_like`` all-reduces it, one collective a leaf, so every rank
    applies the same update to the same bits."""
    return shard_state(cfg, state, device_mesh, Rules(table={}, name="replicated"))  # no axis maps to the mesh


def shard_cache(cfg: ModelConfig, cache: list, device_mesh, rules: Rules) -> list:
    """A decode cache (``init_cache``'s layout, whole on every rank) placed
    on ``device_mesh`` by ``cache_specs``' axes."""
    b, s = cache[0][next(iter(cache[0]))].shape[0], _cache_len(cfg, cache)
    specs = T.cache_leaf_specs(cfg, b, s)
    return [{k: distribute(t, specs[i][k].axes, rules, device_mesh) for k, t in c.items()}
            for i, c in enumerate(cache)]


def _cache_len(cfg: ModelConfig, cache: list) -> int:
    for c in cache:
        if "k" in c:
            return c["k"].shape[1]
    return 1  # a recurrent model's state does not grow with the sequence


# ---------------------------------------------------------------------------
# Synchronous train step
# ---------------------------------------------------------------------------


def _microbatches(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x`` split on its leading axis into ``n`` microbatches: microbatch
    i is rows ``[i·b/n, (i+1)·b/n)`` of the GLOBAL batch, in their order,
    as the reference splits it.  An MoE arch's aux loss and capacity cut
    depend on which tokens share a microbatch, and each microbatch's CE is
    a mean over its own labels, so the order is part of the result.  A
    DTensor (each rank its block of rows, ``place_batch``) is gathered
    whole once, then each microbatch is placed as ``x`` was, each rank
    keeping its block of it with nothing sent: the gather moves the token
    ids, the labels and a stub frontend, kilobytes to a few MB a step."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    whole = x.full_tensor() if isinstance(x, DTensor) else x
    b = whole.shape[0]
    assert b % n == 0, (b, n)
    parts = list(whole.reshape(n, b // n, *whole.shape[1:]))
    if isinstance(x, DTensor):
        return [distribute_tensor(p, x.device_mesh, x.placements, src_data_rank=None) for p in parts]
    return parts


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient on its parameter's placements (a DTensor gradient may
    come back Partial or otherwise placed); a plain one as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    loss_chunk: int = 512,
    grad_accum: int = 1,
):
    """``train_step(state, batch) -> (state, metrics)``: ``batch`` has
    ``tokens`` and ``labels`` (B, S) (labels -1 = ignore) and, for
    seamless and phi-3-vision, ``frontend`` (B, F, D); ``metrics`` has
    ``loss`` (ce + aux + z), ``ce``, ``aux``, ``n_tok``, ``grad_norm`` and
    ``lr``.  The parameters and moments are updated in place.

    grad_accum > 1 splits the batch on its leading axis into microbatches
    run in order, their gradients summed in f32 then scaled by
    1/grad_accum, as are loss, ce and aux; n_tok is summed."""
    for flag in ("flash_kernel", "slstm_kernel"):
        if getattr(cfg, flag):
            raise ValueError(f"{cfg.name}: {flag}=True has no backward (the CUDA kernel, like the JAX "
                             f"package's Pallas kernel, is forward only); train with {flag}=False")

    def loss_fn(model, batch):
        hidden, aux = T.forward_train(cfg, model, batch["tokens"], batch.get("frontend"), return_hidden=True)
        ce, n_tok = chunked_softmax_ce(cfg, model, hidden, batch["labels"], chunk=loss_chunk)
        loss = ce + aux["aux_loss"] + aux["z_loss"]
        return loss, {"ce": ce, "aux": aux["aux_loss"], "n_tok": n_tok}

    def value_and_grad(model, params, batch):
        with torch.enable_grad():
            loss, met = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else _placed_like(g, p)
                 for (k, p), g in zip(params.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in met.items()}), grads

    def grads_of(model, params, batch):
        if grad_accum == 1:
            return value_and_grad(model, params, batch)

        micro = {k: _microbatches(v, grad_accum) for k, v in batch.items()}
        dev = next(iter(params.values())).device
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        met_acc = {"ce": torch.zeros((), dtype=torch.float32, device=dev),
                   "aux": torch.zeros((), dtype=torch.float32, device=dev),
                   "n_tok": torch.zeros((), dtype=torch.int32, device=dev)}
        for i in range(grad_accum):
            (loss, met), g = value_and_grad(model, params, {k: v[i] for k, v in micro.items()})
            for k in acc:
                acc[k].add_(g[k].float())
            del g
            loss_acc = loss_acc + loss
            met_acc = {k: met_acc[k] + met[k] for k in met_acc}
        inv = 1.0 / grad_accum
        grads = {k: a * inv for k, a in acc.items()}
        del acc
        return (loss_acc * inv, {**met_acc, "ce": met_acc["ce"] * inv, "aux": met_acc["aux"] * inv}), grads

    def train_step(state, batch):
        model = state["params"]
        params = named_params(cfg, model)
        (loss, metrics), grads = grads_of(model, params, batch)
        _, new_opt, opt_metrics = adamw_update(opt_cfg, grads, state["opt"], params)
        return {"params": model, "opt": new_opt}, {"loss": loss, **metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# GridLocal train step (the paper's technique: pod-local inner steps, one merge)
# ---------------------------------------------------------------------------


def _reference_leaves(cfg: ModelConfig, names) -> list[list[str]]:
    """``names`` (in the JAX package's leaf order) in runs that form one
    leaf of its layout: a slot's layers stacked over the groups, an
    encoder's layers over its blocks."""
    runs: list[list[str]] = []
    last = None
    for k in names:
        path = reference_path(cfg, k)[0]
        if path != last:
            runs.append([])
            last = path
        runs[-1].append(k)
    return runs


@torch.no_grad()
def gridlocal_merge(cfg: ModelConfig, outer_cfg: OuterConfig, pods: list[dict[str, torch.Tensor]],
                    outer: dict) -> None:
    """The single synchronisation, leaf by leaf and in place: merge the
    pods' leaves (``pods``: each pod's parameters by name), take the outer
    step on the merge into ``outer``'s anchor and momentum, and copy the
    new anchor into every pod.  The merge is the paper's size-weighted
    aggregation, uniform here: the f32 mean of the pods, or with
    ``compress="int8"`` the anchor plus the mean of the pods' int8 deltas,
    summed in int16, quantised with one scale for each leaf of the JAX
    package's layout (the max over all pods and over the layers stacked in
    it).  One parameter's temporaries live at a time."""
    n = len(pods)
    for run in _reference_leaves(cfg, outer["anchor"]):
        scale = None
        if outer_cfg.compress == "int8":
            scale = torch.clamp(torch.stack([(p[k].float() - outer["anchor"][k]).abs().max()
                                             for k in run for p in pods]).max(), min=1e-12)
        for k in run:
            anchor, xs = outer["anchor"][k], [p[k] for p in pods]
            if scale is not None:
                q, _ = outer_opt.quantize_delta(torch.stack([x.float() - anchor for x in xs]), scale)
                q_mean = torch.sum(q, dim=0, dtype=torch.int16).float() / n
                del q
                merged = anchor + outer_opt.dequantize_delta(q_mean, scale)
            else:
                merged = sum(x.float() for x in xs) / n
            new_anchor, outer["momentum"][k] = outer_opt.outer_step(outer_cfg, anchor, outer["momentum"][k], merged)
            outer["anchor"][k] = new_anchor
            del merged
            for x in xs:
                x.copy_(new_anchor)


def pod_submesh(device_mesh):
    """The mesh a pod's inner step runs on: ``device_mesh`` without its
    ``pod`` axis, at this rank's pod."""
    names = tuple(device_mesh.mesh_dim_names)
    if "pod" not in names:
        raise ValueError(f"GridLocal on a mesh needs a pod axis, the mesh has {names}")
    return device_mesh[tuple(n for n in names if n != "pod")]


def _on_mesh(local: torch.Tensor, like, device_mesh, pod) -> torch.Tensor:
    """A rank's local tensor as a DTensor of the whole mesh: placed as
    ``like`` (a DTensor on the pod's sub-mesh) on the other axes, and as
    ``pod`` on the pod axis."""
    from torch.distributed.tensor import DTensor, Shard

    sub = dict(zip(like.device_mesh.mesh_dim_names, like.placements))
    shift = 1 if isinstance(pod, Shard) else 0
    pl = [pod if n == "pod" else (Shard(sub[n].dim + shift) if isinstance(sub[n], Shard) else sub[n])
          for n in device_mesh.mesh_dim_names]
    shape = ((device_mesh.size(0),) if shift else ()) + tuple(like.shape)
    return DTensor.from_local(local, device_mesh, pl, shape=shape, stride=torch.empty(shape, device="meta").stride())


@torch.no_grad()
def gridlocal_merge_sharded(cfg: ModelConfig, outer_cfg: OuterConfig, params: dict[str, torch.Tensor],
                            outer: dict, device_mesh) -> None:
    """``gridlocal_merge`` on a mesh with a ``pod`` axis, in place: each
    rank holds its pod's shards (``params``, on the pod's sub-mesh) and the
    anchor's, so each leaf's merge is one collective over ``pod`` of the
    rank's own shard, and the merged leaf keeps the intra-pod layout (the
    reference's constraints).  f32: an all-reduce of the pods' sum, over
    n_pods.  int8: the scale is the max over every pod and every shard of
    the reference leaf (an all-reduce of one float); the deltas cross the
    pods as int8 (an all-gather: neither gloo nor NCCL reduces int16) and
    are summed in int16 on each rank, as the reference sums them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    n = device_mesh.size(names.index("pod"))

    def pod_replicated(t):
        return [Replicate() if nm == "pod" else p for nm, p in zip(names, t.placements)]

    for run in _reference_leaves(cfg, outer["anchor"]):
        deltas = {k: params[k].to_local().float() - outer["anchor"][k].to_local() for k in run}
        scale = None
        if outer_cfg.compress == "int8":
            peak = torch.stack([d.abs().max() for d in deltas.values()]).max()
            peak = DTensor.from_local(peak, device_mesh, [Partial("max")] * device_mesh.ndim, shape=(), stride=())
            scale = torch.clamp(peak.redistribute(device_mesh, [Replicate()] * device_mesh.ndim).to_local(),
                                min=1e-12)
        for k in run:
            x, anchor = params[k], outer["anchor"][k]
            if scale is not None:
                q, _ = outer_opt.quantize_delta(deltas[k], scale)
                q = _on_mesh(q[None], x, device_mesh, Shard(0))
                q_all = q.redistribute(device_mesh, pod_replicated(q)).to_local()
                q_mean = torch.sum(q_all, dim=0, dtype=torch.int16).float() / n
                merged_local = anchor.to_local() + outer_opt.dequantize_delta(q_mean, scale)
            else:
                total = _on_mesh(x.to_local().float(), x, device_mesh, Partial())
                merged_local = total.redistribute(device_mesh, pod_replicated(total)).to_local() / n
            merged = DTensor.from_local(merged_local, anchor.device_mesh, anchor.placements,
                                        shape=anchor.shape, stride=anchor.stride())
            new_anchor, outer["momentum"][k] = outer_opt.outer_step(outer_cfg, anchor, outer["momentum"][k], merged)
            outer["anchor"][k] = new_anchor
            x.copy_(new_anchor.to(x.dtype))
        del deltas


def make_gridlocal_train_step(
    cfg: ModelConfig,
    n_pods: int,
    opt_cfg: AdamWConfig = AdamWConfig(),
    outer_cfg: OuterConfig = OuterConfig(),
    loss_chunk: int = 512,
    grad_accum: int = 1,
    device_mesh=None,
):
    """``step_fn(state, batch) -> (state, metrics)`` over ``n_pods`` pods
    (the reference reads the count off its mesh's ``pod`` axis).  Pod i
    takes rows ``[i·B/n_pods, (i+1)·B/n_pods)`` of the batch through
    ``make_train_step``'s step; when pod 0's AdamW step, after the update,
    is a multiple of ``h_steps`` the pods merge (``gridlocal_merge``,
    called through this module).  ``metrics`` are the inner step's, each
    the f32 mean over the pods.  Refuses the flags ``make_train_step``
    refuses.

    With ``device_mesh`` (a mesh with a ``pod`` axis of ``n_pods``, inside
    ``sharding.activate(device_mesh, GRIDLOCAL)``) the pods run at once,
    one a rank group: the state is this rank's pod's
    (``shard_gridlocal_state``), on the pod's sub-mesh, the batch the whole
    global one (plain tensors or DTensors), of which the pod takes its rows,
    placed on its sub-mesh by ``GRIDLOCAL``; the merge is
    ``gridlocal_merge_sharded``, called through this module, and the
    metrics' mean over the pods an all-reduce over ``pod``."""
    inner = make_train_step(cfg, opt_cfg, loss_chunk, grad_accum)
    if device_mesh is not None:
        return _gridlocal_step_on_mesh(cfg, n_pods, outer_cfg, inner, device_mesh)

    def step_fn(state, batch):
        b = next(iter(batch.values())).shape[0]
        if b % n_pods:
            raise ValueError(f"a batch of {b} rows does not split over {n_pods} pods")
        rows = b // n_pods
        mets = []
        for i in range(n_pods):
            sub = {k: v[i * rows : (i + 1) * rows] for k, v in batch.items()}
            new, met = inner({"params": state["params"][i], "opt": state["opt"][i]}, sub)
            state["opt"][i] = new["opt"]
            mets.append(met)
        if int(state["opt"][0]["step"]) % outer_cfg.h_steps == 0:
            gridlocal_merge(cfg, outer_cfg, [named_params(cfg, m) for m in state["params"]], state["outer"])
        metrics = {k: sum(m[k].float() for m in mets) / n_pods for k in mets[0]}
        return {"params": state["params"], "opt": state["opt"], "outer": state["outer"]}, metrics

    return step_fn


def _gridlocal_step_on_mesh(cfg, n_pods, outer_cfg, inner, device_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    if device_mesh.size(names.index("pod")) != n_pods:
        raise ValueError(f"n_pods={n_pods} but the mesh's pod axis has {device_mesh.size(names.index('pod'))}")
    sub = pod_submesh(device_mesh)
    pod = device_mesh.get_local_rank("pod")

    def step_fn(state, batch):
        whole = {k: full(v) for k, v in batch.items()}
        b = next(iter(whole.values())).shape[0]
        if b % n_pods:
            raise ValueError(f"a batch of {b} rows does not split over {n_pods} pods")
        rows = b // n_pods
        mine = place_batch({k: v[pod * rows : (pod + 1) * rows] for k, v in whole.items()}, sub, GRIDLOCAL)
        (model,), (opt,) = state["params"], state["opt"]
        new, met = inner({"params": model, "opt": opt}, mine)
        state["opt"][0] = new["opt"]
        if int(state["opt"][0]["step"]) % outer_cfg.h_steps == 0:
            gridlocal_merge_sharded(cfg, outer_cfg, named_params(cfg, model), state["outer"], device_mesh)
        metrics = {}
        for k, v in met.items():
            local = full(v).float()
            pods = DTensor.from_local(local[None], device_mesh, [Shard(0) if nm == "pod" else Replicate()
                                                                  for nm in names], shape=(n_pods,), stride=(1,))
            metrics[k] = pods.full_tensor().sum() / n_pods  # an all-gather of one float a pod
        return {"params": state["params"], "opt": state["opt"], "outer": state["outer"]}, metrics

    return step_fn


def shard_gridlocal_state(cfg: ModelConfig, state: dict, device_mesh) -> dict:
    """A GridLocal state of every pod (``gridlocal_init``'s layout, or
    ``convert.state_from_reference``'s, whole on every rank) -> this rank's
    pod's, on the pod's sub-mesh by ``GRIDLOCAL``: ``{"params": [its
    Model], "opt": [its AdamW state], "outer": the anchor and momentum}``
    (the outer state is replicated over the pods, as the reference places
    it)."""
    sub = pod_submesh(device_mesh)
    pod = device_mesh.get_local_rank("pod")
    model, opt = state["params"][pod], state["opt"][pod]
    shard_state(cfg, {"params": model, "opt": opt}, sub, GRIDLOCAL)
    axes = param_axes(cfg, dict(model.named_parameters()))
    outer = {k: {n: distribute(t, axes[n], GRIDLOCAL, sub) for n, t in state["outer"][k].items()}
             for k in ("anchor", "momentum")}
    return {"params": [model], "opt": [opt], "outer": outer}


def gridlocal_init(cfg: ModelConfig, generator: torch.Generator | None = None, n_pods: int = 2,
                   device=None) -> dict:
    """The GridLocal state on ``device`` (the card unless the CPU is asked
    for): every pod a copy of one draw from ``generator`` (seeded 0 on that
    device when None), with its own AdamW state, and the outer anchor (a
    copy of the draw) and zero momentum."""
    model = T.Model(cfg, device=resolve_device(device), generator=generator)
    pods = [model] + [copy.deepcopy(model) for _ in range(n_pods - 1)]
    return {
        "params": pods,
        "opt": [adamw_init(named_params(cfg, m)) for m in pods],
        "outer": outer_init(named_params(cfg, model)),
    }


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def _serving(model):
    """``torch.inference_mode()``; ``torch.no_grad()`` for a model on
    DTensors: under inference mode a composite op (``matmul``) reaches
    DTensor whole, whose sharding propagation then runs its decomposition
    at the global shapes on its own (uncounted-as-setup) tensors."""
    return torch.no_grad() if is_dtensor(model.embed) else torch.inference_mode()


def make_prefill_step(cfg: ModelConfig, chunk: int = 1024):
    """``prefill_step(model, {"tokens": (B, S), "frontend": (B, F, D)},
    cache)`` -> (logits of the last position (B, 1, V) f32, the cache after
    the prompt).  ``"frontend"``, the stub frontend's precomputed
    embeddings, is optional: seamless's frames, which its encoder reads,
    or phi-3-vision's patches, which go in front of the tokens (the cache
    then counts them).  ``chunk`` is the chunked attention oracle's KV
    chunk."""

    def prefill_step(model, batch, cache):
        with _serving(model):
            return T.prefill(cfg, model, batch["tokens"], cache, batch.get("frontend"), chunk=chunk)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_fn(model, {"token": (B, 1), "pos": int}, cache)`` ->
    (logits (B, 1, V) f32, the cache after the token)."""

    def decode_fn(model, batch, cache):
        with _serving(model):
            return T.decode_step(cfg, model, batch["token"], batch["pos"], cache)

    return decode_fn

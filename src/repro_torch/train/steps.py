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
"""

from __future__ import annotations

import copy

import torch

from repro_torch.convert import reference_order, reference_path
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShapeAxes
from repro_torch.optim import outer as outer_opt
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.outer import OuterConfig, outer_init
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
# Synchronous train step
# ---------------------------------------------------------------------------


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
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in met.items()}), grads

    def grads_of(model, params, batch):
        if grad_accum == 1:
            return value_and_grad(model, params, batch)

        def split(x):
            b = x.shape[0]
            assert b % grad_accum == 0, (b, grad_accum)
            return x.reshape(grad_accum, b // grad_accum, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        dev = next(iter(params.values())).device
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in params.items()}
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


def make_gridlocal_train_step(
    cfg: ModelConfig,
    n_pods: int,
    opt_cfg: AdamWConfig = AdamWConfig(),
    outer_cfg: OuterConfig = OuterConfig(),
    loss_chunk: int = 512,
    grad_accum: int = 1,
):
    """``step_fn(state, batch) -> (state, metrics)`` over ``n_pods`` pods
    (the reference reads the count off its mesh's ``pod`` axis).  Pod i
    takes rows ``[i·B/n_pods, (i+1)·B/n_pods)`` of the batch through
    ``make_train_step``'s step; when pod 0's AdamW step, after the update,
    is a multiple of ``h_steps`` the pods merge (``gridlocal_merge``,
    called through this module).  ``metrics`` are the inner step's, each
    the f32 mean over the pods.  Refuses the flags ``make_train_step``
    refuses."""
    inner = make_train_step(cfg, opt_cfg, loss_chunk, grad_accum)

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


def make_prefill_step(cfg: ModelConfig, chunk: int = 1024):
    """``prefill_step(model, {"tokens": (B, S), "frontend": (B, F, D)},
    cache)`` -> (logits of the last position (B, 1, V) f32, the cache after
    the prompt).  ``"frontend"``, the stub frontend's precomputed
    embeddings, is optional: seamless's frames, which its encoder reads,
    or phi-3-vision's patches, which go in front of the tokens (the cache
    then counts them).  ``chunk`` is the chunked attention oracle's KV
    chunk."""

    def prefill_step(model, batch, cache):
        with torch.inference_mode():
            return T.prefill(cfg, model, batch["tokens"], cache, batch.get("frontend"), chunk=chunk)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_fn(model, {"token": (B, 1), "pos": int}, cache)`` ->
    (logits (B, 1, V) f32, the cache after the token)."""

    def decode_fn(model, batch, cache):
        with torch.inference_mode():
            return T.decode_step(cfg, model, batch["token"], batch["pos"], cache)

    return decode_fn

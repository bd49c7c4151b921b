"""GridLocal (the paper's technique applied to training): a simulation on
one device.

The port of ``repro.core.gridlocal``.  The multi-pod step lives in
``train.steps.make_gridlocal_train_step``; this module is the mesh-free
simulation the tests and examples use: S sites train local replicas
independently and merge every H steps by the paper's size-weighted
sufficient-statistics aggregation, then an outer step.  It also keeps the
communication ledger that sets GridLocal against synchronous data
parallelism, the quantity the paper optimises.

Parameters are ``{name: tensor}`` dicts; ``loss_fn(params, batch)``
returns a scalar tensor, differentiated by autograd, and each site's
AdamW updates its own tensors in place.  After a merge every site gets a
copy of the new parameters of its own (the reference shares one immutable
tree, which in-place updates would tie together).
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.outer import OuterConfig, outer_init, outer_update


@dataclass
class GridLocalReport:
    losses: list  # per outer round, mean across sites
    sync_bytes: int  # bytes exchanged by GridLocal (merges only)
    dp_bytes: int  # bytes synchronous DP would have exchanged (per-step)
    n_merges: int


def param_bytes(params: Mapping[str, torch.Tensor]) -> int:
    return sum(p.numel() * p.element_size() for p in params.values())


def merge_bytes(params: Mapping[str, torch.Tensor], n_sites: int, compress: str = "none", n_scales: int = 0) -> int:
    """Bytes one merge exchanges: every site's parameters, or with
    ``compress="int8"`` every site's int8 deltas and its ``n_scales`` f32
    scales (one a leaf of the JAX package's layout)."""
    if compress == "int8":
        return n_sites * (sum(p.numel() for p in params.values()) + 4 * n_scales)
    return n_sites * param_bytes(params)


def _site_copy(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}


def simulate(
    loss_fn,  # loss_fn(params, batch) -> scalar tensor
    params0: Mapping[str, torch.Tensor],
    batches,  # {name: (n_steps, n_sites, ...) tensor}: per-site, per-step batches
    n_sites: int,
    opt_cfg: AdamWConfig = AdamWConfig(warmup=0, decay_steps=10**9),
    outer_cfg: OuterConfig = OuterConfig(),
) -> tuple[dict, GridLocalReport]:
    """Run GridLocal training; returns (the final merged params, report)."""
    site_params = [_site_copy(params0) for _ in range(n_sites)]
    site_opt = [adamw_init(p) for p in site_params]
    outer = outer_init(params0)
    pbytes = param_bytes(params0)

    n_steps = next(iter(batches.values())).shape[0]
    losses, step_losses, n_merges = [], [], 0
    for step in range(n_steps):
        cur = []
        for s in range(n_sites):
            params = site_params[s]
            with torch.enable_grad():
                loss = loss_fn(params, {k: v[step, s] for k, v in batches.items()})
                grads = torch.autograd.grad(loss, list(params.values()))
            _, site_opt[s], _ = adamw_update(opt_cfg, dict(zip(params, grads)), site_opt[s], params)
            cur.append(float(loss.detach()))
        step_losses.append(sum(cur) / n_sites)

        if (step + 1) % outer_cfg.h_steps == 0:
            # the single synchronization: size-weighted merge (uniform sizes)
            with torch.no_grad():
                merged = {k: sum(p[k].float() for p in site_params) / n_sites for k in params0}
            new_p, outer = outer_update(outer_cfg, outer, merged)
            site_params = [_site_copy(new_p) for _ in range(n_sites)]
            n_merges += 1
            losses.append(step_losses[-1])

    final = {k: p.detach() for k, p in site_params[0].items()}
    report = GridLocalReport(
        losses=losses,
        sync_bytes=n_merges * merge_bytes(params0, n_sites),
        dp_bytes=n_steps * n_sites * pbytes,
        n_merges=n_merges,
    )
    return final, report

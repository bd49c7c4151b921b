"""A closed loop of the program's synchronous train step
(``repro_torch.train.steps.make_train_step``) on the mix's batches.

Set-up builds one state from the seed's weights and AdamW's zero moments,
and drives it through the mix's first ``check_steps`` steps through the
same ``call`` the window uses, on batches 0, 1, ...; the window goes on
from there on the same state.  The reference follows those first steps
from the same weights and batches.  Compared: each step's loss, each
leaf's gradient as the optimizer got it at step 1 (worked out from its
first moment, ``m / (1 − b1)``), and each leaf's change after the last
check step.  The steps' global gradient norms are not compared: on the
card no control or fault separated them from the program's own spread.
"""

from __future__ import annotations

import statistics

import torch

from portbench import lm, roofline, traffic, weights
from portbench.manifest import reference_module

OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0, "warmup": 100,
       "decay_steps": 10_000, "min_lr_frac": 0.1}
# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone (a key's bias under softmax)
STILL = 1e-3


class Entry:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.m = cell.config["model"]
        self.ref = reference_module(cell.config["reference"])
        self.shapes = self.ref.param_shapes(self.m)
        self.stream = traffic.stream(cell.config, cell.mix, seed)
        self.opt = {**OPT, **cell.mix.get("optimizer", {})}
        self.checks = int(cell.mix.get("check_steps", 3))
        b, s = int(cell.mix["batch"]), int(cell.mix["seq_len"])
        self.tokens_per_call = b * s
        self.flops_per_call = roofline.train_step_flops(self.m, b, s)
        self.calls = 0
        self.readings = {"loss": [], "grad1": {}, "change": {}}

    def setup(self) -> None:
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.train.steps import make_train_step, named_params

        cfg = lm.model_config(self.cell.config, self.cell.mix.get("flags"))
        model = lm.load_model(cfg, weights.make(self.shapes, self.seed, self.device), self.device)
        self.state = {"params": model, "opt": adamw_init(named_params(cfg, model))}
        opt = {k: v for k, v in self.opt.items() if k in AdamWConfig._fields}
        self.step = make_train_step(cfg, AdamWConfig(**opt))
        for i in range(self.checks):
            met = self.call()
            self.readings["loss"].append(float(met["loss"]))
            if i == 0:
                self.readings["grad1"] = {n: float(t.norm()) / (1 - self.opt["b1"])
                                          for n, t in self.state["opt"]["m"].items()}
        params = dict(self.state["params"].named_parameters())
        with torch.no_grad():
            for u in weights.units(self.shapes):
                for n, t0 in weights.make_unit(self.shapes, u, self.seed, self.device).items():
                    self.readings["change"][n] = float((params[n].detach().float() - t0).norm())

    def call(self) -> dict:
        batch = lm.on_device(self.stream.batch_at(self.calls), self.device)
        self.calls += 1
        self.state, met = self.step(self.state, batch)
        return met

    def close(self) -> None:
        self.state = self.step = None

    def program(self) -> dict:
        return self.readings

    def reference(self, precision: str) -> dict:
        from portbench.reference import precision as prec

        prec.no_tf32()
        w = weights.make(self.shapes, self.seed, self.device)
        batches = [lm.on_device(self.stream.batch_at(i), self.device) for i in range(self.checks)]
        out = self.ref.train(self.m, w, batches, self.opt, prec.matmul(precision))
        del w
        return out

    @staticmethod
    def numbers(a: dict, b: dict) -> dict[str, float]:
        """``loss``: the widest gap of a step's loss (nats); ``grad1`` and
        ``change``: the widest gap of a leaf's norm, over the larger of
        the reference's norm of that leaf and of the median leaf, leaves
        still in the reference (``STILL``) left out."""
        moving = statistics.median(b["grad1_raw"].values())
        keep = [n for n, g in b["grad1_raw"].items() if g >= STILL * moving]

        def leaf_gap(x: dict, y: dict) -> float:
            if set(x) != set(y):
                return float("inf")
            mid = statistics.median(y[n] for n in keep)
            return lm.worst(abs(x[n] - y[n]) / max(y[n], mid, 1e-30) for n in keep)

        if len(a["loss"]) != len(b["loss"]):
            return {k: float("inf") for k in ("loss", "grad1", "change")}
        return {
            "loss": lm.worst(abs(x - y) for x, y in zip(a["loss"], b["loss"])),
            "grad1": leaf_gap(a["grad1"], b["grad1"]),
            "change": leaf_gap(a["change"], b["change"]),
        }

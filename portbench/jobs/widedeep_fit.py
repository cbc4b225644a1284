"""Whole ``WideDeep.fit`` calls on a host table of Criteo-shaped rows.

Each fit of a run takes its own estimator seed (``seeds.fit_seed``),
which moves the epoch order and the init draws and leaves the work the
same.  The check holds fits against the reference fit from the same seed
(``reference/widedeep.py``) by the numbers of :meth:`Job.numbers`, among
them ``loss_gap``, the relative gap of the first epoch's loss, and
``change_gap``, the worst leaf's gap between the two norms of the change
from the init (``reference.widedeep.change_norm_gaps``).

A whole fit's 1024 Adam steps part from any other float32 fit's within
its first epoch (Adam's first step moves a value by the learning rate
whatever the size of its gradient, so a gradient near zero flips sign on
rounding; ReLU inputs near zero flip too).  So a window's fit is held
only to what a fault would break: its first epoch's loss, and its widest
epoch's (``loss_gap_max``, which a fit that stops learning after some
epochs breaks).  Fits of the first steps alone (``first_steps``), where a
float32 fit and the reference agree to rounding, are held to what a
lower precision breaks (:meth:`Job.units`).
"""

from __future__ import annotations

import numpy as np

from ..reference import widedeep as ref_wd
from .base import FitJob
from .seeds import check_seed, sample
from .unit import Unit


_WD = "flink_ml_tpu_torch.models.recommendation.widedeep"


class Job(FitJob):
    name = "widedeep_fit"
    #: the fit's host steps, spanned in the traced fit (``profiling``)
    host_spans = [(_WD, "_validate_cat_ids"), (_WD, "plan_epoch_layout"),
                  (_WD, "prepare_epoch_tensor"), (_WD, "emb_grad_route"),
                  (_WD, "init_params"), (_WD, "params_to_device"),
                  (_WD, "iterate"), (_WD, "_params_to_host")]

    def __init__(self, config: dict, traffic: dict, device):
        super().__init__(config, traffic, device)
        self.vocab_sizes = [int(config["vocab_per_field"])] * int(
            config["categorical_fields"])

    # -- the timed work ---------------------------------------------------
    def warm_up(self, columns: dict, table, seed: int) -> None:
        """One fit of one epoch over the first ``warmup_steps`` batches:
        every kernel and GEMM of a step at the cell's batch and widths."""
        few = self.first_steps(columns, int(self.traffic["warmup_steps"]))
        self.fit(self.table(few), seed, max_iter=1)

    def estimator(self, seed: int, max_iter: int):
        from flink_ml_tpu_torch.models.recommendation.widedeep import WideDeep

        c = self.config
        est = WideDeep(device=self.device.type)
        est.set_vocab_sizes(self.vocab_sizes)
        est.set("embeddingDim", int(c["embedding_dim"]))
        est.set("hiddenUnits", tuple(int(h) for h in c["hidden_units"]))
        est.set("learningRate", float(c["learning_rate"]))
        est.set("routedEmbeddingGrad", c["routed_embedding_grad"])
        est.set("lazyEmbeddingOptimizer", bool(c["lazy_embedding_optimizer"]))
        est.set_global_batch_size(int(c["global_batch_size"]))
        est.set_max_iter(max_iter)
        est.set_seed(seed)
        return est

    def fit(self, table, seed: int, max_iter=None):
        """One whole fit: ``(output, info)``; the output is the fitted
        parameters and loss log on the host, ``info`` what readers use."""
        est = self.estimator(seed, max_iter or int(self.config["max_iter"]))
        model = est.fit(table)
        out = {"params": model._params, "loss_log": np.asarray(
            model._loss_log, np.float64)}
        info = {"route_build_s": (est.route_info or {}).get("build_s")}
        return out, info

    # -- what readers count -----------------------------------------------
    def deep_in(self) -> int:
        return int(self.config["dense_features"]) + int(
            self.config["categorical_fields"]) * int(
                self.config["embedding_dim"])

    def mlp_weights(self) -> int:
        widths = [self.deep_in()] + [int(h) for h in
                                     self.config["hidden_units"]] + [1]
        return sum(a * b for a, b in zip(widths[:-1], widths[1:]))

    def rows_per_epoch(self) -> int:
        b = int(self.config["global_batch_size"])
        return -(-int(self.config["rows"]) // b) * b

    def flops_per_fit(self) -> float:
        """The MLP's forward and backward products: 6 FLOPs a weight a
        row, over every row of every epoch."""
        return 6.0 * self.mlp_weights() * self.rows_per_epoch() * int(
            self.config["max_iter"])

    def param_shapes(self) -> dict:
        """The fit's parameter tree's shapes, in the estimator's layout."""
        c = self.config
        total = sum(self.vocab_sizes)
        widths = [self.deep_in()] + [int(h) for h in c["hidden_units"]] + [1]
        return {"wide_cat": (total,),
                "wide_dense": (int(c["dense_features"]),),
                "wide_b": (),
                "emb": (total, int(c["embedding_dim"])),
                "mlp": [{"w": (a, b), "b": (b,)}
                        for a, b in zip(widths[:-1], widths[1:])]}

    # -- correctness ------------------------------------------------------
    def reference(self, columns: dict, seed: int, **variant) -> dict:
        c = self.config
        kwargs = dict(
            vocab_sizes=self.vocab_sizes, emb_dim=int(c["embedding_dim"]),
            hidden=c["hidden_units"], lr=float(c["learning_rate"]),
            batch=int(c["global_batch_size"]), epochs=int(c["max_iter"]),
            seed=seed, device=self.device, b1=float(c["adam_b1"]),
            b2=float(c["adam_b2"]), eps=float(c["adam_eps"]))
        kwargs.update(variant)
        return ref_wd.fit(columns["denseFeatures"], columns["catFeatures"],
                          columns["label"], **kwargs)

    @staticmethod
    def as_output(ref: dict) -> dict:
        """A reference fit in the shape of the program's output."""
        return {"leaves": ref["params"], "loss_log": ref["loss_log"]}

    def faults(self) -> dict:
        """The faults a fit can have, planted in the reference put in the
        program's place: a step that leaves the state as it was, the same
        after the first epoch, and half of every batch left out with the
        mean over the rest."""
        steps = self.rows_per_epoch() // int(self.config["global_batch_size"])
        return {"fault_unchanged": {"lr": 0.0},
                "fault_frozen_after_epoch1": {"freeze_after": steps},
                "fault_half_batch": {"keep_half_batch": True}}

    @staticmethod
    def output_leaves(out: dict) -> dict:
        if "leaves" in out:
            return out["leaves"]
        p = out["params"]
        leaves = {k: np.asarray(p[k]) for k in ("wide_cat", "wide_dense",
                                                "wide_b", "emb")}
        for i, layer in enumerate(p["mlp"]):
            leaves[f"mlp.{i}.w"] = np.asarray(layer["w"])
            leaves[f"mlp.{i}.b"] = np.asarray(layer["b"])
        return leaves

    def numbers(self, out: dict, ref: dict) -> dict:
        """Every number the comparison can read, by name."""
        gaps = ref_wd.loss_gaps(out["loss_log"], ref["loss_log"])
        change = ref_wd.change_norm_gaps(self.output_leaves(out), ref)
        worst = max(change, key=change.get)
        return {"loss_gap": float(gaps[0]),
                "loss_gap_max": float(np.max(gaps)),
                "change_gap": float(change[worst]),
                "change_gap_leaf": worst,
                "loss_gaps": [float(x) for x in gaps],
                "change_gaps": change}

    def first_steps(self, columns: dict, steps: int) -> dict:
        """The first ``steps`` batches of rows."""
        rows = steps * int(self.config["global_batch_size"])
        return {k: v[:rows] for k, v in columns.items()}

    def units(self, columns: dict, kept: list, seed: int) -> list:
        """What the check compares: a sample of the window's fits (drawn
        from the run's seed), and fits of one epoch over the first batches
        of rows (``first_steps``: the first steps of a fit, through the
        same call at the same batch and widths), each against the
        reference from the same seed."""
        out = []
        for j in sample(seed, len(kept), int(self.traffic["check_fits"])):
            fseed, got = kept[j]
            out.append(self._unit(f"fit@{j}", got, columns, fseed, None))
        for k, steps in enumerate(self.traffic["first_steps"]):
            few = self.first_steps(columns, int(steps))
            fseed = check_seed(seed, k)
            got, _ = self.fit(self.table(few), fseed, max_iter=1)
            out.append(self._unit(f"first{steps}", got, few, fseed, 1))
        return out

    def _unit(self, prefix, got, columns, fseed, epochs) -> Unit:
        variant = {} if epochs is None else {"epochs": epochs}
        return Unit(prefix, got,
                    lambda **v: self.reference(columns, fseed,
                                               **{**variant, **v}),
                    self.as_output, self.numbers)

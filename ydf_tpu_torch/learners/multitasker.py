"""Multitasker (counterpart of ydf_tpu/learners/multitasker.py:
MultitaskerLearner, MultitaskerModel): one sub-model a label over the
same rows.

    import ydf_tpu_torch as ydf
    model = ydf.MultitaskerLearner(tasks=[
        {"label": "label"},
        {"label": "target", "task": ydf.Task.REGRESSION},
    ]).train(data)                       # GBT sub-models, on the card
    model.predict(rows)                  # {label: predictions}
    model.evaluate(test)                 # {label: Evaluation}
    model.save("dir")                    # loads in either package

The data is read into one Dataset (its dataspec inferred once, with the
shared vocabulary options); every sub-learner trains on it with every
task's label and every task's weights, ranking group and treatment
column left out of its features (unless `features=` names them). The
sub-learner is the GBT, random forest or CART (`base_learner`); each
task's own arguments override the shared ones. The directory holds
multitasker.txt (the labels, one a line) and one model directory a
label, task_<label>/.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.dataset import Dataset


class MultitaskerModel:
    model_type = "MULTITASKER"

    def __init__(self, models: Dict[str, object]):
        self.models = models  # label -> sub-model

    def predict(self, data) -> Dict[str, np.ndarray]:
        return {label: m.predict(data) for label, m in self.models.items()}

    def evaluate(self, data) -> Dict[str, object]:
        return {label: m.evaluate(data) for label, m in self.models.items()}

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "multitasker.txt"), "w") as f:
            f.write("\n".join(self.models.keys()))
        for label, m in self.models.items():
            m.save(os.path.join(path, f"task_{label}"))

    @staticmethod
    def load(path: str, device=None) -> "MultitaskerModel":
        from ydf_tpu_torch.models.io import load_model

        with open(os.path.join(path, "multitasker.txt")) as f:
            labels = [line for line in f.read().splitlines() if line]
        return MultitaskerModel({
            label: load_model(os.path.join(path, f"task_{label}"),
                              device=device)
            for label in labels})


class MultitaskerLearner:
    """tasks: a list of {"label": str, "task": Task, ...learner
    arguments}; the shared arguments apply to every sub-learner."""

    def __init__(self, tasks: List[dict],
                 base_learner: str = "GRADIENT_BOOSTED_TREES",
                 features: Optional[List[str]] = None, **shared_kwargs):
        if not tasks:
            raise ValueError("tasks must be non-empty")
        self.tasks = [dict(t) for t in tasks]
        self.base_learner = base_learner
        self.features = features
        self.shared_kwargs = shared_kwargs

    def train(self, data) -> MultitaskerModel:
        from ydf_tpu_torch.learners.cart import CartLearner
        from ydf_tpu_torch.learners.gbt import GradientBoostedTreesLearner
        from ydf_tpu_torch.learners.random_forest import RandomForestLearner

        cls = {
            "GRADIENT_BOOSTED_TREES": GradientBoostedTreesLearner,
            "RANDOM_FOREST": RandomForestLearner,
            "CART": CartLearner,
        }[self.base_learner]
        ds = Dataset.from_data(
            data,
            max_vocab_count=self.shared_kwargs.get("max_vocab_count", 2000),
            min_vocab_frequency=self.shared_kwargs.get(
                "min_vocab_frequency", 5),
        )
        # Never a feature of any sub-model: every task's label and the
        # special columns of every task and of the shared arguments.
        excluded = {t["label"] for t in self.tasks}
        for src in [self.shared_kwargs] + self.tasks:
            for key in ("weights", "ranking_group", "uplift_treatment"):
                if src.get(key):
                    excluded.add(src[key])
        models = {}
        for spec in self.tasks:
            spec = dict(spec)
            label = spec.pop("label")
            task = spec.pop("task", Task.CLASSIFICATION)
            feats = self.features
            if feats is None:
                feats = [c.name for c in ds.dataspec.columns
                         if c.name not in excluded]
            learner = cls(label=label, task=task, features=feats,
                          **{**self.shared_kwargs, **spec})
            models[label] = learner.train(ds)
        return MultitaskerModel(models)

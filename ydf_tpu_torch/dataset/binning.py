"""Binner: the per-feature rules that encoding reads (counterpart of
ydf_tpu/dataset/binning.py:Binner). Fitting and `transform` wait for the
training slice; serving reads the saved fields only.

Feature order is [numericals..., categoricals..., sets...].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Binner:
    feature_names: List[str]
    num_numerical: int  # features [0, num_numerical) are numerical-like
    num_bins: int
    boundaries: np.ndarray       # f32 [F, num_bins-1], +inf padded
    impute_values: np.ndarray    # f32 [F]
    feature_num_bins: np.ndarray  # i32 [F]
    num_set: int = 0
    vs_names: List[str] = dataclasses.field(default_factory=list)
    vs_dims: List[int] = dataclasses.field(default_factory=list)
    vs_max_len: int = 0

    @property
    def num_vs(self) -> int:
        return len(self.vs_names)

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def num_scalar(self) -> int:
        """Features carried by the scalar encoding (all but sets)."""
        return self.num_features - self.num_set

    @property
    def num_categorical(self) -> int:
        return self.num_features - self.num_numerical - self.num_set

    @staticmethod
    def from_json(d: Dict) -> "Binner":
        return Binner(
            feature_names=list(d["feature_names"]),
            num_numerical=int(d["num_numerical"]),
            num_bins=int(d["num_bins"]),
            boundaries=np.array(d["boundaries"], dtype=np.float32),
            impute_values=np.array(d["impute_values"], dtype=np.float32),
            feature_num_bins=np.array(d["feature_num_bins"], dtype=np.int32),
            num_set=int(d.get("num_set", 0)),
            vs_names=list(d.get("vs_names", [])),
            vs_dims=[int(x) for x in d.get("vs_dims", [])],
            vs_max_len=int(d.get("vs_max_len", 0)),
        )

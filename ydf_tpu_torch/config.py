"""Task types (counterpart of ydf_tpu/config.py:Task)."""

from __future__ import annotations

import enum


class Task(enum.Enum):
    """Modeling task. Reference: ydf/model/abstract_model.proto:Task."""

    CLASSIFICATION = "CLASSIFICATION"
    REGRESSION = "REGRESSION"
    RANKING = "RANKING"
    CATEGORICAL_UPLIFT = "CATEGORICAL_UPLIFT"
    NUMERICAL_UPLIFT = "NUMERICAL_UPLIFT"
    ANOMALY_DETECTION = "ANOMALY_DETECTION"
    SURVIVAL_ANALYSIS = "SURVIVAL_ANALYSIS"

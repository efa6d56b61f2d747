"""Hyperparameter specification of the port's learners and the check of
their values (counterpart of ydf_tpu/hyperparameters.py:
hyperparameter_spec, _check_value, validate_call_kwargs).

The constructor signature is the source of truth: the spec of a learner
class is read from its __init__ parameters across the class hierarchy,
with the bounds and choices of the JAX package's table for the
parameters the port's learners take. `GenericLearner.hyperparameters()`
reads the current values by it and `validate_hyperparameters()` checks
them. The documentation strings, the generated documentation page and
the check at construction time are not ported.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np

#: Constructor arguments that name columns or plumbing: in the spec with
#: kind "config" (the JAX package's set, and the port's device).
CONFIG_PARAMS = {
    "label", "task", "features", "weights", "ranking_group",
    "uplift_treatment", "label_event_observed", "label_entry_age",
    "column_types", "working_dir", "resume_training",
    "resume_training_snapshot_interval_trees", "mesh", "random_seed",
    "base_learner", "search_space", "tuner", "monotonic_constraints",
    "workers", "worker_timeout_s", "device", "tasks",
}


@dataclasses.dataclass(frozen=True)
class HyperParameter:
    """One entry of a learner's hyperparameter specification."""

    name: str
    type: str  # "int" | "float" | "bool" | "str" | "enum" | "object"
    default: Any
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    choices: Optional[Tuple[str, ...]] = None
    kind: str = "hyperparameter"  # or "config"
    allow_auto: bool = False  # an int parameter that also takes "auto"


@dataclasses.dataclass(frozen=True)
class _Limit:
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    choices: Optional[Tuple[str, ...]] = None
    allow_auto: bool = False


#: The JAX package's bounds and choices, for the parameters the port's
#: learners take.
_LIMITS: Dict[str, _Limit] = {
    "max_vocab_count": _Limit(min_value=-1),
    "min_vocab_frequency": _Limit(min_value=1),
    "num_bins": _Limit(min_value=2, max_value=256, allow_auto=True),
    "num_discretized_numerical_bins": _Limit(min_value=2, max_value=65536),
    "num_trees": _Limit(min_value=1),
    "max_depth": _Limit(min_value=-2),
    "min_examples": _Limit(min_value=1),
    "max_frontier": _Limit(min_value=1, allow_auto=True),
    "num_candidate_attributes": _Limit(min_value=-1),
    "num_candidate_attributes_ratio": _Limit(min_value=-1.0, max_value=1.0),
    "shrinkage": _Limit(min_value=0.0, max_value=1.0),
    "subsample": _Limit(min_value=0.0, max_value=1.0),
    "validation_ratio": _Limit(min_value=0.0, max_value=1.0),
    "early_stopping": _Limit(
        choices=("NONE", "LOSS_INCREASE", "MIN_LOSS_FINAL")),
    "early_stopping_num_trees_look_ahead": _Limit(min_value=1),
    "l2_regularization": _Limit(min_value=0.0),
    "loss": _Limit(choices=(
        "DEFAULT", "BINOMIAL_LOG_LIKELIHOOD", "MULTINOMIAL_LOG_LIKELIHOOD",
        "SQUARED_ERROR", "MEAN_AVERAGE_ERROR", "POISSON",
        "BINARY_FOCAL_LOSS", "LAMBDA_MART_NDCG", "XE_NDCG_MART",
        "COX_PROPORTIONAL_HAZARD",
    )),
    "ndcg_truncation": _Limit(min_value=1),
    "ranking_max_group_size": _Limit(min_value=1),
    "sampling_method": _Limit(choices=("RANDOM", "GOSS", "SELGB")),
    "goss_alpha": _Limit(min_value=0.0, max_value=1.0),
    "goss_beta": _Limit(min_value=0.0, max_value=1.0),
    "selective_gradient_boosting_ratio": _Limit(min_value=0.0,
                                                max_value=1.0),
    "dart_dropout": _Limit(min_value=0.0, max_value=1.0),
    "split_axis": _Limit(
        choices=("AXIS_ALIGNED", "SPARSE_OBLIQUE", "MHLD_OBLIQUE")),
    "sparse_oblique_num_projections_exponent": _Limit(min_value=0.0,
                                                      max_value=2.0),
    "sparse_oblique_projection_density_factor": _Limit(min_value=0.0),
    "sparse_oblique_weights": _Limit(
        choices=("BINARY", "CONTINUOUS", "POWER_OF_TWO", "INTEGER")),
    "sparse_oblique_max_num_projections": _Limit(min_value=1),
    "mhld_oblique_max_num_attributes": _Limit(min_value=1),
    "numerical_vector_sequence_num_anchors": _Limit(min_value=1),
    "bootstrap_size_ratio": _Limit(min_value=0.0),
    "honest_ratio_leaf_examples": _Limit(min_value=0.0, max_value=1.0),
    "subsample_count": _Limit(min_value=2),
    "subsample_ratio": _Limit(min_value=-1.0, max_value=1.0),
}


def _type_of(default: Any) -> str:
    if isinstance(default, bool):
        return "bool"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, str):
        return "str"
    return "object"


def _init_params(cls: Type) -> Dict[str, inspect.Parameter]:
    """Named __init__ parameters across the MRO (child wins), without
    self, *args and **kwargs."""
    out: Dict[str, inspect.Parameter] = {}
    for klass in reversed(cls.__mro__):
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        try:
            sig = inspect.signature(init)
        except (TypeError, ValueError):
            continue
        for name, p in sig.parameters.items():
            if name == "self" or p.kind in (inspect.Parameter.VAR_POSITIONAL,
                                            inspect.Parameter.VAR_KEYWORD):
                continue
            out[name] = p
    return out


def hyperparameter_spec(cls: Type) -> Dict[str, HyperParameter]:
    """{name: HyperParameter} of every constructor parameter of a learner
    class."""
    spec: Dict[str, HyperParameter] = {}
    for name, p in _init_params(cls).items():
        default = None if p.default is inspect.Parameter.empty else p.default
        lim = _LIMITS.get(name, _Limit())
        ptype = _type_of(default)
        if lim.choices is not None:
            ptype = "enum"
        if lim.allow_auto:
            ptype = "int"
        spec[name] = HyperParameter(
            name=name, type=ptype, default=default,
            min_value=lim.min_value, max_value=lim.max_value,
            choices=lim.choices,
            kind="config" if name in CONFIG_PARAMS else "hyperparameter",
            allow_auto=lim.allow_auto,
        )
    return spec


def check_value(hp: HyperParameter, value: Any, cls_name: str) -> None:
    """Raises TypeError / ValueError where `value` breaks the spec (the
    JAX package's checks and messages)."""
    if value is None:
        return
    if hp.choices is not None:
        if not isinstance(value, str):
            if hp.name == "loss" and hasattr(value, "grad_hess"):
                return  # a CustomLoss
            raise TypeError(
                f"{cls_name}: hyperparameter {hp.name!r} expects one of "
                f"{list(hp.choices)}, got {type(value).__name__} {value!r}")
        if value not in hp.choices:
            raise ValueError(
                f"{cls_name}: invalid value {value!r} for hyperparameter "
                f"{hp.name!r}; expected one of {list(hp.choices)}")
        return
    if hp.type == "bool":
        if not isinstance(value, bool):
            raise TypeError(
                f"{cls_name}: hyperparameter {hp.name!r} expects a bool, "
                f"got {type(value).__name__}")
        return
    if hp.type in ("int", "float"):
        if hp.allow_auto and value == "auto":
            return
        if isinstance(value, (bool, np.bool_)) or not isinstance(
                value, (int, float, np.integer, np.floating)):
            raise TypeError(
                f"{cls_name}: hyperparameter {hp.name!r} expects "
                f"{'an int' if hp.type == 'int' else 'a number'}, got "
                f"{type(value).__name__}")
        if hp.type == "int" and not isinstance(value, (int, np.integer)):
            raise TypeError(
                f"{cls_name}: hyperparameter {hp.name!r} expects an int, "
                f"got {type(value).__name__}")
        if hp.min_value is not None and value < hp.min_value:
            raise ValueError(
                f"{cls_name}: hyperparameter {hp.name!r}={value!r} is below "
                f"the minimum {hp.min_value}")
        if hp.max_value is not None and value > hp.max_value:
            raise ValueError(
                f"{cls_name}: hyperparameter {hp.name!r}={value!r} is above "
                f"the maximum {hp.max_value}")
        return
    if hp.type == "str" and not isinstance(value, str):
        raise TypeError(
            f"{cls_name}: hyperparameter {hp.name!r} expects a str, got "
            f"{type(value).__name__}")

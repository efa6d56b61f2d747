"""Model loading and saving (counterpart of ydf_tpu/models/io.py:
load_model, save_model, deserialize_model).

The JAX package's model directory — `model.json` (task, label,
dataspec, binner, model-specific fields) and `forest.npz` (node arrays)
— of a gradient boosted trees, random forest (CART's too) or isolation
forest model, read into the port's model on a torch device (the node
arrays, each tree's vector-sequence anchors and the binner's
vector-sequence fields included), and written from it in the same
layout, so that each package loads the other's saves. A multitasker's
directory loads as its MultitaskerModel (learners/multitasker.py), and a
directory in the reference YDF format (header.pb, data_spec.pb, node
shards; written by the reference library, pip ydf or `save_ydf`) loads
through models/ydf_format.py. `deserialize_model` restores the bytes of
`model.serialize()`, a tar of the saved directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataspec import DataSpecification
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.models.gbt_model import GradientBoostedTreesModel
from ydf_tpu_torch.models.generic_model import GenericModel
from ydf_tpu_torch.models.if_model import IsolationForestModel
from ydf_tpu_torch.models.rf_model import RandomForestModel

#: The ported model types, by the JAX package's model_type name.
MODEL_TYPES = {cls.model_type: cls for cls in (GradientBoostedTreesModel,
                                               RandomForestModel,
                                               IsolationForestModel)}


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """None → "cuda". A CUDA device without CUDA raises: nothing carries
    on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def forest_from_jax(arrays: Dict[str, np.ndarray]) -> Forest:
    """The JAX package's forest arrays (`Forest.to_numpy()` or a saved
    forest.npz) → the port's Forest on the CPU: the carry-over of the
    trained parameters."""
    return Forest.from_numpy(arrays)


def binner_from_jax(d: Dict) -> Binner:
    """The JAX package's `Binner.to_json()` dict -> the port's Binner:
    the carry-over of the fitted binning rules."""
    return Binner.from_json(d)


def save_model(model: GenericModel, path: str) -> None:
    """Writes `model` to the directory `path` as the JAX package's
    save_model does: model.json and a compressed forest.npz."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "format_version": 1,
        "framework": "ydf_tpu",
        "model_type": model.model_type,
        "task": model.task.value,
        "label": model.label,
        "classes": model.classes,
        "max_depth": model.max_depth,
        "dataspec": model.dataspec.to_json(),
        "binner": model.binner.to_json(),
        "native_missing": model.native_missing,
        "extra_metadata": model.extra_metadata,
        "specific": model._metadata(),
    }
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(meta, f)
    np.savez_compressed(os.path.join(path, "forest.npz"),
                        **model.forest.to_numpy())


def load_model(path: str, device=None):
    """Loads a model onto `device` (default: the CUDA card): a directory
    saved by `model.save(path)` of either package, a multitasker's
    (multitasker.txt and a model directory a label), or a reference YDF
    model directory (models/ydf_format.py)."""
    dev = resolve_device(device)
    meta_path = os.path.join(path, "model.json")
    if not os.path.isfile(meta_path):
        if os.path.isfile(os.path.join(path, "multitasker.txt")):
            from ydf_tpu_torch.learners.multitasker import MultitaskerModel

            return MultitaskerModel.load(path, device=dev)
        from ydf_tpu_torch.models import ydf_format

        if ydf_format.is_ydf_model_dir(path):
            return ydf_format.load_ydf_model(path, device=dev)
        raise ValueError(
            f"{path} holds no model: neither a model.json (a model saved "
            "by either package), a multitasker.txt, nor a YDF-format "
            "header.pb and data_spec.pb"
        )
    with open(meta_path) as f:
        meta = json.load(f)
    cls = MODEL_TYPES.get(meta["model_type"])
    if cls is None:
        raise ValueError(
            f"unknown model type {meta['model_type']!r}; a model.json of "
            f"either package holds one of {sorted(MODEL_TYPES)}"
        )
    with np.load(os.path.join(path, "forest.npz")) as z:
        forest = forest_from_jax({k: z[k] for k in z.files})
    common = dict(
        task=Task(meta["task"]),
        label=meta["label"],
        classes=meta["classes"],
        dataspec=DataSpecification.from_json(meta["dataspec"]),
        binner=Binner.from_json(meta["binner"]),
        forest=forest.to(dev),
        max_depth=meta["max_depth"],
        extra_metadata=meta.get("extra_metadata") or {},
        native_missing=meta.get("native_missing", False),
    )
    return cls._from_saved(common, meta["specific"])


def deserialize_model(data: bytes, device=None):
    """Restores a model from `model.serialize()` bytes of either package
    (a tar of the saved directory) onto `device` (default: the CUDA
    card)."""
    import io
    import tarfile
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        with tarfile.open(fileobj=io.BytesIO(data)) as tar:
            tar.extractall(tmp, filter="data")
        return load_model(os.path.join(tmp, "model"), device=device)

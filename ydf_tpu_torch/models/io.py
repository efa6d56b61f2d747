"""Model loading and saving (counterpart of ydf_tpu/models/io.py:
load_model, save_model).

The JAX package's model directory — `model.json` (task, label,
dataspec, binner, model-specific fields) and `forest.npz` (node arrays)
— read into the port's model on a torch device (the node arrays, each
tree's vector-sequence anchors and the binner's vector-sequence fields
included), and written from it in the same layout, so that each package
loads the other's saves. The reference-format reader (ydf_format.py)
and the multitasker directory are not ported (ROADMAP Queue 1 item 10).
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


def save_model(model: GradientBoostedTreesModel, path: str) -> None:
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


def load_model(path: str, device=None) -> GradientBoostedTreesModel:
    """Loads a model saved by `model.save(path)` of either package onto
    `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    meta_path = os.path.join(path, "model.json")
    if not os.path.isfile(meta_path):
        raise NotImplementedError(
            f"{path} holds no model.json; only models saved by the JAX "
            "package load (YDF-format and multitasker directories are not "
            "ported, ROADMAP Queue 1 item 10)"
        )
    with open(meta_path) as f:
        meta = json.load(f)
    if meta["model_type"] != GradientBoostedTreesModel.model_type:
        raise NotImplementedError(
            f"model type {meta['model_type']} is not ported yet "
            "(ROADMAP Queue 1 item 9)"
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
    return GradientBoostedTreesModel._from_saved(common, meta["specific"])

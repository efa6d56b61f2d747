"""ydf_tpu_torch — the PyTorch/CUDA port of ydf_tpu.

Serving: load a model saved by the JAX package and score it on an NVIDIA
H100 (sm_90a) through hand-written CUDA kernels. Training: grow a
gradient boosted trees model on the card, binning and histograms through
hand-written CUDA kernels too.

    import ydf_tpu_torch as ydf
    model = ydf.load_model("path/to/model")      # device="cuda" by default
    model = ydf.GradientBoostedTreesLearner(label="y").train(data)
    model.predict(data)                          # numpy, like the JAX package
    model.evaluate(test)                         # metrics on the host
    model.save("path/to/dir")                    # loads in either package

Entry points run on the card unless the caller passes `device="cpu"`;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.dataset.dataspec import (
    Column,
    ColumnType,
    DataSpecification,
    infer_dataspec,
)
from ydf_tpu_torch.learners.gbt import GradientBoostedTreesLearner
from ydf_tpu_torch.models.io import (
    binner_from_jax,
    forest_from_jax,
    load_model,
    save_model,
)

__all__ = [
    "Column",
    "ColumnType",
    "DataSpecification",
    "Dataset",
    "GradientBoostedTreesLearner",
    "Task",
    "binner_from_jax",
    "forest_from_jax",
    "infer_dataspec",
    "load_model",
    "save_model",
]

"""ydf_tpu_torch — the PyTorch/CUDA port of ydf_tpu.

Serving: load a model saved by the JAX package and score it on an NVIDIA
H100 (sm_90a) through hand-written CUDA kernels. Training: grow a
gradient boosted trees model, a random forest, a pruned CART tree or an
isolation forest on the card, binning and histograms through
hand-written CUDA kernels too.

    import ydf_tpu_torch as ydf
    model = ydf.load_model("path/to/model")      # device="cuda" by default
    model = ydf.load_model("path/to/ydf_dir")    # a reference YDF model
    model = ydf.GradientBoostedTreesLearner(label="y").train(data)
    model = ydf.RandomForestLearner(label="y").train(data)
    model = ydf.CartLearner(label="y").train(data)
    model.self_evaluation()      # out-of-bag, or CART's holdout
    model = ydf.IsolationForestLearner().train(data)   # anomaly scores
    model = ydf.RandomForestLearner(label="y", uplift_treatment="t",
                                    task=ydf.Task.CATEGORICAL_UPLIFT
                                    ).train(data)        # uplift
    model = ydf.MultitaskerLearner(tasks=[{"label": "y"}, {"label": "z"}]
                                   ).train(data)     # one model a label
    model.predict(data)                          # numpy, like the JAX package
    model.evaluate(test)                         # metrics on the host
    model.save("path/to/dir")                    # loads in either package
    model.save_ydf("path/to/dir")                # the reference YDF format
    print(model.describe())                      # the model card, as text
    model.predict_leaves(data)                   # leaf ids [n, T]
    model.distance(data)                         # 1 - Breiman proximity
    model = ydf.deserialize_model(model.serialize())
    model = ydf.GradientBoostedTreesLearner(label="y").train(
        "csv:/data/train-*.csv")                 # typed, sharded paths
    model.evaluate("tfrecord:/data/test.tfrecord")
    from ydf_tpu_torch.dataset.cache import create_dataset_cache
    cache = create_dataset_cache("csv:/data/train-*.csv", "/cache",
                                 label="y")     # binned chunk by chunk
    model = ydf.GradientBoostedTreesLearner(label="y").train(cache)
    mesh = ydf.make_mesh()          # every card, rows sharded over them
    model = ydf.GradientBoostedTreesLearner(label="y", mesh=mesh).train(df)
    ydf.init_distributed("host:port", num_processes=2, process_id=0,
                         backend="nccl")      # then a mesh in each process

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
from ydf_tpu_torch.learners.cart import CartLearner
from ydf_tpu_torch.learners.gbt import GradientBoostedTreesLearner
from ydf_tpu_torch.learners.losses import CustomLoss
from ydf_tpu_torch.learners.isolation_forest import IsolationForestLearner
from ydf_tpu_torch.learners.multitasker import (
    MultitaskerLearner,
    MultitaskerModel,
)
from ydf_tpu_torch.learners.random_forest import RandomForestLearner
from ydf_tpu_torch.models.io import (
    binner_from_jax,
    deserialize_model,
    forest_from_jax,
    load_model,
    save_model,
)
from ydf_tpu_torch.models.ydf_format import load_ydf_model
from ydf_tpu_torch.models.if_model import IsolationForestModel
from ydf_tpu_torch.models.rf_model import RandomForestModel
from ydf_tpu_torch.parallel.mesh import init_distributed, make_mesh

__all__ = [
    "CartLearner",
    "Column",
    "ColumnType",
    "CustomLoss",
    "DataSpecification",
    "Dataset",
    "GradientBoostedTreesLearner",
    "IsolationForestLearner",
    "IsolationForestModel",
    "MultitaskerLearner",
    "MultitaskerModel",
    "RandomForestLearner",
    "RandomForestModel",
    "Task",
    "binner_from_jax",
    "deserialize_model",
    "forest_from_jax",
    "infer_dataspec",
    "init_distributed",
    "load_model",
    "load_ydf_model",
    "make_mesh",
    "save_model",
]

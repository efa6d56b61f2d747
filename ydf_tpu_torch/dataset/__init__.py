from ydf_tpu_torch.dataset.dataspec import (
    Column,
    ColumnType,
    DataSpecification,
    infer_dataspec,
)
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.dataset.binning import Binner

__all__ = [
    "Column",
    "ColumnType",
    "DataSpecification",
    "infer_dataspec",
    "Dataset",
    "Binner",
]

"""Data containers: ``DataSet`` and the in-memory ``DataSetIterator``."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, DataSetIterator

__all__ = ["DataSet", "DataSetIterator"]

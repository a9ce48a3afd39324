"""Embedding visualization (the counterpart of ``deeplearning4j_tpu/plot``;
reference: org.deeplearning4j.plot)."""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne

__all__ = ["BarnesHutTsne"]

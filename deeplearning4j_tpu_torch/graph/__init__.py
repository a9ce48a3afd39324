"""Graph vertex embeddings (the counterpart of ``deeplearning4j_tpu/graph``;
reference: deeplearning4j-graph Graph + DeepWalk). Walks on the host,
the reference's own; the embedding trains through the port's Word2Vec."""

from deeplearning4j_tpu_torch.graph.deepwalk import Graph, GraphLoader, DeepWalk

__all__ = ["Graph", "GraphLoader", "DeepWalk"]

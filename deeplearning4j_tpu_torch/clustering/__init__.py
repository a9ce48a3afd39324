"""Clustering and nearest neighbours.

The counterpart of ``deeplearning4j_tpu/clustering`` (reference: the
deeplearning4j-nearestneighbors-parent / nd4j clustering modules:
KMeansClustering, the VPTree / KDTree stack, RandomProjectionLSH and
NearestNeighborsServer). Lloyd's iterations, brute-force k-NN and the
LSH projection run on the caller's device (the card unless
``device="cpu"``); the trees and the buckets live on the host.
"""

from deeplearning4j_tpu_torch.clustering.kmeans import (KMeansClustering,
                                                        ClusterSet,
                                                        NearestNeighbors)
from deeplearning4j_tpu_torch.clustering.trees import VPTree, KDTree
from deeplearning4j_tpu_torch.clustering.lsh import RandomProjectionLSH
from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer

__all__ = ["KMeansClustering", "ClusterSet", "NearestNeighbors",
           "VPTree", "KDTree", "RandomProjectionLSH",
           "NearestNeighborsServer"]

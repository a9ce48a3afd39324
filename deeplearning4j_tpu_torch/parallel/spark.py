"""Spark-facade entry points: SparkDl4jMultiLayer / SparkComputationGraph.

The counterpart of ``deeplearning4j_tpu/parallel/spark.py`` (reference:
the dl4j-spark wrappers, ``new SparkDl4jMultiLayer(sc, conf,
trainingMaster)`` then ``fit(JavaRDD<DataSet>)``). The cluster's role is
the ranks' data group: the ``sc`` slot takes a
``parallel.data_parallel_mesh()`` (or None for the default process
group), and the "RDD" is a DataSetIterator, a list of DataSet or one
DataSet, the same on every rank. ``evaluate*`` score the wrapped
network.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.parallel import trainer as _trainer

__all__ = ["SparkDl4jMultiLayer", "SparkComputationGraph",
           "ParameterAveragingTrainingMasterBuilder",
           "SharedTrainingMasterBuilder"]


class _DeferredMaster:
    """A TrainingMaster configured before the net exists; bind() attaches
    the net and the data group."""

    def __init__(self, cls, kwargs):
        self._cls = cls
        self._kwargs = dict(kwargs)

    def bind(self, net, mesh):
        return self._cls(net, mesh=mesh, **self._kwargs)


class ParameterAveragingTrainingMasterBuilder:
    """Reference: ParameterAveragingTrainingMaster.Builder (batches keep
    the size the iterator yields; the ranks split them)."""

    def __init__(self):
        self._kw = {}

    def averagingFrequency(self, k):
        self._kw["averagingFrequency"] = int(k)
        return self

    def build(self):
        return _DeferredMaster(_trainer.ParameterAveragingTrainingMaster,
                               self._kw)


class SharedTrainingMasterBuilder:
    """Reference: SharedTrainingMaster.Builder (gradient sharing, int8 by
    default); SharedTrainingMaster maps the threshold arguments."""

    def __init__(self):
        self._kw = {}

    def thresholdAlgorithm(self, algo):
        self._kw["thresholdAlgorithm"] = algo
        return self

    def residualPostProcessor(self, rpp):
        self._kw["residualPostProcessor"] = rpp
        return self

    def gradientCompression(self, gc):
        self._kw["gradient_compression"] = gc
        return self

    def targetSparsity(self, s):
        self._kw["targetSparsity"] = float(s)
        return self

    def encodingCapacity(self, c):
        self._kw["encodingCapacity"] = float(c)
        return self

    def compressionBlock(self, b):
        self._kw["compressionBlock"] = int(b)
        return self

    def compressionGroupSize(self, g):
        """The hierarchical 2-hop exchange's node-group size (selects
        gradient_compression="hierarchical")."""
        self._kw["compressionGroupSize"] = int(g)
        return self

    def intraGroupCompression(self, mode):
        self._kw["intraGroupCompression"] = mode
        return self

    def weightUpdate(self, mode):
        """"replicated" or "sharded" (the ZeRO update)."""
        self._kw["weight_update"] = mode
        return self

    def build(self):
        return _DeferredMaster(_trainer.SharedTrainingMaster, self._kw)


class SparkDl4jMultiLayer:
    """Reference: SparkDl4jMultiLayer(sc, conf, trainingMaster).

    `mesh`: a data group or None (the default process group).
    `conf_or_net`: a built configuration (the net is built and
    initialised on the card, or on the ``device`` given) or an
    already-initialised net. `trainingMaster`: a *Builder().build()
    deferred master, a bound ParallelWrapper, or None (dense data
    parallel)."""

    def __init__(self, mesh, conf_or_net, trainingMaster=None, device=None):
        cls = type(self)._net_cls()
        if isinstance(conf_or_net, cls):
            self._net = conf_or_net
            if self._net._params is None:
                self._net.init()
        else:
            self._net = cls(conf_or_net, device=device).init()
        if trainingMaster is None:
            self._master = _trainer.ParallelWrapper(self._net, mesh=mesh)
        elif isinstance(trainingMaster, _DeferredMaster):
            self._master = trainingMaster.bind(self._net, mesh)
        elif isinstance(trainingMaster, _trainer.ParallelWrapper):
            if trainingMaster.net is not self._net:
                raise ValueError(
                    "bound trainingMaster wraps a different network than "
                    "this facade's — fit() would train one net while "
                    "evaluate()/getNetwork() used the other; pass the same "
                    "net to both, or pass a *TrainingMasterBuilder result")
            self._master = trainingMaster
        else:
            raise ValueError(
                f"trainingMaster must be a TrainingMaster builder result, "
                f"a bound ParallelWrapper, or None; got {trainingMaster!r}")

    @classmethod
    def _net_cls(cls):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork

    def fit(self, data, epochs=None):
        """`data`: DataSetIterator, list of DataSet, or one DataSet (the
        RDD analog). Returns the trained network."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        n_ep = 1 if epochs is None else int(epochs)
        if n_ep < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        if isinstance(data, DataSet):
            data = [data]
        if isinstance(data, (list, tuple)):
            for _ in range(n_ep):
                for ds in data:
                    self._master.fit(ds)
        else:
            self._master.fit(data, epochs=n_ep)
        return self._net

    def getNetwork(self):
        return self._net

    def getTrainingMaster(self):
        return self._master

    def evaluate(self, iterator):
        return self._net.evaluate(iterator)

    def evaluateRegression(self, iterator):
        return self._net.evaluateRegression(iterator)

    def evaluateROC(self, iterator, thresholdSteps=0):
        return self._net.evaluateROC(iterator, thresholdSteps=thresholdSteps)


class SparkComputationGraph(SparkDl4jMultiLayer):
    """Reference: SparkComputationGraph, over a single-input/-output
    ComputationGraph."""

    @classmethod
    def _net_cls(cls):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph

"""PyTorch/CUDA port of deeplearning4j_tpu, for one NVIDIA H100.

The JAX package ``deeplearning4j_tpu`` beside this one is the reference
the port is held against; this package never imports it, nor ``jax``.
Module paths mirror the reference so each counterpart is easy to find.

What is ported so far:

* the paged-KV transformer serving path:
  ``nn.transformer.CausalTransformerLM`` -> ``serving.kvcache.PagedKVCache``
  -> ``serving.sequence.PagedSequenceScheduler`` -> ``serving.host.ModelHost``
  -> ``serving.server.InferenceServer``, with the paged decode and prefill
  attention kernels (``csrc/paged_attention.cu``);
* training through attention: the ``nn.conf`` builders, layers and
  vertices the transformer encoder needs -> ``nn.graph.ComputationGraph``
  ``fit``, with the flash forward and the two flash backward kernels
  (``csrc/flash_attention.cu``) behind ``ops.flash_attention``;
* training the headline CNNs: ``zoo.LeNet`` through
  ``nn.multilayer.MultiLayerNetwork`` and ``zoo.ResNet50`` through
  ``ComputationGraph``, over ``ops.conv``, ``ops.pooling`` and
  ``ops.norm`` (the BN -> activation epilogue as autograd Functions),
  ``Nesterovs`` and ``data.DataSet``/``DataSetIterator``. No Pallas
  kernel lies on this path: conv and dense are cuDNN/cuBLAS calls, as
  the reference leaves them to XLA;
* the array layer and SameDiff: ``ndarray`` (``INDArray`` over a tensor
  with the reference's value semantics, ``Nd4j``, ``NDArrayIndex``,
  ``Transforms``, im2col/col2im, the seeded RNG, the executioner, the
  compression codecs) and ``autodiff`` (``SameDiff`` graphs, autodiff by
  autograd, ``TrainingConfig`` training, the reference's file format),
  whose ``multiHeadDotProductAttention`` reaches the flash kernels;
* the recurrent family and the carry-slot sequence scheduler, and the
  data-parallel trainers over ``torch.distributed`` (``parallel``);
* the training runtime around the networks: ``data`` (iterators,
  ``MultiDataSet``, normalizers), ``evaluation``, ``optimize``
  (listeners, early stopping), ``fitSteps`` and ``fitDataSet`` (k-step
  blocks, one host sync a block), ``util.serializer``/``serde`` (model
  files and JSON in the reference's format), ``util.sharded_checkpoint``
  and ``runtime.resilience`` (``ResilientFit``);
* the rest of the layer catalogue: masked sequence classification
  (embeddings, the mask layers, the time-series vertices with masks
  along the graph's edges, the CNN <-> RNN preprocessors), constraints,
  weight noise, per-parameter bias updaters, the variational autoencoder
  and AutoEncoder with layerwise ``pretrain``, and the 1-d, 3-d,
  locally connected, capsule, utility, special-output and SameDiff
  layers (``nn.conf``);
* the 2-d CNN zoo (``zoo``: AlexNet, VGG, UNet, the s2d stem, remat) and
  the data and fine-tuning runtime (``data.records``/``transform``, the
  native prefetch ring, ``nn.transfer``, the line-search solvers, int8
  inference);
* one-shot serving (``parallel.inference.ParallelInference``, the
  micro-batcher, ``:predict``, the fleet router, breakers and chaos);
* the rest of SameDiff (control flow, the op namespaces, the validator)
  and ONNX import (``modelimport.onnx``);
* detection and the rest of the zoo (``nn.objdetect``: the YOLOv2 head
  and ``YoloUtils``; Darknet19, TinyYOLO, YOLO2, SqueezeNet, Xception,
  InceptionResNetV1, FaceNetNN4Small2, NASNet), pretrained weights from
  local files (``zoo.pretrained``), Keras import
  (``modelimport.keras``) and TF frozen-graph import through the port's
  own GraphDef codec (``modelimport.tensorflow``, ``tf_wire``);
* word vectors and nearest neighbours: ``nlp`` (Word2Vec and
  ParagraphVectors in every mode, Glove, FastText, the tokenizers,
  vectorizers, serializer and CnnSentenceDataSetIterator), ``clustering``
  (k-means, LSH, the trees, NearestNeighborsServer), ``graph.DeepWalk``
  and ``plot.BarnesHutTsne``, their random numbers behind ``util.draws``;
* reinforcement learning, hyperparameter search and the profiler:
  ``rl`` (DQN over dense and pixel inputs with frame stacking, A3C,
  async n-step Q, the gym adapter), ``arbiter`` (random, grid and
  genetic search over ``MultiLayerSpace``/``ComputationGraphSpace``),
  ``util.profiler`` (``OpProfiler``, ``trace``/``annotate`` over
  ``torch.profiler``, ``compiled_cost``, ``mfu``), ``util.workspace``
  and the telemetry kill switch, spans and trace exports;
* capture, warm start and tuning: ``runtime.aot`` (a step captured as a
  CUDA graph per signature, with warm-start records on disk:
  ``precompile`` on both networks, SameDiff, ``ParallelWrapper`` and
  ``ParallelInference``; one captured decode step per slot bucket in the
  schedulers' ``warm()``), ``runtime.autotune`` (the knobs' arbiter),
  ``util.hbm_ledger`` and ``analysis.hbm`` (the memory-traffic ledger),
  ``analysis.RetraceSentinel`` and ``entry.entry``;
* distributed linear algebra: ``linalg`` (``DistributedMatrix`` over the
  mesh axes, SUMMA GEMM, Gram/covariance, randomized SVD/PCA, CG least
  squares, the plan gate), behind ``INDArray.distribute``, sharded
  k-means, LSH's projection and DeepWalk's products.

The kernels are CUDA C++ for ``sm_90a``, built and bound in
``ops/_kernels.py``.

Device policy (``device.resolve_device``): entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no explicit
``"cpu"`` they raise. Nothing falls back to the CPU on its own.
"""

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray import DataType, INDArray, Nd4j

__version__ = "0.1.0"

__all__ = ["INDArray", "Nd4j", "DataType", "__version__", "resolve_device"]

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
* the rest of the layer catalogue (all but the 3-d layers): masked
  sequence classification (embeddings, the mask layers, the time-series
  vertices with masks along the graph's edges, the CNN <-> RNN
  preprocessors), constraints, weight noise, per-parameter bias
  updaters, the variational autoencoder and AutoEncoder with layerwise
  ``pretrain``, and the 1-d, locally connected, capsule, utility,
  special-output and SameDiff layers (``nn.conf``).

The kernels are CUDA C++ for ``sm_90a``, built and bound in
``ops/_kernels.py``.

Device policy (``device.resolve_device``): entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no explicit
``"cpu"`` they raise. Nothing falls back to the CPU on its own.
"""

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

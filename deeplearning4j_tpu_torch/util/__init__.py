"""Shared host-side utilities of the port: the HTTP helpers, the
tagged-tree codec (``serde``), model files (``serializer``) and
directory checkpoints (``sharded_checkpoint``)."""

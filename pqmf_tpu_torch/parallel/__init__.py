"""Filterbank training support of the port (``training``): the
differentiable bank, its fine-tuning and the committed fine-tuned banks."""

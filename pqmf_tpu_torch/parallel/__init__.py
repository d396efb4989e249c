"""Filterbank training support of the port; so far the committed
fine-tuned banks' loader (``training``)."""

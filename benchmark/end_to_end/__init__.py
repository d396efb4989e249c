"""End-to-end metrics, one reader a file (``<name>.py``, or the
family's ``<name up to the first dot>.py``): ``read(w)`` of
the window ``w`` (``harness.Window``), taken on the host clock."""

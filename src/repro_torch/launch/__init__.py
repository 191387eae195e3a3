"""Training entry points: the replicated train step (``steps``) and the
single-process training loop (``train``)."""

"""Entry points of the port (counterpart of ``repro.launch``); so far
``serve`` in its range and analytics modes."""

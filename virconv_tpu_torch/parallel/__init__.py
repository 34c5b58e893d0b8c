"""Data parallelism of the port: process-group helpers (``dist``) and the
collectives of one data-parallel training step (``data_parallel``).
Counterpart of ``virconv_tpu/parallel``."""

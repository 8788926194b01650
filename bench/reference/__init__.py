"""Plain float32 PyTorch forward passes, one file per architecture, that
decide ``correct``.  They import nothing of ``repro_torch``: they read the
configuration file and draw the weights from the seed themselves
(``bench/weights.py``)."""

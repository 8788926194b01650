"""The yardstick of the per-layer metrics: the H100's published peaks
(``peaks.py``), the operations and bytes each kernel's inputs need
(one file per kernel) and the model's operations a token (``model_flops.py``)."""

"""Serving of the port: the paged KV cache, ``TorchBackend`` and ``Engine``."""

"""Training of the port: the token stream, AdamW, checkpoints and
gradient compression (``launch.steps`` / ``launch.train`` drive them)."""

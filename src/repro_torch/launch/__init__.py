"""Step functions and the training entry point of the port."""

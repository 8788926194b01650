"""Training-side helpers of the port (int8 quantisation so far)."""

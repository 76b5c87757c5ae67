"""Helpers of the PyTorch port."""

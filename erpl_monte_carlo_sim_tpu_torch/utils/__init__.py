"""Helpers of the PyTorch port: serialization, logging, scene files,
debugging, and the parameter-object plumbing."""

from .serialize import object_to_serializable_dict, to_serializable

__all__ = ["to_serializable", "object_to_serializable_dict"]

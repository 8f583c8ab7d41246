"""PyTorch model zoo of the port: decoder models behind one API."""

from .model import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]

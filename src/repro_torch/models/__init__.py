"""PyTorch model zoo of the port: decoder and encoder-decoder models
behind one API."""

from .model import ModelAPI, build_model, stub_audio_frontend

__all__ = ["ModelAPI", "build_model", "stub_audio_frontend"]

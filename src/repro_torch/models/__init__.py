"""PyTorch model zoo of the port: decoder (dense, vision-language, MoE,
Mamba2 and hybrid) and encoder-decoder models behind one API."""

from .model import (ModelAPI, build_model, stub_audio_frontend,
                    stub_vision_frontend)

__all__ = ["ModelAPI", "build_model", "stub_audio_frontend",
           "stub_vision_frontend"]

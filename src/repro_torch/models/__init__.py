"""Decoder model for serving (reference: ``repro/models``)."""

from repro_torch.models.lm import Model

__all__ = ["Model"]

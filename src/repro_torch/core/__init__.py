"""Adapter math (reference: ``repro/core``)."""
